"""Parity of the port's replication log (fleet/replog.py) with the JAX
package's, on the CPU.

The codec is bit-exact (numpy and torch arrays); append and read, a torn
tail, mid-file corruption, rotation, compaction into a snapshot, the
feedback lane and the `replog.append` / `replog.read` fault sites behave
as tests/test_fleet.py holds the JAX package's to; and logs cross between
the packages: the JAX side (online_jax_side.py replog, one subprocess)
writes a model-state log compacted into a snapshot and a feedback lane,
and reads the ones the port wrote first, so each package reads the
other's segments, `feedback-*.seg` files and `snapshot.json` as the writer
reads them, records and checksums equal.  Then a registry publish hook
feeds a log whose delta records replay into a fresh service bit for bit.
"""
import os

import numpy as np
import pytest
import torch

import online_jax_side as oj
from photon_ml_tpu_torch.fleet import (FeedbackLog, ReplicationLog,
                                       ReplicationLogError, decode_array,
                                       delta_from_record, encode_array,
                                       feedback_from_record, record_for_event)
from photon_ml_tpu_torch.fleet import replog
from photon_ml_tpu_torch.online import OnlineUpdateConfig
from photon_ml_tpu_torch.online import delta as delta_mod
from photon_ml_tpu_torch.utils import faults
from test_torch_online import PKG


def _rollback(k):
    return {"kind": "rollback", "version": f"v{k}", "previous_version": None,
            "degraded": False}


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    root = tmp_path_factory.mktemp("replog_jax")
    oj.write_logs(PKG, root / "port_log")
    out = oj.run_jax_side("replog", root)
    out["root"] = root
    return out


@pytest.mark.parametrize("who", ["jax", "port"])
def test_logs_read_the_same_in_either_package(jax_side, who):
    """The writer's log read by the port equals it read by the JAX
    package: every envelope (seq, time, record), the snapshot, the heads."""
    got = oj.read_logs(PKG, jax_side["root"] / f"{who}_log")
    assert got == jax_side[who]
    assert [e["log_seq"] for e in got["model"]] == [4, 5, 6]
    assert got["snapshot"]["upto_seq"] == 3 and got["head"] == 6
    assert got["feedback_head"] == 3 and got["live"] == (4, 3)


def test_both_packages_write_the_same_records(jax_side):
    """Envelopes differ only in their time stamps: the records, and with
    the stamps aligned the checksummed lines, are the JAX package's."""
    port, jax = jax_side["port"], jax_side["jax"]
    for lane in ("model", "feedback"):
        assert [e["record"] for e in port[lane]] == [e["record"] for e in jax[lane]]
        for p, j in zip(port[lane], jax[lane]):
            assert replog._line_for({**p, "t": 0}) == replog._line_for({**j, "t": 0})
    drop = lambda s: {k: v for k, v in s.items() if k != "created_at"}
    assert drop(port["snapshot"]) == drop(jax["snapshot"])
    assert port["segments"] == jax["segments"]


def _event(kind):
    rng = np.random.default_rng(3)
    delta = oj.seeded_delta(delta_mod, 4, 8)
    delta.trace = {"request_ids": ["r1"], "parent": None, "enqueued_wall_s": 1.5}
    return {"swap": {"kind": "swap", "version": "v2", "previous_version": "v1",
                     "source_dir": "/models/v2"},
            "delta": {"kind": "delta", "version": "inline@1", "delta": delta},
            "delta_rollback": {"kind": "delta_rollback", "version": "v2",
                               "to_delta_seq": 0, "restored": {"perUser": (
                                   np.asarray([3, 5]), rng.normal(size=(2, 4)))}},
            "rollback": {"kind": "rollback", "version": "v1",
                         "previous_version": "v2", "degraded": True},
            "bogus": {"kind": "bogus"}}[kind]


@pytest.mark.parametrize("kind", ["swap", "delta", "delta_rollback", "rollback",
                                  "bogus"])
def test_record_for_event_through_the_log(tmp_path, kind):
    """Each publish-hook event kind becomes its record, survives the log
    byte for byte, and a delta record comes back as the same ModelDelta."""
    event = _event(kind)
    if kind == "bogus":
        with pytest.raises(ReplicationLogError, match="unknown publish event"):
            record_for_event(event)
        return
    log = ReplicationLog(str(tmp_path / "log"))
    rec = record_for_event(event)
    log.append(rec)
    back = log.read(0)[0]["record"]
    assert back == rec and back["kind"] == kind
    if kind == "delta":
        assert back["trace"]["request_ids"] == ["r1"]
        got, want = delta_from_record(back), event["delta"]
        assert (got.seq, got.base_version) == (want.seq, want.base_version)
        for k in ("rows", "values", "prior"):
            assert getattr(got.coordinates["perUser"], k).tobytes() == \
                getattr(want.coordinates["perUser"], k).tobytes()
    if kind == "delta_rollback":
        rows = decode_array(back["restored"]["perUser"]["rows"])
        assert rows.tolist() == [3, 5]


def test_array_codec_bit_exact():
    rng = np.random.default_rng(7)
    for a in (rng.normal(size=(5, 3)), rng.normal(size=7).astype(np.float32),
              np.arange(4, dtype=np.int64)):
        b = decode_array(encode_array(a))
        assert b.dtype == a.dtype and b.shape == a.shape
        assert a.tobytes() == b.tobytes()
        assert encode_array(torch.from_numpy(a)) == encode_array(a)


def test_append_read_roundtrip(tmp_path):
    log = ReplicationLog(str(tmp_path / "log"))
    values = np.random.default_rng(1).normal(size=(3, oj.D_U))
    seq1 = log.append({"kind": "swap", "version": "v1",
                       "previous_version": None, "source_dir": "/m"})
    seq2 = log.append({"kind": "delta", "version": "v1", "base_version": "v1",
                       "delta_seq": 1, "created_at": 0.0, "coordinates": {
                           "perUser": {"rows": encode_array(np.arange(3)),
                                       "values": encode_array(values),
                                       "prior": encode_array(values * 0)}}})
    assert (seq1, seq2) == (1, 2) and log.head_seq() == 2
    records = log.read(0)
    assert [r["log_seq"] for r in records] == [1, 2]
    got = decode_array(records[1]["record"]["coordinates"]["perUser"]["values"])
    assert got.tobytes() == values.tobytes()
    assert log.read(2) == []


def test_torn_tail_ignored_and_recovered(tmp_path):
    log = ReplicationLog(str(tmp_path / "log"))
    for k in range(3):
        log.append(_rollback(k))
    seg = [f for f in os.listdir(log.log_dir) if f.startswith("segment")]
    with open(os.path.join(log.log_dir, seg[0]), "a") as f:
        f.write('{"log_seq": 4, "t": 0, "record"')  # torn mid-append
    assert [r["log_seq"] for r in ReplicationLog(log.log_dir).read(0)] == [1, 2, 3]
    writer = ReplicationLog(log.log_dir)
    assert writer.recover() > 0 and writer.recover() == 0
    assert writer.append(_rollback(3)) == 4


def test_mid_file_corruption_raises(tmp_path):
    log = ReplicationLog(str(tmp_path / "log"))
    for k in range(2):
        log.append(_rollback(k))
    seg = [f for f in os.listdir(log.log_dir) if f.startswith("segment")]
    path = os.path.join(log.log_dir, seg[0])
    lines = open(path).readlines()
    lines[0] = lines[0].replace("v0", "vX")  # checksum now mismatches
    with open(path, "w") as f:
        f.writelines(lines)
    with pytest.raises(ReplicationLogError, match="corrupt"):
        ReplicationLog(log.log_dir).read(0)


def test_segment_rotation_compaction_and_snapshot(tmp_path):
    log = ReplicationLog(str(tmp_path / "log"), segment_records=2)
    for k in range(5):
        log.append(_rollback(k))
    segs = [f for f in os.listdir(log.log_dir) if f.startswith("segment")]
    assert len(segs) == 3
    assert [r["log_seq"] for r in log.read(0)] == [1, 2, 3, 4, 5]
    assert [r["record"]["version"] for r in log.read(3)] == ["v3", "v4"]
    # a full-model rollback with no swap before it has no base to fold to
    with pytest.raises(ReplicationLogError, match="full-model rollback"):
        log.compact(2)
    # a registered consumer clamps compaction to its checkpoint
    log2 = ReplicationLog(str(tmp_path / "log2"), segment_records=2)
    for kind, rec in oj.log_records():
        log2.append(oj.encode_record(PKG, kind, rec))
    log2.register_consumer("refit", lambda: 2)
    snap = log2.compact(5)
    assert snap["upto_seq"] == 2
    log2.unregister_consumer("refit")
    assert log2.compact(5)["upto_seq"] == 5
    assert log2.compact(5)["upto_seq"] == 5              # nothing new to fold
    assert snap["model_dir"] == "/models/v1"
    with pytest.raises(ReplicationLogError, match="compacted away"):
        log2.read(1)
    assert [e["log_seq"] for e in log2.read(5)] == [6]


def test_feedback_lane_roundtrip_and_compaction(tmp_path):
    fb = FeedbackLog(str(tmp_path / "fb"), segment_records=2)
    recs = oj.feedback_records(PKG)
    for rec in recs:
        fb.append(rec)
    assert sorted(os.listdir(fb.log_dir)) == ["feedback-0000000001.seg",
                                              "feedback-0000000003.seg"]
    back = feedback_from_record(fb.read(0)[0]["record"])
    feats, ids, labels = oj.feedback(71, 5)
    assert back["labels"].tobytes() == labels.tobytes()
    assert back["features"]["per_user"].tobytes() == feats["per_user"].tobytes()
    assert back["ids"]["userId"].tolist() == ids["userId"].tolist()
    assert back["event_ids"][0] == "e71-0" and back["trace_id"] == "t71"
    with pytest.raises(ReplicationLogError, match="not a feedback record"):
        feedback_from_record({"kind": "delta"})
    snap = fb.compact(2)
    assert snap["kind"] == "feedback" and snap["upto_seq"] == 2
    assert fb.head_seq() == 3 and fb.live_records() == 1


def test_fault_sites_fire(tmp_path):
    log = ReplicationLog(str(tmp_path / "log"))
    plan = faults.FaultPlan([
        {"site": "replog.append", "action": "fatal", "hits": [1]},
        {"site": "replog.read", "action": "transient", "hits": [1]},
    ])
    with faults.injected(plan):
        with pytest.raises(faults.FatalFault):
            log.append(_rollback(0))
        with pytest.raises(faults.TransientFault):
            log.read(0)
    assert plan.report()["total_fired"] == 2
    assert log.head_seq() == 0   # the fatal append wrote nothing


def test_publish_hook_log_replays_bit_for_bit(tmp_path):
    """Every delta a live updater publishes, logged through the registry's
    publish hook, replays (delta_from_record -> apply_delta) into a fresh
    service to the live table hashes; the admitted feedback batches land
    in the service's feedback lane."""
    log = ReplicationLog(str(tmp_path / "log"))
    svc = oj._service(PKG, micro_batch=4)
    fresh = oj._service(PKG)
    try:
        svc.registry.add_publish_hook(
            lambda ticket, event: log.append(record_for_event(event)))
        for seed in (1, 2):
            svc.feedback(*oj.feedback(seed, 10))
        svc.updater.flush()
        for env in log.read(0):
            fresh.registry.apply_delta(delta_from_record(env["record"]))
        assert fresh.audit() == svc.audit()
        assert len(log.read(0)) == svc.version_vector()["delta_seq"] >= 2
    finally:
        svc.close()
        fresh.close()
    lane = tmp_path / "lane"
    svc = PKG["ScoringService"](
        model=oj.build_model(PKG, oj.model_arrays()),
        config=PKG["serving_config"](), updates=OnlineUpdateConfig(),
        start_updater=False, feedback_log_dir=str(lane))
    try:
        for seed in (1, 2, 3):
            svc.feedback(*oj.feedback(seed, 4))
        assert [e["record"]["rows"] for e in svc.feedback_log.read(0)] == [4] * 3
        assert svc.metrics_snapshot()["fleet"]["log_records"] == 3
    finally:
        svc.close()
