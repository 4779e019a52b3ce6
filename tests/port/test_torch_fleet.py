"""Parity of the port's fleet (fleet/replica.py, fleet/front.py, cli.serve's
fleet modes) with the JAX package's, on the CPU in float64.

The JAX side (fleet_jax_side.py fleet, one subprocess per module) writes a
replication log through its FleetPublisher (deltas, a swap, a compaction
snapshot, a delta-aware rollback), joins a JAX replica to it, joins one to
the port's log written here first, and resumes one from the port
replica's state directory.  The port's replica joins the JAX log (from the
snapshot) to the JAX replica's audit and applied.json, the JAX replica
converges on the port's log, and each package resumes the other's
applied.json.  The front's round robin, replication through the
publisher, hedging, drain, failover, backpressure and the sharded fan-out
run against in-process port replicas on ephemeral ports, as
tests/test_fleet.py runs the front against the JAX package's; two
cli.serve children, a follower replica and a front, run the CLI's fleet
modes end to end.  The replica's lifecycle also runs with the lock tracker
armed, held to the port's static lock-order graph (the port's linter,
`test_torch_lint.port_lock_edges`).
"""
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import fleet_jax_side as fj
import online_jax_side as oj
from test_torch_lint import port_lock_edges
from test_torch_online import PKG as ONLINE_PKG
from photon_ml_tpu_torch.cli import serve as serve_cli
from photon_ml_tpu_torch.fleet import (FleetPublisher, Front, FrontConfig,
                                       NoReadyReplica, Replica,
                                       ReplicaConfig, ReplicationLog,
                                       ShardSpec, decode_array)
from photon_ml_tpu_torch.models.io import save_game_model
from photon_ml_tpu_torch.online import OnlineUpdateConfig
from photon_ml_tpu_torch.serving import (CompiledScorer, Overloaded,
                                         ScoringService, ServingConfig)
from photon_ml_tpu_torch.utils import locktrace

F64 = torch.float64
PKG = {**ONLINE_PKG, "FleetPublisher": FleetPublisher, "Replica": Replica}
REPO = fj.ROOT


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The two model directories, the port's log and a port replica's
    state on it (which the JAX side reads), then the JAX side."""
    root = tmp_path_factory.mktemp("fleet")
    save_game_model(oj.build_model(PKG, oj.model_arrays()), str(root / "model"))
    save_game_model(oj.build_model(PKG, oj.model_arrays(seed=4)),
                    str(root / "model_b"))
    port = {"publisher": fj.publish_log(PKG, root, root / "port_log"),
            "replica": fj.join_replica(PKG, root, root / "port_log",
                                       root / "port_state")}
    return {"root": root, "port": port, "jax": fj.run_jax_side("fleet", root)}


def identity(audit):
    """What convergence compares: the version vector and the table bytes."""
    return audit["version_vector"], audit["table_hashes"]


def applied_state(applied):
    """applied.json without its fold snapshot's creation time."""
    snap = {k: v for k, v in applied["snapshot"].items() if k != "created_at"}
    return {**applied, "snapshot": snap}


def test_port_replica_converges_on_a_jax_log(root, tmp_path):
    r, jax = root["root"], root["jax"]
    got = fj.join_replica(PKG, r, r / "jax_log", tmp_path / "state")
    assert got["join"]["bootstrapped"] and not got["join"]["resumed"]
    assert identity(got["audit"]) == identity(jax["replica"]["audit"]) \
        == identity(jax["publisher"]["audit"])
    assert got["audit"]["applied_seq"] == jax["publisher"]["head"]
    assert applied_state(got["applied"]) == applied_state(jax["replica"]["applied"])


def test_jax_replica_converges_on_a_port_log(root):
    port, jax = root["port"], root["jax"]
    assert identity(jax["on_port_log"]["audit"]) == identity(port["replica"]["audit"]) \
        == identity(port["publisher"]["audit"])
    assert applied_state(jax["on_port_log"]["applied"]) == \
        applied_state(port["replica"]["applied"])
    # the two packages' logs carry the same history (the deltas' values
    # are solved by each package, within 1e-8 of each other)
    assert port["publisher"]["audit"]["version_vector"] == \
        jax["publisher"]["audit"]["version_vector"]


@pytest.mark.parametrize("who", ["port_resumes_jax", "jax_resumes_port"])
def test_replica_resumes_the_other_packages_applied_state(root, tmp_path, who):
    r = root["root"]
    if who == "jax_resumes_port":
        got = root["jax"]["resumed_port_state"]
        want = root["port"]["replica"]
    else:
        shutil.copytree(r / "jax_state", tmp_path / "state")
        got = fj.join_replica(PKG, r, r / "jax_log", tmp_path / "state")
        want = root["jax"]["replica"]
    assert got["join"]["resumed"] and got["join"]["records_replayed"] == 0
    assert identity(got["audit"]) == identity(want["audit"])


# -- the replica's lifecycle on the port alone --------------------------------

def _pair(root, tmp_path):
    """A publisher (online updates) over root/model and a joined follower."""
    r = root["root"]
    svc = ScoringService(model_dir=str(r / "model"), start_updater=False,
                         config=ServingConfig(max_batch=64, min_bucket=4,
                                              device="cpu", dtype=F64),
                         updates=OnlineUpdateConfig(**fj.UPDATES))
    log = ReplicationLog(str(tmp_path / "log"))
    FleetPublisher(svc, log, model_dir=str(r / "model"))
    rep = Replica(ScoringService(model_dir=str(r / "model"), start_updater=False,
                                 config=ServingConfig(max_batch=64, min_bucket=4,
                                                      device="cpu", dtype=F64)),
                  log, str(tmp_path / "state"))
    rep.join()
    return svc, log, rep


def test_replica_replays_swaps_and_both_rollbacks(root, tmp_path):
    svc, log, rep = _pair(root, tmp_path)
    try:
        fj._fleet_feedback(svc, 900)
        svc.swap(str(root["root"] / "model_b"), version="v2")
        fj._fleet_feedback(svc, 901)
        rep.poll_once()
        assert identity(rep.audit()) == identity(svc.audit())
        assert rep.service.model_version == "v2"
        svc.rollback()                      # delta-aware: v2's deltas
        svc.rollback()                      # full model: back to the first
        rep.poll_once()
        assert identity(rep.audit()) == identity(svc.audit())
        assert rep.service.model_version == svc.model_version != "v2"
    finally:
        svc.close()
        rep.service.close()


def test_replica_restart_from_a_stale_state_converges(root, tmp_path):
    """A crash between an apply and its ack leaves an older (seq, fold)
    pair: the restart replays the tail again, idempotently."""
    svc, log, rep = _pair(root, tmp_path)
    services = [rep.service]
    try:
        fj._fleet_feedback(svc, 910)
        rep.poll_once()
        early = (tmp_path / "state" / "applied.json").read_text()
        early_seq = rep.status()["applied_seq"]
        fj._fleet_feedback(svc, 911)
        rep.poll_once()
        rep.service.close()
        (tmp_path / "state" / "applied.json").write_text(early)
        for _ in range(2):                  # the stale restart, then a clean one
            again = Replica(ScoringService(
                model_dir=str(root["root"] / "model"), start_updater=False,
                config=ServingConfig(device="cpu", dtype=F64)), log,
                str(tmp_path / "state"))
            services.append(again.service)
            info = again.join()
            assert info["resumed"] and again.status()["applied_seq"] == log.head_seq()
            assert log.head_seq() > early_seq
            assert identity(again.audit()) == identity(svc.audit())
    finally:
        svc.close()
        for s in services:
            s.close()


@pytest.mark.parametrize("action", ["transient", "fatal"])
def test_replica_apply_faults(root, tmp_path, action):
    """Transient apply and read faults retry to the same tables; a fatal
    apply marks the replica failed, its /healthz 503, out of a front's
    rotation, and it applies nothing more."""
    from photon_ml_tpu_torch.utils import faults
    svc, log, rep = _pair(root, tmp_path)
    try:
        fj._fleet_feedback(svc, 920)
        if action == "transient":
            plan = faults.FaultPlan([
                {"site": "replica.apply", "action": "transient", "hits": [1, 2]},
                {"site": "replog.read", "action": "transient", "hits": [1]}])
            with faults.injected(plan):
                assert rep.poll_once() > 0
            assert plan.report()["total_fired"] == 3 and rep.healthy()
            assert identity(rep.audit()) == identity(svc.audit())
            assert rep.service.metrics_snapshot()["fleet"]["apply_retries"] >= 3
            return
        plan = faults.FaultPlan([{"site": "replica.apply", "action": "fatal",
                                  "probability": 1.0}])
        with faults.injected(plan):
            assert rep.poll_once() == 0
        assert not rep.healthy() and rep.status()["failed"] is not None
        node = Served(rep.service, replica=rep)
        front = _front([node], unhealthy_after=1)
        try:
            assert call(node.url, "/healthz")[0] == 503
            assert front.status()["ready_replicas"] == 0
            with pytest.raises(NoReadyReplica):
                front.route("/score", _request(11)[2])
        finally:
            front.close()
            node.httpd.shutdown()
            node.httpd.server_close()
        fj._fleet_feedback(svc, 921)
        assert rep.poll_once() == 0
    finally:
        svc.close()
        rep.service.close()


def test_front_metric_surface_contract():
    """Every front instrument has a FRONT_SNAPSHOT_PATHS entry, every path
    resolves in front_snapshot(), and every instrument renders in the
    Prometheus exposition, the labeled family per (replica, outcome)."""
    import re
    from photon_ml_tpu_torch.fleet import FRONT_SNAPSHOT_PATHS

    def paths(d, prefix=()):
        out = set()
        for k, v in d.items():
            out.add(prefix + (k,))
            if isinstance(v, dict):
                out |= paths(v, prefix + (k,))
        return out

    front = Front(["http://127.0.0.1:1"], start_probes=False)
    try:
        front._m_by_replica.inc(replica="http://127.0.0.1:1", outcome="ok")
        assert set(front.registry.names()) == set(FRONT_SNAPSHOT_PATHS)
        snap = paths(front.front_snapshot())
        assert all(path in snap for path in FRONT_SNAPSHOT_PATHS.values())
        reg, prom = front.registry.snapshot(), front.prometheus_metrics()
        series = set(re.findall(r"^photon_[a-zA-Z0-9_]+", prom, flags=re.M))
        clean = lambda n: "photon_" + re.sub(r"[^a-zA-Z0-9_]", "_", n)
        assert all(clean(n) + "_total" in series for n in reg["counters"])
        assert all(clean(n) in series for n in reg["gauges"])
        assert all(clean(n) + "_total" in series for n in reg["labeled"])
        assert ('photon_front_requests_total{outcome="ok",'
                'replica="http://127.0.0.1:1"} 1') in prom
    finally:
        front.close()


def test_front_passes_the_publishers_retry_after_through(root, tmp_path):
    """/feedback through the front reaches the publisher; its 429's
    Retry-After rides back."""
    svc = ScoringService(model_dir=str(root["root"] / "model"), start_updater=False,
                         config=ServingConfig(device="cpu", dtype=F64),
                         updates=OnlineUpdateConfig(max_pending_rows=8))
    node = Served(svc)
    front = _front([node])
    try:
        feats, ids, body = _request(12, n=6)
        status, payload, headers = front.route_publisher(
            "POST", "/feedback", dict(body, labels=[1.0] * 6))
        assert status == 202 and payload["accepted"] == 6
        feats, ids, body = _request(13, n=6)
        status, payload, headers = front.route_publisher(
            "POST", "/feedback", dict(body, labels=[1.0] * 6))
        assert status == 429 and int(headers["Retry-After"]) >= 1
    finally:
        front.close()
        node.close()


# -- in-process replicas behind a front ----------------------------------------

def test_replica_lifecycle_lock_orders_match_the_static_graph(root, tmp_path):
    """join -> catch-up -> ready -> background apply beside a scoring
    thread -> drain -> close -> rejoin, with the lock tracker ARMED (as
    the JAX package's tests/test_fleet.py arms it): every observed
    acquisition order is an edge of the port's static lock-order graph,
    and the fleet's locks were taken."""
    r = root["root"]
    with locktrace.enabled() as tracker:
        svc, log, rep = _pair_unjoined(root, tmp_path)
        errors, stop = [], threading.Event()

        def score_loop():
            k = 0
            while not stop.is_set():
                feats, ids, _ = fj._rows(950 + k % 7, 2)
                k += 1
                try:
                    rep.service.score(feats, ids)
                except Exception as e:  # pragma: no cover
                    errors.append(f"{type(e).__name__}: {e}")

        t = threading.Thread(target=score_loop, daemon=True)
        services = [svc, rep.service]
        try:
            fj._fleet_feedback(svc, 940)
            assert rep.join()["records_replayed"] >= 1   # join -> catch-up
            assert rep.healthy()                          # ready
            t.start()
            fj._fleet_feedback(svc, 941)
            rep.start()                                   # background apply
            _wait(lambda: rep.status()["applied_seq"] == log.head_seq())
            rep.drain()
            assert not rep.healthy() and rep.poll_once() == 0
            stop.set()
            t.join(timeout=10)
            rep.close()
            again = Replica(_service(r / "model"), log, str(tmp_path / "state"))
            services.append(again.service)
            again.join()                                  # rejoin
            assert identity(again.audit()) == identity(svc.audit())
        finally:
            stop.set()
            for s in services:
                s.close()
    assert errors == []
    tracker.assert_consistent(port_lock_edges())
    acq = tracker.acquisitions()
    for lock in ("Replica._lock", "ReplicationLog._lock", "FleetPublisher._lock"):
        assert acq.get(lock, 0) > 0, lock


def _pair_unjoined(root, tmp_path):
    svc = _service(root["root"] / "model", updates=True)
    log = ReplicationLog(str(tmp_path / "log"))
    FleetPublisher(svc, log, model_dir=str(root["root"] / "model"))
    rep = Replica(_service(root["root"] / "model"), log, str(tmp_path / "state"),
                  ReplicaConfig(poll_interval_s=0.02))
    return svc, log, rep


def _service(model_dir, updates=False, **cfg):
    return ScoringService(
        model_dir=str(model_dir), start_updater=False,
        config=ServingConfig(max_batch=64, min_bucket=4, device="cpu", dtype=F64,
                             **cfg),
        updates=OnlineUpdateConfig(**fj.UPDATES) if updates else None)


class Served:
    """One service behind cli.serve's HTTP handler on an ephemeral port."""

    def __init__(self, svc, replica=None, publisher=None):
        self.svc, self.replica, self.publisher = svc, replica, publisher
        self.httpd = serve_cli._make_http_server(svc, "127.0.0.1", 0,
                                                 replica=replica,
                                                 publisher=publisher)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       kwargs={"poll_interval": 0.05}, daemon=True)
        self.thread.start()
        self.closed = False

    def close(self):
        if not self.closed:
            self.closed = True
            self.httpd.shutdown()
            self.httpd.server_close()
            if self.replica is not None:
                self.replica.close()
            self.svc.close()


def call(url, path, payload=None, timeout=30):
    req = urllib.request.Request(
        url + path, data=None if payload is None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
        method="GET" if payload is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _request(seed, n=12):
    feats, ids, _ = fj._rows(seed, n)
    body = {"features": {k: v.tolist() for k, v in feats.items()},
            "ids": {k: v.tolist() for k, v in ids.items()}}
    return feats, ids, body


def _wait(cond, timeout=30.0):
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            raise AssertionError("timed out")
        time.sleep(0.02)


@pytest.fixture(scope="module")
def fleet(root):
    """A publisher (online updates) and two followers tailing its log."""
    r = root["root"]
    log_dir = r / "http_log"
    pub_svc = _service(r / "model", updates=True)
    pub = FleetPublisher(pub_svc, ReplicationLog(str(log_dir)),
                         model_dir=str(r / "model"))
    nodes = [Served(pub_svc, publisher=pub)]
    for k in range(2):
        svc = _service(r / "model")
        rep = Replica(svc, ReplicationLog(str(log_dir)), str(r / f"http_state{k}"),
                      ReplicaConfig(poll_interval_s=0.02))
        rep.join()
        rep.start()
        nodes.append(Served(svc, replica=rep))
    yield {"nodes": nodes, "log_dir": log_dir, "pub": pub}
    for n in nodes:
        n.close()


def _front(nodes, **cfg):
    cfg.setdefault("probe_interval_s", 0.05)
    cfg.setdefault("hedge_after_s", 5.0)
    cfg.setdefault("request_timeout_s", 5.0)
    front = Front([n.url for n in nodes], config=FrontConfig(**cfg),
                  start_probes=False)
    front.probe_once()
    return front


def _served_requests(node):
    return node.svc.metrics_snapshot()["requests"]


def test_front_round_robin_over_ready_replicas(fleet):
    nodes = fleet["nodes"]
    front = _front(nodes)
    try:
        before = [_served_requests(n) for n in nodes]
        feats, ids, body = _request(1)
        want = nodes[0].svc.registry.scorer.score(feats, ids).scores
        for _ in range(6):
            status, payload = front.route("/score", body)
            assert status == 200 and payload["scores"] == want.tolist()
        assert [_served_requests(n) - b for n, b in zip(nodes, before)] == [2, 2, 2]
        assert front.status()["ready_replicas"] == 3
    finally:
        front.close()


def test_feedback_through_the_front_replicates_to_every_replica(fleet):
    nodes = fleet["nodes"]
    front = _front(nodes)
    try:
        feats, ids, body = _request(2, n=16)
        labels = (np.arange(16) % 2).astype(float).tolist()
        status, intake, _ = front.route_publisher("POST", "/feedback",
                                                  dict(body, labels=labels))
        assert status == 202 and intake["accepted"] == 16
        # a follower refuses model-state changes: they enter through the log
        assert call(nodes[1].url, "/feedback", dict(body, labels=labels))[0] == 403
        assert call(nodes[1].url, "/swap", {"model_dir": "x"})[0] == 403
        nodes[0].svc.updater.flush()
        head = fleet["pub"].head_seq()
        _wait(lambda: all(n.replica.status()["applied_seq"] == head
                          for n in nodes[1:]))
        audits = front.audit()
        assert len(audits) == 3
        idents = {json.dumps(identity(a), sort_keys=True) for a in audits.values()}
        assert len(idents) == 1
        assert nodes[0].svc.version_vector()["delta_seq"] >= 1
        # the publisher's /healthz carries the log head as its applied seq
        assert call(nodes[0].url, "/healthz")[1]["fleet"]["applied_seq"] == head
    finally:
        front.close()


def test_front_hedges_a_slow_replica(fleet):
    nodes = fleet["nodes"]
    front = _front(nodes, hedge_after_s=0.1)
    slow = nodes[1].svc
    real = slow.score

    def late(*a, **kw):
        time.sleep(2.0)
        return real(*a, **kw)

    slow.score = late
    try:
        _feats, _ids, body = _request(3)
        t0 = time.monotonic()
        for _ in range(3):                    # one of them starts on the slow one
            assert front.route("/score", body)[0] == 200
        assert time.monotonic() - t0 < 4.0
        assert front.metrics_snapshot()["counters"]["fleet.front_hedges"] >= 1
    finally:
        slow.score = real
        front.close()


def test_front_sheds_past_max_inflight(fleet):
    front = _front(fleet["nodes"], max_inflight=0)
    try:
        with pytest.raises(Overloaded):
            front.route("/score", _request(4)[2])
        assert front.metrics_snapshot()["counters"]["fleet.front_shed"] == 1
    finally:
        front.close()


def test_front_drain_takes_a_replica_out_of_rotation(fleet):
    """COMPONENTS.md's drain: the replica stops applying, its /healthz
    flips to 503, the front stops routing to it and detaches it."""
    nodes = fleet["nodes"]
    front = _front(nodes)
    try:
        out = front.drain(nodes[2].url)
        assert out["detached"] is True
        assert nodes[2].replica.status()["draining"] is True
        assert call(nodes[2].url, "/healthz")[0] == 503
        before = _served_requests(nodes[2])
        for _ in range(4):
            assert front.route("/score", _request(5)[2])[0] == 200
        assert _served_requests(nodes[2]) == before
        assert front.status()["ready_replicas"] == 2
        # a delta after the drain reaches the live replica, not the drained one
        drained_seq = nodes[2].replica.status()["applied_seq"]
        feats, ids, _ = _request(10, n=8)
        nodes[0].svc.feedback(feats, ids, (np.arange(8) % 2).astype(float))
        nodes[0].svc.updater.flush()
        head = fleet["pub"].head_seq()
        assert head > drained_seq
        _wait(lambda: nodes[1].replica.status()["applied_seq"] == head)
        assert nodes[2].replica.status()["applied_seq"] == drained_seq
    finally:
        front.close()


def test_front_fails_over_when_a_replica_dies(fleet):
    nodes = fleet["nodes"]
    front = _front(nodes[:2])
    try:
        nodes[1].close()                      # transport-level death
        for _ in range(4):
            assert front.route("/score", _request(6)[2])[0] == 200
        assert front.metrics_snapshot()["counters"]["fleet.front_failovers"] >= 1
        front.probe_once()
        front.probe_once()
        assert front.status()["ready_replicas"] == 1
        dead = _front(nodes[1:2], unhealthy_after=1)
        try:
            with pytest.raises(NoReadyReplica):
                dead.route("/score", _request(6)[2])
        finally:
            dead.close()
    finally:
        front.close()


def test_sharded_fan_out_equals_the_unsharded_scores(root):
    """A publisher declaring two shards, two shard replicas, a front over
    them: /score re-folds the per-shard legs to the monolithic scores bit
    for bit, each replica's audit equals the publisher's filtered audit,
    and a dark shard degrades only the rows that touch it."""
    r = root["root"]
    log_dir = r / "shard_log"
    spec = ShardSpec(num_shards=2)
    pub_svc = _service(r / "model")
    pub = FleetPublisher(pub_svc, ReplicationLog(str(log_dir)),
                         model_dir=str(r / "model"), shard_spec=spec)
    nodes = []
    try:
        for k in range(2):
            svc = _service(r / "model", shard_index=k, shard_count=2)
            rep = Replica(svc, ReplicationLog(str(log_dir)), str(r / f"shard_state{k}"))
            rep.join()
            nodes.append(Served(svc, replica=rep))
        front = _front(nodes)
        try:
            full = CompiledScorer.from_model_dir(str(r / "model"), device="cpu",
                                                 dtype=F64)
            feats, ids, body = _request(7, n=20)
            status, out = front.route("/score", body)
            assert status == 200 and out["sharded"] is True
            assert out["scores"] == full.score(feats, ids).scores.tolist()
            status, out = front.route("/predict", body)
            assert out["predictions"] == full.mean_prediction(
                full.score(feats, ids).scores).tolist()
            for k, n in enumerate(nodes):
                assert n.replica.audit()["table_hashes"] == \
                    pub.shard_audit(k)["table_hashes"]
            nodes[1].close()
            for _ in range(3):
                front.probe_once()
            status, out = front.route("/score", body)
            assert status == 200 and out["degraded"] is True
            assert out["missing_shards"] == [1]
        finally:
            front.close()
    finally:
        for n in nodes:
            n.close()
        pub_svc.close()


def test_margins_route_serves_one_leg(root):
    """POST /margins: one fan-out leg, margins as exact encoded arrays."""
    node = Served(_service(root["root"] / "model", shard_index=0, shard_count=2))
    try:
        feats, ids, body = _request(8)
        status, out = call(node.url, "/margins", body)
        assert status == 200
        want = node.svc.score_margins(feats, ids)["margins"]
        for name, enc in out["margins"].items():
            np.testing.assert_array_equal(decode_array(enc), want[name])
        assert out["shard"]["index"] == 0
    finally:
        node.close()


# -- the CLI's fleet modes ------------------------------------------------------

def _start(argv, name, tmp_path):
    with open(tmp_path / f"{name}.err", "w") as err:
        return subprocess.Popen(
            [sys.executable, "-m", "photon_ml_tpu_torch.cli.serve", *map(str, argv)],
            stdout=subprocess.PIPE, stderr=err, text=True, cwd=REPO,
            env=dict(os.environ, PYTHONPATH=str(REPO)))


def _stop(proc, timeout=60):
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=timeout)
    return proc.returncode, json.loads(out.strip().splitlines()[-1])


def test_cli_serve_replica_and_front_modes(fleet, root, tmp_path):
    """`--replica --health-config` follower on the in-process publisher's
    log and a `--front` over the publisher and that follower."""
    nodes, r = fleet["nodes"], root["root"]
    # the follower's port is chosen here, so that both children start at once
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    url = f"http://127.0.0.1:{port}"
    follower = _start(["--model-dir", r / "model", "--replica", "--replication-log",
                       fleet["log_dir"], "--replica-state", tmp_path / "state",
                       "--health-config", "{}", "--port", port, "--min-bucket", 4,
                       "--max-batch", 64, "--device", "cpu", "--x64"],
                      "follower", tmp_path)
    front = _start(["--front", "--replica-url", nodes[0].url, "--replica-url", url,
                    "--probe-interval-ms", 50, "--port", 0], "front", tmp_path)
    try:
        start = json.loads(follower.stdout.readline())
        assert start["mode"] == "replica" and start["health_enabled"] is True
        assert start["join"]["applied_seq"] == fleet["pub"].head_seq()
        assert start["serving"] == url
        fstart = json.loads(front.stdout.readline())
        assert fstart["mode"] == "front" and fstart["publisher"] == nodes[0].url
        furl = fstart["serving"]
        code, health = call(url, "/healthz")
        assert code == 200 and health["fleet"]["ready"] is True
        assert health["health"]["status"] == "ok"
        assert identity(call(url, "/fleet/audit")[1]) == identity(nodes[0].svc.audit())
        assert call(url, "/feedback", {"labels": [1.0]})[0] == 403
        _wait(lambda: call(furl, "/healthz")[0] == 200)
        feats, ids, body = _request(9)
        want = nodes[0].svc.registry.scorer.score(feats, ids).scores.tolist()
        for _ in range(4):
            assert call(furl, "/score", body)[1]["scores"] == want
        audits = call(furl, "/fleet/audit")[1]
        assert set(audits) == {nodes[0].url, url}
        assert call(furl, "/fleet/drain", {"replica": url})[1]["detached"] is True
        assert call(url, "/healthz")[0] == 503
        rc, last = _stop(front)
        assert rc == 0 and last == {"drained": True, "aborted": False, "mode": "front"}
        rc, last = _stop(follower)
        assert rc == 0 and last["drained"] is True
    finally:
        for p in (follower, front):
            if p.poll() is None:
                p.kill()
                p.communicate()
