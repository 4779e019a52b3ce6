"""Durable append-only replication log: the fleet's model-state backbone
(a copy of photon_ml_tpu/fleet/replog.py: host-only, and byte-compatible,
so a segment, feedback segment or snapshot either package writes reads in
the other with the same records and checksums).

Every model-state change of the publisher's ModelRegistry — full-model
swap, row-level ModelDelta, delta-aware rollback, full-model rollback —
lands here as ONE checksummed JSON record in an fsynced segment file, in
the exact mutation order (the registry's publish-hook tickets).  Replicas
tail the log and replay records through their own registries, converging
to BIT-IDENTICAL tables: arrays are encoded as base64 of the raw device
bytes (dtype + shape + buffer), so a float64 row survives the round trip
bit-for-bit — no decimal re-parsing in the convergence path.

Durability discipline (utils/durable.py): segment
appends go through `durable.append_text` (write + flush + fsync); appends
are not atomic the way replace-writes are, so every record carries a
sha256 over its canonical encoding and a TORN TAIL — the half-record a
crash mid-append leaves — is detected and ignored on read (and truncated
on the publisher's next open).  Mid-file corruption is NOT a torn tail
and raises: that log is damaged, not merely interrupted.

Compaction folds acked records (everything at or below the minimum
applied seq across live replicas) into a snapshot: the net row state vs a
base model directory, written atomically to `snapshot.json`, after which
fully-covered segments are deleted.  A joining replica bootstraps from
the snapshot and replays only the tail.

Single-writer contract: exactly one publisher appends (the fleet's
FleetPublisher serializes registry tickets through `append`).  A second
concurrent appender is an error, not a silent interleave.

Fault sites (utils.faults.SITES): `replog.append` fires before each
record write (transient -> the publisher's retry-with-backoff absorbs
it), `replog.read` before each tail read (transient -> the replica's
poll-loop retry absorbs it).

Feedback lane (`FeedbackLog`): labeled-observation batches admitted by
the online updater land in sibling `feedback-*.seg` segments with the
SAME sha256/torn-tail/fsync discipline, so the refit compactor
(photon_ml_tpu_torch/refit/) replays a complete training source from the
fleet's own exhaust.  Compaction on either lane is bounded by registered
consumers (`register_consumer`): folding past the newest seq a refit
compactor checkpoint still needs would strand the compactor exactly the
way folding past a replica's applied seq strands the replica.
"""
from __future__ import annotations

import base64
import hashlib
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.utils import durable, faults, locktrace


class ReplicationLogError(RuntimeError):
    """Structural log failure (corruption mid-file, concurrent appenders,
    compacted-away history) — never a torn tail, which is recovered."""


#: records per segment file before rotation
SEGMENT_RECORDS = 1024

_SEGMENT_PREFIX = "segment-"
_SEGMENT_SUFFIX = ".log"
_SNAPSHOT_NAME = "snapshot.json"


# -- bit-exact array transport ------------------------------------------------

def encode_array(a) -> Dict[str, object]:
    """numpy array -> {dtype, shape, b64 raw bytes}: exact byte transport
    (JSON floats would survive repr round-trips too, but raw bytes make
    bit-identity a property of the ENCODING, not of the parser).  A torch
    tensor, on any device, is read back to the host first."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    a = np.ascontiguousarray(np.asarray(a))
    return {"dtype": a.dtype.str, "shape": list(a.shape),
            "b64": base64.b64encode(a.tobytes()).decode("ascii")}


def decode_array(d: Dict[str, object]) -> np.ndarray:
    a = np.frombuffer(base64.b64decode(d["b64"]),
                      dtype=np.dtype(str(d["dtype"])))
    return a.reshape([int(s) for s in d["shape"]]).copy()


def _canonical(obj) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def _line_for(envelope: dict) -> str:
    sha = hashlib.sha256(_canonical(envelope).encode()).hexdigest()[:16]
    return _canonical({**envelope, "sha": sha}) + "\n"


def _parse_line(line: str) -> Optional[dict]:
    """One segment line -> envelope dict, or None when the line is torn
    (incomplete JSON / missing or mismatched checksum)."""
    line = line.strip()
    if not line:
        return None
    try:
        env = json.loads(line)
    except ValueError:
        return None
    sha = env.pop("sha", None)
    if sha != hashlib.sha256(_canonical(env).encode()).hexdigest()[:16]:
        return None
    return env


class ReplicationLog:
    #: segment naming, overridable by sibling lanes (FeedbackLog)
    _PREFIX = _SEGMENT_PREFIX
    _SUFFIX = _SEGMENT_SUFFIX
    _SNAP = _SNAPSHOT_NAME

    def __init__(self, log_dir: str, segment_records: int = SEGMENT_RECORDS):
        self.log_dir = str(log_dir)
        self.segment_records = int(segment_records)
        os.makedirs(self.log_dir, exist_ok=True)
        self._lock = locktrace.tracked(threading.Lock(),
                                       "ReplicationLog._lock")
        self._appending = False  # photonlint: guarded-by=_lock
        self._head_seq: Optional[int] = None  # photonlint: guarded-by=_lock
        # compaction consumers: name -> checkpoint_fn() returning the
        # newest seq that consumer has durably absorbed.  compact() never
        # folds past the minimum — a refit compactor's unread tail is as
        # load-bearing as a replica's unapplied tail.
        self._consumers: Dict[str, Callable[[], int]] = {}

    # -- segment bookkeeping -------------------------------------------------

    def _segments(self) -> List[str]:
        try:
            names = os.listdir(self.log_dir)
        except FileNotFoundError:
            return []
        return sorted(n for n in names
                      if n.startswith(self._PREFIX)
                      and n.endswith(self._SUFFIX))

    @classmethod
    def _first_seq_of(cls, name: str) -> int:
        return int(name[len(cls._PREFIX):-len(cls._SUFFIX)])

    def _segment_path(self, first_seq: int) -> str:
        return os.path.join(
            self.log_dir,
            f"{self._PREFIX}{first_seq:010d}{self._SUFFIX}")

    def _scan_segment(self, name: str) -> List[dict]:
        """Parse one segment; a torn LAST line is dropped, a bad record
        anywhere else is corruption and raises."""
        path = os.path.join(self.log_dir, name)
        with open(path) as f:
            lines = f.readlines()
        out: List[dict] = []
        for i, line in enumerate(lines):
            env = _parse_line(line)
            if env is None:
                if i == len(lines) - 1:
                    break  # torn tail: the crash interrupted this append
                raise ReplicationLogError(
                    f"corrupt record at {name}:{i + 1} (not the final "
                    "line, so this is damage, not a torn append)")
            out.append(env)
        return out

    def head_seq(self) -> int:
        """Newest durable record's log seq (0 = empty log; snapshot-only
        logs report the snapshot's upto_seq)."""
        with self._lock:
            if self._head_seq is not None:
                return self._head_seq
        head = 0
        snap = self.latest_snapshot()
        if snap is not None:
            head = int(snap["upto_seq"])
        for name in reversed(self._segments()):
            records = self._scan_segment(name)
            if records:
                head = max(head, int(records[-1]["log_seq"]))
                break
        with self._lock:
            self._head_seq = head
        return head

    # -- append (single writer) ----------------------------------------------

    def append(self, record: dict) -> int:
        """Durably append one record; returns its log seq.  Single-writer:
        the publisher serializes calls (registry ticket order), and a
        second concurrent appender raises instead of interleaving.  The
        fsync happens OUTSIDE the lock — ordering is safe because only
        the one legitimate appender ever reaches the write."""
        with self._lock:
            if self._appending:
                raise ReplicationLogError(
                    "concurrent append — the replication log is "
                    "single-writer (one FleetPublisher per log)")
            self._appending = True
        try:
            head = self.head_seq()
            seq = head + 1
            faults.fire("replog.append", kind=str(record.get("kind")))
            segments = self._segments()
            if segments:
                last = segments[-1]
                path = os.path.join(self.log_dir, last)
                if self._count_records(path) >= self.segment_records:
                    path = self._segment_path(seq)
            else:
                path = self._segment_path(seq)
            envelope = {"log_seq": seq, "t": time.time(), "record": record}
            durable.append_text(path, _line_for(envelope))
            with self._lock:
                self._head_seq = seq
            return seq
        finally:
            with self._lock:
                self._appending = False

    def _count_records(self, path: str) -> int:
        with open(path) as f:
            return sum(1 for line in f if line.strip())

    def recover(self) -> int:
        """Publisher-side open: truncate a torn tail left by a crash
        mid-append so future appends extend a clean segment.  Returns the
        number of bytes dropped (0 = clean)."""
        segments = self._segments()
        if not segments:
            return 0
        path = os.path.join(self.log_dir, segments[-1])
        good_end = 0
        with open(path, "rb") as f:
            for raw in f:
                if _parse_line(raw.decode("utf-8", "replace")) is None:
                    break
                good_end += len(raw)
        size = os.path.getsize(path)
        if good_end < size:
            with open(path, "rb+") as f:
                f.truncate(good_end)
            durable.fsync_file(path)
            with self._lock:
                self._head_seq = None  # recompute past the truncation
            return size - good_end
        return 0

    # -- read ----------------------------------------------------------------

    def read(self, after_seq: int) -> List[dict]:
        """All durable records with log_seq > after_seq, in order.  Raises
        ReplicationLogError when that history was compacted away (the
        caller must bootstrap from `latest_snapshot()` instead)."""
        faults.fire("replog.read", segment=str(int(after_seq)))
        out: List[dict] = []
        expected = None
        for name in self._segments():
            first = self._first_seq_of(name)
            records = self._scan_segment(name)
            if records and int(records[-1]["log_seq"]) <= after_seq:
                continue
            for env in records:
                seq = int(env["log_seq"])
                if seq <= after_seq:
                    continue
                if expected is None:
                    if seq != after_seq + 1:
                        snap = self.latest_snapshot()
                        if snap is not None and \
                                int(snap["upto_seq"]) >= after_seq:
                            raise ReplicationLogError(
                                f"records after seq {after_seq} were "
                                "compacted away — bootstrap from the "
                                "snapshot (upto_seq "
                                f"{snap['upto_seq']}) and replay from "
                                "there")
                        raise ReplicationLogError(
                            f"log gap: expected seq {after_seq + 1}, "
                            f"found {seq} (segment {name})")
                elif seq != expected:
                    raise ReplicationLogError(
                        f"log gap: expected seq {expected}, found {seq} "
                        f"(segment {name})")
                expected = seq + 1
                out.append(env)
        return out

    # -- snapshot + compaction ----------------------------------------------

    def latest_snapshot(self) -> Optional[dict]:
        path = os.path.join(self.log_dir, self._SNAP)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    # -- bounded retention (compaction consumers) -----------------------------

    def register_consumer(self, name: str,
                          checkpoint_fn: Callable[[], int]) -> None:
        """Register a compaction consumer (e.g. the refit compactor):
        `checkpoint_fn()` returns the newest log seq that consumer has
        durably absorbed, and `compact()` refuses to fold past the
        minimum across all registered consumers — records a checkpoint
        still needs stay readable."""
        with self._lock:
            self._consumers[str(name)] = checkpoint_fn

    def unregister_consumer(self, name: str) -> None:
        with self._lock:
            self._consumers.pop(str(name), None)

    def _retention_clamp(self, upto_seq: int) -> int:
        with self._lock:
            fns = dict(self._consumers)
        for fn in fns.values():
            upto_seq = min(upto_seq, int(fn()))
        return upto_seq

    def _note_compacted(self, *, upto_seq: int, requested_seq: int,
                        folded: int, segments_deleted: int) -> None:
        telemetry.event("replog.compacted", lane=type(self).__name__,
                        upto_seq=upto_seq, requested_seq=requested_seq,
                        folded=folded, segments_deleted=segments_deleted,
                        clamped=upto_seq < requested_seq)
        telemetry.counter("replog.compacted").inc()

    def _drop_covered_segments(self, upto_seq: int) -> int:
        """Delete segments whose every record is <= upto_seq; returns the
        number removed."""
        segments = self._segments()
        dropped = 0
        for i, name in enumerate(segments):
            nxt = (self._first_seq_of(segments[i + 1])
                   if i + 1 < len(segments) else None)
            if nxt is not None and nxt - 1 <= upto_seq:
                os.remove(os.path.join(self.log_dir, name))
                dropped += 1
            elif nxt is None:
                records = self._scan_segment(name)
                if records and int(records[-1]["log_seq"]) <= upto_seq:
                    os.remove(os.path.join(self.log_dir, name))
                    dropped += 1
        durable.fsync_dir(self.log_dir)
        return dropped

    def compact(self, upto_seq: int) -> Optional[dict]:
        """Fold every record with log_seq <= upto_seq into a snapshot —
        the net row state per coordinate vs the base model directory —
        then delete segments wholly covered by it.  `upto_seq` must be
        the minimum APPLIED seq across live replicas (folding records a
        replica has not applied would strand it), and is additionally
        clamped to the minimum registered consumer checkpoint (a refit
        compactor's unread tail is never folded away).  Returns the
        snapshot (None when there is nothing to fold)."""
        requested = int(upto_seq)
        upto_seq = self._retention_clamp(requested)
        snap = self.latest_snapshot()
        if upto_seq <= (int(snap["upto_seq"]) if snap else 0):
            return snap
        state = _FoldState.from_snapshot(snap)
        folded = 0
        for env in self.read(state.seq):
            if int(env["log_seq"]) > upto_seq:
                break
            state.fold(env)
            folded += 1
        if folded == 0:
            return snap
        new_snap = state.to_snapshot()
        durable.atomic_write_json(
            os.path.join(self.log_dir, self._SNAP), new_snap)
        dropped = self._drop_covered_segments(upto_seq)
        self._note_compacted(upto_seq=upto_seq, requested_seq=requested,
                             folded=folded, segments_deleted=dropped)
        return new_snap

    # -- lane accounting (fleet.log_records / fleet.log_bytes gauges) ---------

    def live_records(self) -> int:
        """Records currently held in durable segments (excludes history
        folded into the snapshot)."""
        return sum(self._count_records(os.path.join(self.log_dir, name))
                   for name in self._segments())

    def live_bytes(self) -> int:
        """Bytes currently held in durable segments."""
        total = 0
        for name in self._segments():
            try:
                total += os.path.getsize(os.path.join(self.log_dir, name))
            except FileNotFoundError:
                pass
        return total


class _FoldState:
    """Compaction simulator: replays records host-side with the same
    semantics a replica's registry applies them with, keeping the net
    row value per (coordinate, row) — last write wins, rollbacks restore
    — plus the previous version's as-last-served rows so a full-model
    rollback folds correctly."""

    def __init__(self):
        self.seq = 0
        self.model_dir: Optional[str] = None
        self.version: Optional[str] = None
        self.delta_seq = 0
        self.rows: Dict[str, Dict[int, np.ndarray]] = {}
        self.previous = None  # (model_dir, version, delta_seq, rows)
        # entity-shard partition (fleet/shards.py ShardSpec.to_dict):
        # fleet topology, not model state — survives swaps/rollbacks
        self.shard_map: Optional[dict] = None

    @classmethod
    def from_snapshot(cls, snap: Optional[dict]) -> "_FoldState":
        st = cls()
        if snap is None:
            return st
        st.seq = int(snap["upto_seq"])
        st.model_dir = snap["model_dir"]
        st.version = snap["version"]
        st.delta_seq = int(snap["delta_seq"])
        for lane, enc in snap.get("restored", {}).items():
            rows = decode_array(enc["rows"])
            values = decode_array(enc["values"])
            st.rows[lane] = {int(r): v for r, v in zip(rows, values)}
        st.shard_map = snap.get("shard_map")
        return st

    def fold(self, env: dict) -> None:
        rec = env["record"]
        kind = rec["kind"]
        if kind == "swap":
            if not rec.get("source_dir"):
                raise ReplicationLogError(
                    f"cannot compact across the in-memory swap at seq "
                    f"{env['log_seq']} (version {rec['version']!r}): a "
                    "snapshot must name a loadable base model directory")
            self.previous = (self.model_dir, self.version, self.delta_seq,
                             {lane: dict(rows)
                              for lane, rows in self.rows.items()})
            self.model_dir = rec["source_dir"]
            self.version = rec["version"]
            self.delta_seq = 0
            self.rows = {}
        elif kind == "delta":
            for lane, enc in rec["coordinates"].items():
                lane_rows = self.rows.setdefault(lane, {})
                for r, v in zip(decode_array(enc["rows"]),
                                decode_array(enc["values"])):
                    lane_rows[int(r)] = v
            self.delta_seq = int(rec["delta_seq"])
        elif kind == "delta_rollback":
            for lane, enc in rec["restored"].items():
                lane_rows = self.rows.setdefault(lane, {})
                for r, v in zip(decode_array(enc["rows"]),
                                decode_array(enc["values"])):
                    lane_rows[int(r)] = v
            self.delta_seq = int(rec["to_delta_seq"])
        elif kind == "shard_map":
            # versioned entity partition announcement: last one wins (a
            # rebalance appends a new record; replicas built for another
            # spec refuse it at apply time, not here)
            self.shard_map = dict(rec["spec"])
        elif kind == "rollback":
            if self.previous is None or self.previous[0] is None:
                raise ReplicationLogError(
                    f"cannot compact across the full-model rollback at "
                    f"seq {env['log_seq']}: the previous version's base "
                    "directory is unknown")
            (self.model_dir, self.version, self.delta_seq,
             self.rows) = self.previous
            self.previous = None
        else:
            raise ReplicationLogError(
                f"unknown record kind {kind!r} at seq {env['log_seq']} — "
                "refusing to fold records this build does not understand")
        self.seq = int(env["log_seq"])

    def to_snapshot(self) -> dict:
        if self.model_dir is None:
            raise ReplicationLogError(
                "nothing to snapshot: no swap record named a base model "
                "directory")
        restored = {}
        for lane, lane_rows in self.rows.items():
            if not lane_rows:
                continue
            idx = sorted(lane_rows)
            restored[lane] = {
                "rows": encode_array(np.asarray(idx, np.int64)),
                "values": encode_array(np.stack(
                    [lane_rows[r] for r in idx]))}
        out = {"format_version": 1, "upto_seq": self.seq,
               "model_dir": self.model_dir, "version": self.version,
               "delta_seq": self.delta_seq, "restored": restored,
               "created_at": time.time()}
        if self.shard_map is not None:
            out["shard_map"] = dict(self.shard_map)
        return out


# -- record constructors (the publisher's event -> record mapping) -----------

def record_for_event(event: dict) -> dict:
    """A ModelRegistry publish-hook event -> its log record."""
    kind = event["kind"]
    if kind == "swap":
        return {"kind": "swap", "version": event["version"],
                "previous_version": event.get("previous_version"),
                "source_dir": event.get("source_dir")}
    if kind == "delta":
        delta = event["delta"]
        rec = {"kind": "delta", "version": event["version"],
               "base_version": delta.base_version,
               "delta_seq": int(delta.seq),
               "created_at": float(delta.created_at),
               "coordinates": {
                   lane: {"rows": encode_array(cd.rows),
                          "values": encode_array(cd.values),
                          "prior": encode_array(cd.prior)}
                   for lane, cd in delta.coordinates.items()}}
        if getattr(delta, "trace", None):
            # cross-process trace metadata (request ids + publisher span
            # ref + oldest intake wall time): replicas attach it to their
            # apply spans so `cli.trace merge` stitches the feedback ->
            # delta -> apply flow into one tree
            rec["trace"] = dict(delta.trace)
        return rec
    if kind == "delta_rollback":
        return {"kind": "delta_rollback", "version": event["version"],
                "to_delta_seq": int(event["to_delta_seq"]),
                "restored": {
                    lane: {"rows": encode_array(rows),
                           "values": encode_array(values)}
                    for lane, (rows, values) in event["restored"].items()}}
    if kind == "rollback":
        return {"kind": "rollback", "version": event["version"],
                "previous_version": event.get("previous_version"),
                "degraded": bool(event.get("degraded", False))}
    raise ReplicationLogError(f"unknown publish event kind {kind!r}")


def record_for_shard_map(spec) -> dict:
    """A fleet shard-map announcement (fleet/shards.py ShardSpec) -> its
    log record.  The publisher appends one when it anchors a sharded
    fleet's log (and after any rebalance bumps the spec version), so the
    partition every replica filters by is itself replicated, versioned,
    and audited like model state."""
    return {"kind": "shard_map", "spec": spec.to_dict()}


def delta_from_record(rec: dict):
    """A "delta" log record -> the ModelDelta a replica's registry
    applies (bit-exact arrays)."""
    from photon_ml_tpu_torch.online.delta import CoordinateDelta, ModelDelta
    return ModelDelta(
        base_version=rec["base_version"], seq=int(rec["delta_seq"]),
        coordinates={
            lane: CoordinateDelta(rows=decode_array(enc["rows"]),
                                  values=decode_array(enc["values"]),
                                  prior=decode_array(enc["prior"]))
            for lane, enc in rec["coordinates"].items()},
        created_at=float(rec.get("created_at", 0.0)))


# -- feedback lane (labeled-observation exhaust) ------------------------------

_FEEDBACK_PREFIX = "feedback-"
_FEEDBACK_SUFFIX = ".seg"
_FEEDBACK_SNAPSHOT_NAME = "feedback-snapshot.json"


class FeedbackLog(ReplicationLog):
    """Sibling durable lane for admitted labeled feedback batches: the
    refit compactor's complete labeled-observation source.

    Same single-writer, sha256-per-record, torn-tail-truncating,
    fsynced-segment discipline as the model-state log, with `feedback-`
    `.seg` segment naming so one directory can host both lanes.  There is
    no row-state fold here — the refit compactor's sealed chunk files ARE
    this lane's compacted form — so `compact(upto_seq)` prunes covered
    segments and records the pruned horizon in a marker snapshot
    (`feedback-snapshot.json`, so `head_seq()` and compacted-history
    reads keep the base class's semantics).  Retention is bounded by
    registered consumers exactly like the model lane."""

    _PREFIX = _FEEDBACK_PREFIX
    _SUFFIX = _FEEDBACK_SUFFIX
    _SNAP = _FEEDBACK_SNAPSHOT_NAME

    def compact(self, upto_seq: int) -> Optional[dict]:
        """Prune segments wholly covered by `upto_seq` (clamped to the
        minimum registered consumer checkpoint) and persist the pruned
        horizon.  Returns the marker snapshot."""
        requested = int(upto_seq)
        upto_seq = self._retention_clamp(requested)
        snap = self.latest_snapshot()
        prev = int(snap["upto_seq"]) if snap else 0
        if upto_seq <= prev:
            return snap
        covered = sum(
            1 for env in self.read(prev)
            if int(env["log_seq"]) <= upto_seq)
        if covered == 0:
            return snap
        new_snap = {"format_version": 1, "kind": "feedback",
                    "upto_seq": upto_seq, "created_at": time.time()}
        durable.atomic_write_json(
            os.path.join(self.log_dir, self._SNAP), new_snap)
        dropped = self._drop_covered_segments(upto_seq)
        self._note_compacted(upto_seq=upto_seq, requested_seq=requested,
                             folded=covered, segments_deleted=dropped)
        with self._lock:
            self._head_seq = None  # recompute against the new horizon
        return new_snap


def record_for_feedback(features: Dict[str, np.ndarray],
                        ids: Dict[str, np.ndarray],
                        labels: np.ndarray,
                        weights: Optional[np.ndarray] = None,
                        offsets: Optional[np.ndarray] = None,
                        *,
                        event_ids: Optional[List[str]] = None,
                        trace_id: Optional[str] = None,
                        wall_s: Optional[float] = None) -> dict:
    """An admitted feedback batch -> its durable log record (bit-exact
    float transport; raw entity ids as strings)."""
    labels = np.asarray(labels, np.float64)
    n = int(labels.shape[0])
    weights = (np.ones(n) if weights is None
               else np.asarray(weights, np.float64))
    offsets = (np.zeros(n) if offsets is None
               else np.asarray(offsets, np.float64))
    rec = {"kind": "feedback", "rows": n,
           "features": {s: encode_array(np.asarray(a, np.float64))
                        for s, a in features.items()},
           "ids": {t: [str(v) for v in np.asarray(a).tolist()]
                   for t, a in ids.items()},
           "labels": encode_array(labels),
           "weights": encode_array(weights),
           "offsets": encode_array(offsets),
           "wall_s": float(time.time() if wall_s is None else wall_s)}
    if event_ids is not None:
        rec["event_ids"] = [None if e is None else str(e)
                            for e in event_ids]
    if trace_id:
        rec["trace_id"] = str(trace_id)
    return rec


def feedback_from_record(rec: dict) -> dict:
    """A "feedback" log record -> host arrays (the compactor's input):
    {features: {shard: [n,d] f64}, ids: {type: [n] object}, labels,
    weights, offsets, wall_s, event_ids, trace_id}."""
    if rec.get("kind") != "feedback":
        raise ReplicationLogError(
            f"not a feedback record: kind={rec.get('kind')!r}")
    return {
        "features": {s: decode_array(enc)
                     for s, enc in rec["features"].items()},
        "ids": {t: np.asarray(v, dtype=object)
                for t, v in rec["ids"].items()},
        "labels": decode_array(rec["labels"]),
        "weights": decode_array(rec["weights"]),
        "offsets": decode_array(rec["offsets"]),
        "wall_s": float(rec.get("wall_s", 0.0)),
        "event_ids": rec.get("event_ids"),
        "trace_id": rec.get("trace_id"),
    }
