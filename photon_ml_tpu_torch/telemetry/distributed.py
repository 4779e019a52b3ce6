"""Cross-process trace propagation + multi-process trace merge (a copy of
photon_ml_tpu/telemetry/distributed.py; its run-log records are the JAX
package's key for key, so either package's merge reads the other's logs).

A tracer alone stops at the process boundary: a scoring request that is
hedged by the front, scored on replica B, and whose feedback later
triggers a delta publish leaves four disconnected span trees in four run
logs.  This module makes one logical request ONE tree:

  PROPAGATION — the front mints a `request_id` per routed request and
  carries it as HTTP headers (`X-Photon-Trace` = request id,
  `X-Photon-Parent` = the sender's `pid:span_id` ref) through every hop:
  front routing/hedging -> replica scoring, /feedback -> the publisher's
  OnlineUpdater cycle -> the replication-log record -> every replica's
  apply.  Server-side handlers open a `serve_request` span via
  `server_span()`, which adopts the incoming id (or mints one for
  direct-to-replica traffic) and records the remote parent ref as a span
  attr; asynchronous hops (feedback rows buffered into a later update
  cycle, deltas applied from the log) carry the ids in `request_ids`
  attrs and in the log record's `trace` metadata.

  CLOCK ALIGNMENT — each process's run log anchors its perf-counter
  timeline at `wall0_unix_s` (the tracer's meta record).  Wall clocks on
  one host agree to ~µs, but the anchor pairs (perf_counter(), time())
  are sampled non-atomically, so the front refines them: every health
  probe is also an NTP-style clock probe (`offset ≈ remote_wall -
  (send+recv)/2`), emitted as `clock_probe` events.  The merge keeps the
  minimum-RTT probe per process — the tightest bound available without a
  time daemon.

  MERGE — `merge_run_logs([...run-log.jsonl])` stitches the per-process
  logs into one validated Perfetto/Chrome trace: real pids as Perfetto
  process tracks (named by role), globally-unique `pid:span_id` refs,
  flow events binding each request's spans across processes, and a
  connectivity + containment report (every sampled request one connected
  tree; children inside their parents after alignment).  The CLI face is
  `python -m photon_ml_tpu_torch.cli.trace merge`.
"""
from __future__ import annotations

import json
import os
import threading
import time
import uuid
from typing import Dict, Iterable, List, Optional, Tuple

from photon_ml_tpu_torch.telemetry import core as _core

#: the propagation headers (the "header grammar" in README/COMPONENTS)
TRACE_HEADER = "X-Photon-Trace"
PARENT_HEADER = "X-Photon-Parent"

_TLS = threading.local()


def new_request_id() -> str:
    """16 hex chars: unique across a fleet for any realistic horizon."""
    return uuid.uuid4().hex[:16]


def span_ref(span_id: Optional[int],
             pid: Optional[int] = None) -> Optional[str]:
    """A process-qualified span reference: "pid:span_id"."""
    if span_id is None:
        return None
    return f"{pid if pid is not None else os.getpid()}:{span_id}"


# -- thread-local request context ---------------------------------------------

def set_context(request_id: Optional[str],
                ref: Optional[str] = None) -> None:
    _TLS.request_id = request_id
    _TLS.ref = ref


def current_request_id() -> Optional[str]:
    return getattr(_TLS, "request_id", None)


def current_ref() -> Optional[str]:
    """The propagation parent ref for an outbound hop: the ref stored by
    the enclosing server_span / front request scope."""
    return getattr(_TLS, "ref", None)


def outbound_headers(request_id: Optional[str] = None,
                     ref: Optional[str] = None) -> Dict[str, str]:
    """Headers for an outbound HTTP hop.  Explicit values win (the front
    captures them on the request thread before handing sends to pool
    threads); otherwise the thread-local context applies.  Empty when
    there is nothing to propagate."""
    rid = request_id if request_id is not None else current_request_id()
    parent = ref if ref is not None else current_ref()
    out: Dict[str, str] = {}
    if rid:
        out[TRACE_HEADER] = rid
    if parent:
        out[PARENT_HEADER] = parent
    return out


class server_span:
    """`with distributed.server_span("serve_request", handler.headers,
    path="/score"):` — the server half of a propagated hop.

    Adopts the incoming request id (minting one when absent so
    direct-to-replica traffic is traceable too), opens a telemetry span
    carrying `request_id` (+ `remote_parent` when the peer sent one), and
    installs the thread-local context so deeper code — `feedback()`
    stamping buffered observations, nested outbound hops — sees the
    request identity.  Disarmed tracing costs the usual no-op span plus
    two thread-local writes."""

    __slots__ = ("_name", "_attrs", "_request_id", "_remote_parent",
                 "_span", "_prev")

    def __init__(self, name: str, headers=None, request_id: Optional[str]
                 = None, remote_parent: Optional[str] = None, **attrs):
        get = (headers.get if headers is not None else lambda _k: None)
        self._request_id = (request_id or get(TRACE_HEADER)
                            or new_request_id())
        self._remote_parent = remote_parent or get(PARENT_HEADER)
        self._name = name
        self._attrs = attrs

    @property
    def request_id(self) -> str:
        return self._request_id

    def __enter__(self) -> "server_span":
        attrs = dict(self._attrs)
        attrs["request_id"] = self._request_id
        if self._remote_parent:
            attrs["remote_parent"] = self._remote_parent
        tracer = _core.active_tracer()
        if tracer is not None:
            self._span = tracer.push(self._name, attrs)
            ref = span_ref(self._span.span_id)
        else:
            self._span = None
            ref = self._remote_parent
        self._prev = (current_request_id(), current_ref())
        set_context(self._request_id, ref)
        return self

    def __exit__(self, *exc):
        set_context(*self._prev)
        if self._span is not None:
            self._span._tracer.pop(self._span)
        return False


def clock_info() -> Dict[str, object]:
    """The clock-probe payload a serving process embeds in /healthz:
    enough for a prober to identify this process's timeline (pid + role)
    and estimate its wall-clock offset."""
    tracer = _core.active_tracer()
    return {"pid": os.getpid(),
            "proc": tracer.proc if tracer is not None else "proc",
            "wall_s": time.time()}


# -- run-log parsing + merge --------------------------------------------------

def parse_run_log(path: str) -> Dict[str, object]:
    """One JSONL run log -> {"meta", "spans", "events"}.  Torn final
    lines (a killed process mid-write) are dropped, matching the
    replication log's read discipline."""
    meta = None
    spans: List[dict] = []
    events: List[dict] = []
    with open(path, encoding="utf-8") as f:
        lines = f.readlines()
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            if i == len(lines) - 1:
                break  # torn tail: the process died mid-append
            raise
        kind = rec.get("kind")
        if kind == "meta" and meta is None:
            meta = rec
        elif kind == "span":
            spans.append(rec)
        elif kind == "event":
            events.append(rec)
    if meta is None:
        raise ValueError(
            f"run log {path!r} has no process_meta record — it predates "
            "multi-process tracing (re-export with this version) or is "
            "not a telemetry run log")
    return {"meta": meta, "spans": spans, "events": events, "path": path}


def _collect_offsets(logs: List[dict]) -> Dict[int, Tuple[float, float]]:
    """clock_probe events -> {remote pid: (offset_s, rtt_s)}, keeping the
    minimum-RTT probe per process (the tightest NTP-style bound)."""
    best: Dict[int, Tuple[float, float]] = {}
    for lg in logs:
        for ev in lg["events"]:
            if ev.get("name") != "clock_probe":
                continue
            attrs = ev.get("attrs", {})
            try:
                pid = int(attrs["pid"])
                offset = float(attrs["offset_s"])
                rtt = float(attrs["rtt_s"])
            except (KeyError, TypeError, ValueError):
                continue
            if pid not in best or rtt < best[pid][1]:
                best[pid] = (offset, rtt)
    return best


def _span_request_ids(attrs: dict) -> List[str]:
    """The request ids a span belongs to: its own `request_id` plus any
    `request_ids` list an aggregation span (online_update, replica_apply)
    carries as a comma-joined string."""
    out: List[str] = []
    rid = attrs.get("request_id")
    if rid:
        out.append(str(rid))
    multi = attrs.get("request_ids")
    if multi:
        out.extend(r for r in str(multi).split(",") if r)
    return out


class _Union:
    """Tiny union-find for the per-request connectivity check."""

    def __init__(self):
        self.parent: Dict[str, str] = {}

    def find(self, x: str) -> str:
        self.parent.setdefault(x, x)
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, a: str, b: str) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[ra] = rb


def merge_run_logs(paths: Iterable[str], out_path: Optional[str] = None,
                   containment_slack_s: float = 0.025
                   ) -> Dict[str, object]:
    """Stitch per-process run logs into one Perfetto trace + report.

    Returns {"processes", "spans", "events", "requests", "connected_ok",
    "containment", "clock_offsets", "problems", "trace"} — `trace` is
    the Chrome-trace payload (also written atomically to `out_path` when
    given), `problems` is `validate_chrome_trace`'s verdict on it.
    """
    from photon_ml_tpu_torch.telemetry.export import validate_chrome_trace

    logs = [parse_run_log(p) for p in paths]
    offsets = _collect_offsets(logs)

    # wall-anchor every record; apply the probe offset so every process
    # lands on the PROBER's (front's) timeline
    procs: List[dict] = []
    all_spans: List[dict] = []   # each: ref/pid/tid/name/ts/dur/attrs/parent
    all_events: List[dict] = []
    for lg in logs:
        meta = lg["meta"]
        pid = int(meta["pid"])
        offset, rtt = offsets.get(pid, (0.0, None))
        wall0 = float(meta["wall0_unix_s"]) - offset
        procs.append({"pid": pid, "proc": meta.get("proc", "proc"),
                      "path": lg["path"], "offset_s": offset,
                      "probe_rtt_s": rtt,
                      "spans": len(lg["spans"]), "events": len(lg["events"])})
        for rec in lg["spans"]:
            all_spans.append({
                "ref": span_ref(rec["span"], pid),
                "parent": span_ref(rec.get("parent"), pid),
                "pid": pid, "tid": rec["tid"],
                "thread": rec.get("thread"),
                "name": rec["name"],
                "ts": wall0 + float(rec["t0_s"]),
                "dur": float(rec.get("dur_s") or 0.0),
                "attrs": rec.get("attrs", {}),
            })
        for rec in lg["events"]:
            all_events.append({
                "ref": span_ref(rec.get("span"), pid),
                "pid": pid, "tid": rec["tid"], "name": rec["name"],
                "ts": wall0 + float(rec["t_s"]),
                "attrs": rec.get("attrs", {}),
            })
    if not all_spans and not all_events:
        raise ValueError("nothing to merge: every run log was empty")
    t_min = min([s["ts"] for s in all_spans]
                + [e["ts"] for e in all_events])

    by_ref = {s["ref"]: s for s in all_spans}

    # -- request connectivity -------------------------------------------------
    request_spans: Dict[str, List[dict]] = {}
    for s in all_spans:
        for rid in _span_request_ids(s["attrs"]):
            request_spans.setdefault(rid, []).append(s)

    def ancestor_in(span: dict, member: set) -> Optional[str]:
        """Walk parent + remote_parent links up; first ancestor ref that
        is in `member` (connectivity may pass through unrelated spans)."""
        seen = set()
        cur = span
        while True:
            nxt = cur["parent"] or cur["attrs"].get("remote_parent")
            if not nxt or nxt in seen:
                return None
            seen.add(nxt)
            if nxt in member:
                return nxt
            cur = by_ref.get(nxt)
            if cur is None:
                return None

    requests: Dict[str, dict] = {}
    flows: List[dict] = []
    for rid, spans in sorted(request_spans.items()):
        member = {s["ref"] for s in spans}
        uf = _Union()
        for s in spans:
            uf.find(s["ref"])
            anc = ancestor_in(s, member)
            if anc:
                uf.union(s["ref"], anc)
        # asynchronous same-process hops (serve_request -> online_update)
        # chain by start time within each pid
        by_pid: Dict[int, List[dict]] = {}
        for s in spans:
            by_pid.setdefault(s["pid"], []).append(s)
        for pid_spans in by_pid.values():
            pid_spans.sort(key=lambda s: s["ts"])
            for a, b in zip(pid_spans, pid_spans[1:]):
                uf.union(a["ref"], b["ref"])
        roots = {uf.find(s["ref"]) for s in spans}
        requests[rid] = {
            "spans": len(spans),
            "processes": sorted({s["pid"] for s in spans}),
            "span_names": sorted({s["name"] for s in spans}),
            "connected": len(roots) == 1,
        }
        # flow events: one chain per request, ordered by aligned time,
        # so Perfetto draws the request crossing processes
        chain = sorted(spans, key=lambda s: s["ts"])
        if len(chain) >= 2:
            for i, s in enumerate(chain):
                ph = "s" if i == 0 else ("f" if i == len(chain) - 1
                                         else "t")
                flow = {"name": f"req:{rid}", "cat": "photon-flow",
                        "ph": ph, "id": int(rid[:8], 16),
                        "pid": s["pid"], "tid": s["tid"],
                        "ts": round((s["ts"] - t_min) * 1e6, 3)}
                if ph == "f":
                    flow["bp"] = "e"
                flows.append(flow)

    # -- containment: synchronous cross-process children inside parents ------
    checked = 0
    violations: List[dict] = []
    for s in all_spans:
        rp = s["attrs"].get("remote_parent")
        if not rp:
            continue
        parent = by_ref.get(rp)
        if parent is None or not str(parent["name"]).startswith("front_"):
            continue  # async links (log replay) are not containment-bound
        checked += 1
        lo = parent["ts"] - containment_slack_s
        hi = parent["ts"] + parent["dur"] + containment_slack_s
        if s["ts"] < lo or s["ts"] + s["dur"] > hi:
            violations.append({
                "child": s["ref"], "child_name": s["name"],
                "parent": rp, "parent_name": parent["name"],
                "child_window": [round(s["ts"] - t_min, 6),
                                 round(s["ts"] + s["dur"] - t_min, 6)],
                "parent_window": [round(parent["ts"] - t_min, 6),
                                  round(parent["ts"] + parent["dur"]
                                        - t_min, 6)],
            })

    # -- chrome events --------------------------------------------------------
    events: List[dict] = []
    for p in procs:
        events.append({"name": "process_name", "ph": "M", "ts": 0,
                       "pid": p["pid"], "tid": 0,
                       "args": {"name": f"{p['proc']} ({p['pid']})"}})
    threads_seen: Dict[Tuple[int, object], Optional[str]] = {}
    for s in all_spans:
        threads_seen.setdefault((s["pid"], s["tid"]), s["thread"])
        events.append({
            "name": s["name"], "cat": "photon", "ph": "X",
            "ts": round((s["ts"] - t_min) * 1e6, 3),
            "dur": round(max(s["dur"], 0.0) * 1e6, 3),
            "pid": s["pid"], "tid": s["tid"],
            "args": {"span": s["ref"], "parent": s["parent"],
                     **s["attrs"]},
        })
    for e in all_events:
        threads_seen.setdefault((e["pid"], e["tid"]), None)
        events.append({
            "name": e["name"], "cat": "photon", "ph": "i", "s": "t",
            "ts": round((e["ts"] - t_min) * 1e6, 3),
            "pid": e["pid"], "tid": e["tid"],
            "args": {"span": e["ref"], **e["attrs"]},
        })
    events.extend(flows)
    for (pid, tid), name in sorted(threads_seen.items(),
                                   key=lambda kv: (kv[0][0], str(kv[0][1]))):
        if name:
            events.append({"name": "thread_name", "ph": "M", "ts": 0,
                           "pid": pid, "tid": tid, "args": {"name": name}})

    payload = {"traceEvents": events, "displayTimeUnit": "ms",
               "otherData": {"producer": "photon_ml_tpu_torch.telemetry."
                                         "distributed",
                             "t_min_unix_s": t_min,
                             "processes": [
                                 {k: p[k] for k in ("pid", "proc",
                                                    "offset_s")}
                                 for p in procs]}}
    problems = validate_chrome_trace(payload)
    if out_path is not None:
        d = os.path.dirname(os.path.abspath(out_path))
        os.makedirs(d, exist_ok=True)
        tmp = out_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f, separators=(",", ":"))
        os.replace(tmp, out_path)

    return {
        "path": out_path,
        "processes": procs,
        "spans": len(all_spans),
        "events": len(all_events),
        "flow_events": len(flows),
        "requests": requests,
        "connected_ok": (all(r["connected"] for r in requests.values())
                         if requests else False),
        "containment": {"checked": checked,
                        "slack_s": containment_slack_s,
                        "violations": violations,
                        "ok": checked > 0 and not violations},
        "clock_offsets": {str(pid): {"offset_s": off, "rtt_s": rtt}
                          for pid, (off, rtt) in sorted(offsets.items())},
        "problems": problems,
        "trace": payload,
    }
