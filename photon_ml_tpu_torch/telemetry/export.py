"""Telemetry exporters: Chrome-trace/Perfetto JSON and Prometheus text (a
copy of photon_ml_tpu/telemetry/export.py).

Chrome trace (the `--trace-out trace.json` format on cli.train): the Trace Event Format's JSON-object form — `{"traceEvents":
[...]}` with complete ("X") events for spans and instant ("i") events for
point records.  Every event carries the format's required keys (`name`,
`ph`, `ts`, `pid`, `tid`; `dur` on "X") plus `args.span`/`args.parent` so
the span tree is validatable without reconstructing it from timestamps.
Open a trace at https://ui.perfetto.dev (drag the file in) or
chrome://tracing.

Prometheus text (the serving `/metrics` endpoint, cli/serve.py):
exposition format 0.0.4.  Counters render as `photon_<name>_total`, gauges as
`photon_<name>`, histograms as summaries (`{quantile="..."}` series plus
`_sum`/`_count`) — quantiles come from the registry's bounded reservoir,
so a scrape is O(reservoir), never O(requests).
"""
from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional

from photon_ml_tpu_torch.telemetry.core import Tracer
from photon_ml_tpu_torch.telemetry.metrics import MetricsRegistry

#: keys the Trace Event Format requires on every event (+ "dur" for "X")
CHROME_REQUIRED_KEYS = ("name", "ph", "ts", "pid", "tid")


def chrome_trace_events(tracer: Tracer) -> List[dict]:
    """Tracer records -> trace-event dicts (µs timestamps, one pid)."""
    pid = os.getpid()
    out: List[dict] = []
    threads = {}
    now = tracer.now()
    for record in list(tracer.spans):
        threads.setdefault(record.tid, record.thread_name)
        dur = record.dur_s if record.dur_s is not None else now - record.t0
        out.append({
            "name": record.name, "cat": "photon", "ph": "X",
            "ts": round(record.t0 * 1e6, 3),
            "dur": round(max(dur, 0.0) * 1e6, 3),
            "pid": pid, "tid": record.tid,
            "args": {"span": record.span_id, "parent": record.parent_id,
                     **record.attrs},
        })
    for record in list(tracer.events):
        threads.setdefault(record["tid"], None)
        out.append({
            "name": record["name"], "cat": "photon", "ph": "i", "s": "t",
            "ts": round(record["t_s"] * 1e6, 3),
            "pid": pid, "tid": record["tid"],
            "args": {"span": record["span"], **record["attrs"]},
        })
    # thread-name metadata rows make the Perfetto tracks self-describing
    for tid, name in sorted(threads.items(), key=lambda kv: str(kv[0])):
        if name:
            out.append({"name": "thread_name", "ph": "M", "ts": 0,
                        "pid": pid, "tid": tid, "args": {"name": name}})
    return out


def write_chrome_trace(tracer: Tracer, path: str) -> dict:
    """Write the trace JSON (atomically — a kill mid-export must not leave
    a torn half-file that Perfetto rejects with an opaque parse error).
    Returns summary stats."""
    events = chrome_trace_events(tracer)
    payload = {"traceEvents": events, "displayTimeUnit": "ms",
               "otherData": {"producer": "photon_ml_tpu_torch.telemetry",
                             "wall0_unix_s": tracer._wall0}}
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(payload, f, separators=(",", ":"))
    os.replace(tmp, path)
    return {"path": path, "events": len(events),
            "spans": len(tracer.spans), "instants": len(tracer.events),
            "dropped": tracer.dropped}


def validate_chrome_trace(payload: dict) -> List[str]:
    """Problems with a trace dict against the format's required keys
    (empty list = valid).  Used by the tests and the card's smoke script
    rather than trusting the writer to have stayed honest."""
    problems: List[str] = []
    events = payload.get("traceEvents")
    if not isinstance(events, list) or not events:
        return ["traceEvents missing or empty"]
    for i, ev in enumerate(events):
        for key in CHROME_REQUIRED_KEYS:
            if key not in ev:
                problems.append(f"event {i} ({ev.get('name')!r}) missing "
                                f"required key {key!r}")
        if ev.get("ph") == "X" and "dur" not in ev:
            problems.append(f"complete event {i} ({ev.get('name')!r}) "
                            "missing 'dur'")
    return problems


# -- Prometheus text exposition ------------------------------------------------

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name: str) -> str:
    return "photon_" + _NAME_RE.sub("_", name)


def _prom_value(v) -> str:
    if v is None:
        return "NaN"
    return repr(float(v)) if isinstance(v, float) else str(v)


def _esc_label(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"')


def _label_str(labels: Optional[Dict[str, str]],
               extra: Optional[Dict[str, str]] = None) -> str:
    """{k: v} -> '{k="v",...}' (empty string for no labels)."""
    merged: Dict[str, str] = {}
    merged.update(labels or {})
    merged.update(extra or {})
    if not merged:
        return ""
    inner = ",".join(f'{_NAME_RE.sub("_", k)}="{_esc_label(v)}"'
                     for k, v in sorted(merged.items()))
    return "{" + inner + "}"


def _parse_label_key(key: str) -> Dict[str, str]:
    """A LabeledCounter snapshot key ('k=v,k2=v2') -> {k: v}.  Splits on
    ',' then the FIRST '=' per segment — label values (replica URLs) may
    contain '=' but never ','."""
    out: Dict[str, str] = {}
    for seg in key.split(","):
        k, _, v = seg.partition("=")
        out[k] = v
    return out


def render_prometheus_snapshot(snap: Dict[str, Dict],
                               lines: List[str],
                               labels: Optional[Dict[str, str]] = None,
                               seen_types: Optional[set] = None) -> None:
    """One registry SNAPSHOT -> exposition lines, every series stamped
    with the constant `labels` (the federated surface's per-replica
    `instance` label).  `seen_types` dedups `# TYPE` headers when several
    snapshots of the same instrument family render into one page."""
    seen = seen_types if seen_types is not None else set()

    def typ(p: str, kind: str) -> None:
        if p not in seen:
            seen.add(p)
            lines.append(f"# TYPE {p} {kind}")

    lab = _label_str(labels)
    for name, value in snap.get("counters", {}).items():
        p = _prom_name(name) + "_total"
        typ(p, "counter")
        lines.append(f"{p}{lab} {_prom_value(value)}")
    for name, value in snap.get("gauges", {}).items():
        p = _prom_name(name)
        typ(p, "gauge")
        lines.append(f"{p}{lab} {_prom_value(value)}")
    for name, series in snap.get("labeled", {}).items():
        p = _prom_name(name) + "_total"
        typ(p, "counter")
        if not series:
            # a registered family with no observed series still exposes
            # one zero sample, so scrapers (and the JSON/Prometheus
            # parity contract) see the instrument before first use
            lines.append(f"{p}{lab} 0")
        for key, value in sorted(series.items()):
            lines.append(f"{p}{_label_str(labels, _parse_label_key(key))} "
                         f"{_prom_value(value)}")
    for name, h in snap.get("histograms", {}).items():
        p = _prom_name(name)
        typ(p, "summary")
        for q, key in ((0.5, "p50"), (0.9, "p90"), (0.95, "p95"),
                       (0.99, "p99")):
            lines.append(f"{p}{_label_str(labels, {'quantile': str(q)})} "
                         f"{_prom_value(h[key])}")
        lines.append(f"{p}_sum{lab} {_prom_value(h['sum'])}")
        lines.append(f"{p}_count{lab} {h['count']}")
        if h["max"] is not None:
            typ(f"{p}_max", "gauge")
            lines.append(f"{p}_max{lab} {_prom_value(h['max'])}")


def prometheus_text(registry: MetricsRegistry,
                    extra_info: Optional[Dict[str, str]] = None,
                    labels: Optional[Dict[str, str]] = None) -> str:
    """Registry -> Prometheus exposition text (version 0.0.4).
    `extra_info` renders as a `photon_info{k="v",...} 1` series (the
    conventional carrier for e.g. the serving model version);
    `labels` stamps every series (the federated surface's instance
    label)."""
    lines: List[str] = []
    render_prometheus_snapshot(registry.snapshot(), lines, labels=labels)
    if extra_info:
        lines.append("# TYPE photon_info gauge")
        lines.append(f"photon_info{_label_str(extra_info)} 1")
    return "\n".join(lines) + "\n"
