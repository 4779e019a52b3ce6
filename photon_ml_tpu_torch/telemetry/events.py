"""The telemetry event vocabulary: one constant per operational anomaly
source (a copy of photon_ml_tpu/telemetry/events.py).

Operators grep traces, run logs, and flight-recorder bundles by event
name; nothing rots a postmortem workflow faster than a fault site or dump
trigger whose events quietly renamed (or never existed).  This registry
pins the vocabulary: EVERY name in `utils.faults.SITES` and EVERY
registered flight-recorder trigger (`telemetry.flight.TRIGGERS`) must
have an entry here, mapping the registry name to the telemetry event
name its firing emits.  tests/port/test_torch_telemetry.py diffs the
three registries — a new fault site or trigger cannot land without
declaring its event surface, and a stale entry here fails the same check.

Fault sites all surface through the single `fault` instant event (with a
`site` attr — `utils.faults.FaultPlan.fire` emits it), so their entries
map to "fault".  Flight triggers surface through `flight_dump` (with a
`reason` attr).  The mapping is still per-name on purpose: the registry
diff is what the test checks, and a future site/trigger that wants its own
event name simply maps to it here.
"""
from __future__ import annotations

from typing import Dict

#: registry name -> telemetry event name emitted when it fires
EVENTS: Dict[str, str] = {
    # -- fault sites (utils.faults.SITES -> the `fault` instant event) ----
    "stage.fetch": "fault",
    "stage.transfer": "fault",
    "mesh.stage": "fault",
    "admm.stage": "fault",
    "checkpoint.write": "fault",
    "checkpoint.fsync": "fault",
    "model.save": "fault",
    "model.load": "fault",
    "solve.poison": "fault",
    "solve.local": "fault",
    "online.solve": "fault",
    "online.publish": "fault",
    "health.evaluate": "fault",
    "replog.append": "fault",
    "replog.read": "fault",
    "replica.apply": "fault",
    "store.fetch": "fault",
    "store.promote": "fault",
    "store.spill": "fault",
    "refit.compact": "fault",
    "refit.validate": "fault",
    "refit.swap": "fault",
    "shard.route": "fault",
    "shard.merge": "fault",
    "shard.catchup": "fault",
    # -- flight-recorder triggers (telemetry.flight.TRIGGERS ->
    #    the `flight_dump` instant event) --------------------------------
    "health.gate_trip": "flight_dump",
    "replica.failed": "flight_dump",
    "replica.unhealthy": "flight_dump",
    "model.rollback": "flight_dump",
    "serve.drain": "flight_dump",
    "serve.crash": "flight_dump",
    "shard.lost": "flight_dump",
}
