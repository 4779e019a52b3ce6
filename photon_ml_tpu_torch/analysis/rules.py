"""photonlint rule catalog (PH001–PH014), a copy of the JAX package's.

Each rule is a class with an `rule_id`, a one-line `summary` (the `--list-
rules` catalog), and `check(ctx) -> Iterable[Finding]` over an
`engine.ModuleContext`.  Adding a rule = adding a class here and listing
it in `all_rules()`; fixtures under tests/port/lint_fixtures/ demonstrate
one violation and one compliant near-miss per torch rule.

PH004, PH005, PH007, PH008 and PH014 keep the JAX package's logic and
messages.  PH001, PH002, PH003 and PH006 keep their ids and take the torch
meaning of their JAX intent:

  PH001  torch's host syncs in hot-path modules outside flush points.
  PH002  a build or graph capture at call time: `torch.compile`,
         `torch.jit.*`, CUDA-graph capture, or `_build.load_library`
         with a non-literal name (an nvcc build per distinct name).
  PH003  a read after a hand-off: an alias taken before its buffer was
         passed as `out=`, or a Prefetcher chunk read after its `.stream()`
         loop moved on (its staging-ring slot was released).
  PH006  time.*/random.* inside a graph capture (a torch.compile /
         torch.jit-wrapped function or a `with torch.cuda.graph(...)`
         body).  The port captures no graph, so on the port it finds
         nothing; it guards the first capture.

PH010–PH013 are PROGRAM rules (`program_rule = True`,
`check_program(ProgramContext)`): the concurrency pass in
`analysis/concurrency.py` needs the whole package at once — a call graph,
thread roots, and the lock-acquisition-order graph are interprocedural by
nature.  `engine.lint_paths` runs them after the per-module rules.

Precision over recall: every check is anchored to the module semantics the
engine resolved (import aliases, capture forms, device-value tracking), so
a finding is worth reading.  What a rule cannot see statically (values
flowing through unannotated call results, tensors held in attributes) it
stays silent on — the launch counts and parity gates remain the backstop
for those.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set

from photon_ml_tpu_torch.analysis.engine import (
    COMPILE_ORIGINS, GRAPH_CAPTURE_ORIGINS, DeviceTracker, Finding,
    ModuleContext, comprehension_device_names, host_sync,
)


class Rule:
    rule_id = "PH000"
    name = "rule"
    summary = ""

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        raise NotImplementedError


def _contained_defs(root) -> Set[ast.AST]:
    """All function defs lexically inside `root` (including root)."""
    return {n for n in ast.walk(root)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda))}


# -- PH001: host sync in hot-path modules -------------------------------------

class HostSyncRule(Rule):
    rule_id = "PH001"
    name = "host-sync"
    summary = (".item()/.tolist()/.cpu()/.numpy()/.to('cpu'), float()/"
               "int()/bool()/np.asarray/range() on a device value, "
               "torch.cuda.synchronize() and stream/event .synchronize() "
               "in hot-path modules outside flush points")

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        if not ctx.is_hot_path:
            return []
        findings: List[Finding] = []
        skip: Set[ast.AST] = set()
        for fn in ctx.function_defs:
            if ctx.flush_point(fn):
                skip |= _contained_defs(fn)

        def scan_scope(body, seed_fn=None):
            tracker = DeviceTracker(ctx)
            if seed_fn is not None:
                tracker.seed_params(seed_fn)

            def on_expr(expr):
                extra = comprehension_device_names(tracker, expr) \
                    if isinstance(expr, (ast.GeneratorExp, ast.ListComp,
                                         ast.SetComp, ast.DictComp)) else set()
                added = extra - tracker.device
                tracker.device |= added
                try:
                    for node in ast.walk(expr):
                        if isinstance(node, (ast.GeneratorExp, ast.ListComp,
                                             ast.SetComp, ast.DictComp)) \
                                and node is not expr:
                            on_expr(node)
                            continue
                        if isinstance(node, ast.Call):
                            reason = host_sync(ctx, tracker, node)
                            if reason is not None:
                                findings.append(ctx.finding(
                                    self.rule_id, node,
                                    f"{reason} — defer it to the "
                                    "iteration's batched flush point (mark "
                                    "a designed read-back `# photonlint: "
                                    "flush-point`)"))
                finally:
                    tracker.device -= added

            tracker.walk(body, on_expr)

        scan_scope(ctx.tree.body)
        for fn in ctx.function_defs:
            if fn in skip:
                continue
            scan_scope(fn.body, seed_fn=fn)
        return findings


# -- PH002: builds and graph captures at call time ----------------------------

class RetraceHazardRule(Rule):
    rule_id = "PH002"
    name = "retrace-hazard"
    summary = ("a build or graph capture at call time: torch.compile / "
               "torch.jit.* / CUDA-graph capture, or _build.load_library "
               "with a non-literal name — a warm call must build nothing")

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        findings: List[Finding] = []
        decorators: Set[ast.AST] = set()
        for fn in ctx.function_defs:
            for dec in fn.decorator_list:
                origin = ctx.compile_origin(dec)
                if origin is None:
                    continue
                decorators |= set(ast.walk(dec))
                findings.append(ctx.finding(
                    self.rule_id, dec,
                    f"@{origin} compiles `{fn.name}` at its first call and "
                    "again for every new shape, dtype or guard it meets — "
                    "the port captures no graph (hand kernels, one launch "
                    "each); a warm call must build nothing"))
        for node in ctx.nodes:
            if not isinstance(node, ast.Call) or node in decorators:
                continue
            origin = ctx.resolve(node.func)
            if origin is None:
                continue
            if origin in COMPILE_ORIGINS or origin in GRAPH_CAPTURE_ORIGINS:
                findings.append(ctx.finding(
                    self.rule_id, node,
                    f"{origin}() builds or captures a graph at call time — "
                    "the port captures no graph (hand kernels, one launch "
                    "each); a warm call must build nothing"))
            elif origin.endswith("_build.load_library") and not (
                    node.args and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                findings.append(ctx.finding(
                    self.rule_id, node,
                    "_build.load_library() with a non-literal name — each "
                    "distinct name is an nvcc build and a library load at "
                    "call time; name the kernel with a string literal"))
        return findings


# -- PH003: reads after a hand-off --------------------------------------------

#: tensor methods that return a view of their operand (an alias)
_VIEW_METHODS = {"view", "view_as", "reshape", "detach", "narrow", "select",
                 "squeeze", "unsqueeze", "flatten", "unflatten", "expand",
                 "expand_as", "transpose", "t", "permute", "as_strided",
                 "unfold", "diagonal", "movedim", "split", "chunk",
                 "unbind"}


class HandOffRule(Rule):
    rule_id = "PH003"
    name = "hand-off"
    summary = ("read of a buffer after its hand-off: an alias taken before "
               "the buffer was passed as `out=` (its storage now holds the "
               "call's result), or a chunk of a Prefetcher `.stream()` loop "
               "read after the loop moved on (its staging-ring slot was "
               "released and may be rewritten)")

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        findings: List[Finding] = []
        self._scan_scope(ctx, ctx.tree.body, findings)
        for fn in ctx.function_defs:
            self._scan_scope(ctx, fn.body, findings)
        return findings

    @staticmethod
    def _alias_base(expr) -> Optional[str]:
        """The name `expr` is a view of: `b`, `b[...]`, `b.T`,
        `b.view(...)` and the other view methods."""
        while True:
            if isinstance(expr, ast.Name):
                return expr.id
            if isinstance(expr, ast.Subscript):
                expr = expr.value
            elif isinstance(expr, ast.Attribute) and expr.attr in ("T", "mT"):
                expr = expr.value
            elif isinstance(expr, ast.Call) \
                    and isinstance(expr.func, ast.Attribute) \
                    and expr.func.attr in _VIEW_METHODS:
                expr = expr.func.value
            else:
                return None

    @staticmethod
    def _stream_loop(stmt) -> bool:
        it = stmt.iter
        return (isinstance(it, ast.Call) and isinstance(it.func, ast.Attribute)
                and it.func.attr == "stream")

    def _scan_scope(self, ctx, body, findings) -> None:
        handed: Dict[str, str] = {}   # name -> what it was handed to
        aliases: Dict[str, str] = {}  # alias -> the name it views

        def scan_expr(expr):
            for node in ast.iter_child_nodes(expr):
                scan_expr(node)
            if isinstance(expr, ast.Name) and isinstance(expr.ctx, ast.Load) \
                    and expr.id in handed:
                findings.append(ctx.finding(
                    self.rule_id, expr,
                    f"`{expr.id}` is read after its hand-off to "
                    f"{handed[expr.id]} — copy it (`.clone()`) before the "
                    "hand-off or rebind before reuse"))
                del handed[expr.id]  # one finding per hand-off
            elif isinstance(expr, ast.Call):
                for kw in expr.keywords:
                    if kw.arg == "out" and isinstance(kw.value, ast.Name):
                        base = kw.value.id
                        callee = (ctx.resolve(expr.func)
                                  or getattr(expr.func, "attr", None)
                                  or getattr(expr.func, "id", "a call"))
                        for a, b in aliases.items():
                            if b == base:
                                handed[a] = (f"`{callee}` (out={base}): "
                                             "the storage it views was "
                                             "overwritten")

        def rebind(target):
            for n in ast.walk(target):
                if isinstance(n, ast.Name):
                    handed.pop(n.id, None)
                    aliases.pop(n.id, None)

        def scan_stmt(stmt):
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                return
            if isinstance(stmt, ast.Assign):
                scan_expr(stmt.value)
                for tgt in stmt.targets:
                    rebind(tgt)
                base = self._alias_base(stmt.value)
                if base is not None and len(stmt.targets) == 1 \
                        and isinstance(stmt.targets[0], ast.Name) \
                        and stmt.targets[0].id != base:
                    aliases[stmt.targets[0].id] = aliases.get(base, base)
                return
            if isinstance(stmt, ast.AugAssign):
                scan_expr(stmt.value)
                tgt = stmt.target
                # x += 1 reads x (flag) and writes it in place
                if isinstance(tgt, ast.Name) and tgt.id in handed:
                    findings.append(ctx.finding(
                        self.rule_id, tgt,
                        f"`{tgt.id}` is read after its hand-off to "
                        f"{handed.pop(tgt.id)}"))
                return
            if isinstance(stmt, ast.For):
                scan_expr(stmt.iter)
                rebind(stmt.target)
                for s in stmt.body:
                    scan_stmt(s)
                if self._stream_loop(stmt):
                    chunk = {n.id for n in ast.walk(stmt.target)
                             if isinstance(n, ast.Name)}
                    for s in ast.walk(ast.Module(body=stmt.body,
                                                 type_ignores=[])):
                        if isinstance(s, ast.Assign) \
                                and self._alias_base(s.value) in chunk:
                            chunk |= {n.id for t in s.targets
                                      for n in ast.walk(t)
                                      if isinstance(n, ast.Name)}
                    for name in chunk:
                        handed[name] = ("the staging ring: the Prefetcher "
                                        "released its slot when the "
                                        "`.stream()` loop moved on")
                for s in stmt.orelse:
                    scan_stmt(s)
                return
            for child_expr in self._stmt_exprs(stmt):
                scan_expr(child_expr)
            for child_body in self._stmt_bodies(stmt):
                for s in child_body:
                    scan_stmt(s)

        for stmt in body:
            scan_stmt(stmt)

    @staticmethod
    def _stmt_exprs(stmt):
        if isinstance(stmt, (ast.Return, ast.Expr)) and stmt.value:
            yield stmt.value
        elif isinstance(stmt, (ast.If, ast.While)):
            yield stmt.test
        elif isinstance(stmt, ast.With):
            for item in stmt.items:
                yield item.context_expr
        elif isinstance(stmt, ast.AnnAssign) and stmt.value:
            yield stmt.value
        elif isinstance(stmt, ast.Raise) and stmt.exc:
            yield stmt.exc

    @staticmethod
    def _stmt_bodies(stmt):
        for field in ("body", "orelse", "finalbody"):
            b = getattr(stmt, field, None)
            if isinstance(b, list):
                yield b
        for h in getattr(stmt, "handlers", ()):
            yield h.body


# -- PH004: fault-site discipline ---------------------------------------------

class FaultSiteRule(Rule):
    rule_id = "PH004"
    name = "fault-site"
    summary = ("faults.fire() sites must be string literals declared in "
               "utils.faults.SITES with declared context keys; the "
               "registry must match the module docs")

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        findings: List[Finding] = []
        registry = getattr(ctx, "sites_registry", {})
        for node in ctx.nodes:
            if not isinstance(node, ast.Call):
                continue
            origin = ctx.resolve(node.func)
            if origin is None or not (origin.endswith(".faults.fire")
                                      or origin == "faults.fire"):
                continue
            if not node.args:
                continue
            site_arg = node.args[0]
            if not (isinstance(site_arg, ast.Constant)
                    and isinstance(site_arg.value, str)):
                findings.append(ctx.finding(
                    self.rule_id, site_arg,
                    "dynamic fault-site name — sites must be string "
                    "literals so injection plans, docs, and greps agree"))
                continue
            site = site_arg.value
            if registry and site not in registry:
                known = ", ".join(sorted(registry))
                findings.append(ctx.finding(
                    self.rule_id, site_arg,
                    f"undeclared fault site {site!r} — declare it in "
                    f"utils.faults.SITES (known: {known})"))
                continue
            declared = set(registry.get(site, ()))
            for kw in node.keywords:
                if kw.arg is not None and registry \
                        and kw.arg not in declared:
                    findings.append(ctx.finding(
                        self.rule_id, kw.value,
                        f"context key {kw.arg!r} is not declared for "
                        f"site {site!r} in utils.faults.SITES "
                        f"(declared: {sorted(declared)}) — injection "
                        "specs matching on it would silently never fire"))
        findings.extend(self._check_registry_docs(ctx, registry))
        return findings

    def _check_registry_docs(self, ctx, registry) -> List[Finding]:
        """When linting the registry module itself: every declared site
        must appear in the module docstring (the operator-facing doc)."""
        if ctx.path != getattr(ctx, "sites_registry_path", None):
            return []
        doc = ast.get_docstring(ctx.tree) or ""
        sites_node = next(
            (n for n in ctx.tree.body
             if isinstance(n, (ast.Assign, ast.AnnAssign))
             and any(isinstance(t, ast.Name) and t.id == "SITES"
                     for t in (n.targets if isinstance(n, ast.Assign)
                               else [n.target]))), None)
        if sites_node is None:
            return []
        missing = sorted(s for s in registry if s not in doc)
        if not missing:
            return []
        return [ctx.finding(
            self.rule_id, sites_node,
            f"SITES entries missing from the module docstring: "
            f"{', '.join(missing)} — the registry and the docs must "
            "agree")]


# -- PH005: durable writes ----------------------------------------------------

class DurableWriteRule(Rule):
    rule_id = "PH005"
    name = "durable-write"
    summary = ("checkpoint/model-io modules must write through "
               "utils.durable atomic+fsync helpers, never bare "
               "open(..., 'w')/json.dump")

    _WRITE_MODES = ("w", "a", "x")

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        if not ctx.is_durable_module or ctx.is_durable_impl:
            return []
        findings: List[Finding] = []
        for node in ctx.nodes:
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Name) and node.func.id == "open" \
                    and node.func.id not in ctx.names:
                mode = None
                if len(node.args) >= 2 and isinstance(node.args[1],
                                                      ast.Constant):
                    mode = node.args[1].value
                for kw in node.keywords:
                    if kw.arg == "mode" and isinstance(kw.value,
                                                       ast.Constant):
                        mode = kw.value.value
                if isinstance(mode, str) and mode.startswith(
                        self._WRITE_MODES):
                    findings.append(ctx.finding(
                        self.rule_id, node,
                        f"bare open(..., {mode!r}) in a durable module — "
                        "a crash mid-write tears the file; use "
                        "utils.durable.atomic_write_text/_json/"
                        "write_marker"))
                continue
            origin = ctx.resolve(node.func)
            if origin == "json.dump":
                findings.append(ctx.finding(
                    self.rule_id, node,
                    "bare json.dump in a durable module — use "
                    "utils.durable.atomic_write_json (tmp + fsync + "
                    "atomic replace)"))
        return findings


# -- PH006: nondeterminism inside a graph capture -----------------------------

class NondeterminismRule(Rule):
    rule_id = "PH006"
    name = "nondeterminism"
    summary = ("time.*/random.*/np.random.* inside a graph capture (a "
               "torch.compile / torch.jit-wrapped function or a `with "
               "torch.cuda.graph(...)` body) — captured once, replayed "
               "frozen; the port captures none, so this guards the first")

    _TIME = {"time.time", "time.perf_counter", "time.monotonic",
             "time.time_ns", "time.perf_counter_ns",
             "datetime.datetime.now", "datetime.datetime.utcnow"}

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        findings: List[Finding] = []
        seen: Set[ast.AST] = set()
        for region in [*ctx.traced_defs, *ctx.capture_withs]:
            for node in ast.walk(region):
                if not isinstance(node, ast.Call) or node in seen:
                    continue
                seen.add(node)
                origin = ctx.resolve(node.func)
                if origin is None:
                    continue
                if origin in self._TIME:
                    findings.append(ctx.finding(
                        self.rule_id, node,
                        f"{origin}() inside a graph capture — the value "
                        "freezes at capture time; take timestamps on the "
                        "host around the replayed call"))
                elif origin.startswith(("random.", "numpy.random.")):
                    findings.append(ctx.finding(
                        self.rule_id, node,
                        f"{origin}() inside a graph capture — host RNG "
                        "freezes at capture time and breaks parity-gated "
                        "reproducibility; pass the draw in, or draw with "
                        "torch's generator on the device"))
        return findings


# -- PH007: raw span timing in hot-path modules -------------------------------

class RawTimerRule(Rule):
    rule_id = "PH007"
    name = "raw-timer"
    summary = ("raw time.perf_counter() span timing in hot-path modules — "
               "route through telemetry (PhaseTimings.span/blocked or "
               "telemetry.timings.clock) so every phase lands in ONE "
               "trace, not a private stopwatch")

    _TIMERS = ("time.perf_counter", "time.perf_counter_ns")

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        # telemetry/ is the sanctioned implementation and is not a
        # hot-path directory, so it is exempt by scoping
        if not ctx.is_hot_path:
            return []
        findings: List[Finding] = []
        for node in ctx.nodes:
            if not isinstance(node, ast.Call):
                continue
            origin = ctx.resolve(node.func)
            if origin in self._TIMERS:
                findings.append(ctx.finding(
                    self.rule_id, node,
                    f"{origin}() span timing in a hot-path module — time "
                    "phases through telemetry (PhaseTimings.span / "
                    ".blocked, or telemetry.timings.clock) so the span "
                    "lands in the unified trace instead of a bespoke "
                    "counter the bench can't correlate"))
        return findings


# -- PH008: telemetry event-registry drift ------------------------------------

class EventRegistryRule(Rule):
    rule_id = "PH008"
    name = "event-registry"
    summary = ("every utils.faults.SITES name and telemetry.flight."
               "TRIGGERS name needs a telemetry event constant in "
               "telemetry/events.py (and vice versa — stale entries "
               "fail too); flight.trigger() reasons must be literal "
               "registered names")

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        findings: List[Finding] = []
        events = getattr(ctx, "events_registry", {}) or {}
        triggers = getattr(ctx, "triggers_registry", {}) or {}
        sites = getattr(ctx, "sites_registry", {}) or {}
        # registry diffs are reported ON the registry modules, so the
        # finding lands where the fix goes
        if ctx.path == getattr(ctx, "sites_registry_path", None):
            findings.extend(self._registry_diff(
                ctx, "SITES", set(sites) - set(events)))
        if ctx.path == getattr(ctx, "triggers_registry_path", None):
            findings.extend(self._registry_diff(
                ctx, "TRIGGERS", set(triggers) - set(events)))
        if ctx.path == getattr(ctx, "events_registry_path", None):
            stale = set(events) - set(sites) - set(triggers)
            if stale:
                node = self._dict_node(ctx, "EVENTS")
                if node is not None:
                    findings.append(ctx.finding(
                        self.rule_id, node,
                        f"stale telemetry event constant(s) "
                        f"{sorted(stale)}: no fault site or flight "
                        "trigger of that name exists — remove them (or "
                        "register the site/trigger)"))
        findings.extend(self._check_trigger_calls(ctx, triggers))
        return findings

    @staticmethod
    def _dict_node(ctx, var_name: str):
        for node in ctx.tree.body:
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target]
                       if isinstance(node, ast.AnnAssign) else [])
            if any(isinstance(t, ast.Name) and t.id == var_name
                   for t in targets):
                return node
        return None

    def _registry_diff(self, ctx, var_name: str, missing) -> List[Finding]:
        if not missing:
            return []
        node = self._dict_node(ctx, var_name)
        if node is None:
            return []
        return [ctx.finding(
            self.rule_id, node,
            f"{var_name} name(s) {sorted(missing)} have no telemetry "
            "event constant — operators grep traces and flight bundles "
            "by event name, so declare each in telemetry/events.py "
            "EVENTS before the registry entry lands")]

    def _check_trigger_calls(self, ctx, triggers) -> List[Finding]:
        findings: List[Finding] = []
        for node in ctx.nodes:
            if not isinstance(node, ast.Call):
                continue
            origin = ctx.resolve(node.func)
            if origin is None or not (origin.endswith(".flight.trigger")
                                      or origin == "flight.trigger"):
                continue
            if not node.args:
                continue
            reason = node.args[0]
            if not (isinstance(reason, ast.Constant)
                    and isinstance(reason.value, str)):
                findings.append(ctx.finding(
                    self.rule_id, reason,
                    "dynamic flight-trigger reason — triggers must be "
                    "string literals registered in telemetry.flight."
                    "TRIGGERS so the dump taxonomy, docs, and greps "
                    "agree (suppress forwarding sites that re-fire an "
                    "already-validated reason)"))
                continue
            if triggers and reason.value not in triggers:
                findings.append(ctx.finding(
                    self.rule_id, reason,
                    f"unregistered flight trigger {reason.value!r} — "
                    "declare it in telemetry.flight.TRIGGERS (known: "
                    f"{', '.join(sorted(triggers))})"))
        return findings


# -- PH014: multi-writer discipline in multi-process modules ------------------

class MultiprocessWriteRule(Rule):
    """Every process of a multi-host run executes the modules listed in
    `engine.MULTIPROCESS_MODULE_SUFFIXES` — an unguarded write there runs
    P times against ONE path (torn summaries, racing prunes, doubled
    registry entries).  The utils.durable helpers self-guard (no-op off
    process 0 unless `all_process=True`), so they are compliant by
    construction; everything that BYPASSES them must either sit under a
    lexical primary guard (`multihost.is_primary()` /
    `process_index() == 0`, including the early-return form) or carry a
    `# photonlint: all-process` annotation declaring the multi-writer
    intent (per-process files, race-tolerant sweeps).  A durable.* call
    that passes `all_process=True` disables the helper's own guard, so it
    needs the annotation too."""

    rule_id = "PH014"
    name = "multiprocess-write"
    summary = ("multi-process-reachable modules: bare durable writes and "
               "destructive mutations must be process-0-guarded "
               "(multihost.is_primary() / process_index() == 0) or "
               "annotated `# photonlint: all-process`; durable.* calls "
               "passing all_process=True need the annotation as well")

    _WRITE_MODES = ("w", "a", "x")
    _DESTRUCTIVE = {"json.dump", "numpy.save", "numpy.savez",
                    "numpy.savez_compressed", "shutil.rmtree",
                    "shutil.copyfile", "shutil.move", "os.remove",
                    "os.unlink", "os.replace", "os.rename"}

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        if not ctx.is_multiprocess_module or ctx.is_durable_impl:
            return []
        parents: Dict[ast.AST, ast.AST] = {}
        for node in ctx.nodes:
            for child in ast.iter_child_nodes(node):
                parents[child] = node
        findings: List[Finding] = []
        for node in ctx.nodes:
            if not isinstance(node, ast.Call):
                continue
            kind = self._classify(ctx, node)
            if kind is None:
                continue
            if node.lineno in ctx.suppressions.all_process_lines:
                continue
            if self._primary_guarded(ctx, parents, node):
                continue
            if kind == "override":
                findings.append(ctx.finding(
                    self.rule_id, node,
                    "durable.* call passes all_process=True — that "
                    "disables the helper's primary-only multi-writer "
                    "guard, so EVERY process writes; annotate the line "
                    "`# photonlint: all-process` to make the per-process "
                    "intent reviewable (or drop the override)"))
            else:
                findings.append(ctx.finding(
                    self.rule_id, node,
                    f"unguarded {kind} in a multi-process module — every "
                    "process executes this line against the same path; "
                    "guard it with multihost.is_primary() (process 0 owns "
                    "durable artifacts) or annotate `# photonlint: "
                    "all-process` for a deliberately per-process / "
                    "race-tolerant write"))
        return findings

    # -- classification -------------------------------------------------------
    def _classify(self, ctx: ModuleContext, node: ast.Call) -> Optional[str]:
        """'override' for durable.*(all_process=True), a description
        string for a bare write/mutation, None for anything benign."""
        if (isinstance(node.func, ast.Name) and node.func.id == "open"
                and node.func.id not in ctx.names):
            mode = None
            if len(node.args) >= 2 and isinstance(node.args[1],
                                                  ast.Constant):
                mode = node.args[1].value
            for kw in node.keywords:
                if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
                    mode = kw.value.value
            if isinstance(mode, str) and mode.startswith(self._WRITE_MODES):
                return f"open(..., {mode!r}) write"
            return None
        origin = ctx.resolve(node.func)
        if origin is None:
            return None
        if origin in self._DESTRUCTIVE:
            return f"{origin}() call"
        if origin.startswith(f"{ctx.package}.utils.durable."):
            for kw in node.keywords:
                if (kw.arg == "all_process"
                        and isinstance(kw.value, ast.Constant)
                        and kw.value.value is True):
                    return "override"
        return None

    # -- lexical primary-guard resolution -------------------------------------
    @staticmethod
    def _callee_tail(n: ast.Call) -> str:
        f = n.func
        if isinstance(f, ast.Attribute):
            return f.attr
        if isinstance(f, ast.Name):
            return f.id
        return ""

    def _primary_test(self, test: ast.AST) -> bool:
        """True when `test` asserts this IS the primary process: an
        is_primary() call anywhere in it, or process_index() == 0."""
        for n in ast.walk(test):
            if isinstance(n, ast.Call) \
                    and self._callee_tail(n) == "is_primary":
                return True
            if (isinstance(n, ast.Compare) and len(n.ops) == 1
                    and isinstance(n.ops[0], ast.Eq)):
                sides = [n.left] + n.comparators
                if (any(isinstance(s, ast.Constant) and s.value == 0
                        for s in sides)
                        and any(isinstance(s, ast.Call)
                                and self._callee_tail(s) == "process_index"
                                for s in sides)):
                    return True
        return False

    def _negated_primary_test(self, test: ast.AST) -> bool:
        """True when `test` asserts this is NOT the primary:
        `not is_primary()` / `process_index() != 0`."""
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return self._primary_test(test.operand)
        if (isinstance(test, ast.Compare) and len(test.ops) == 1
                and isinstance(test.ops[0], ast.NotEq)):
            sides = [test.left] + test.comparators
            return (any(isinstance(s, ast.Constant) and s.value == 0
                        for s in sides)
                    and any(isinstance(s, ast.Call)
                            and self._callee_tail(s) == "process_index"
                            for s in sides))
        return False

    def _primary_guarded(self, ctx: ModuleContext,
                         parents: Dict[ast.AST, ast.AST],
                         node: ast.AST) -> bool:
        cur = node
        while cur in parents:
            par = parents[cur]
            if isinstance(par, ast.If):
                in_body = any(cur is s for s in par.body)
                if in_body and self._primary_test(par.test):
                    return True
                # else-branch of an `if not primary:` split
                if (not in_body and any(cur is s for s in par.orelse)
                        and self._negated_primary_test(par.test)):
                    return True
            elif isinstance(par, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # early-return form: a preceding top-level statement of
                # the function reads `if not is_primary(): return` —
                # everything AFTER it is primary-only
                for stmt in par.body:
                    if stmt is cur:
                        break
                    if (isinstance(stmt, ast.If)
                            and self._negated_primary_test(stmt.test)
                            and all(isinstance(s, (ast.Return, ast.Raise))
                                    for s in stmt.body)
                            and not stmt.orelse):
                        return True
            cur = par
        return False


def all_rules() -> List[Rule]:
    from photon_ml_tpu_torch.analysis.concurrency import concurrency_rules
    return [HostSyncRule(), RetraceHazardRule(), HandOffRule(),
            FaultSiteRule(), DurableWriteRule(), NondeterminismRule(),
            RawTimerRule(), EventRegistryRule(),
            MultiprocessWriteRule()] + concurrency_rules()
