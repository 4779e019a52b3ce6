"""photonlint engine: module semantics, suppressions, baseline, driver.

A copy of the JAX package's linter engine with torch semantics.  Per
module it resolves import aliases to dotted origins (`F.relu` ->
`torch.nn.functional.relu`), finds graph-capture regions (functions
wrapped by `torch.compile` / `torch.jit.script` / `torch.jit.trace`, and
`with torch.cuda.graph(...)` bodies), and tracks which local names hold
device values (`torch.Tensor` annotations, results of `torch.*` ops,
`.to(device)` / `.cuda()`, the port's kernel wrappers, arithmetic on
device operands).  Rules consume this through `ModuleContext` — they never
re-derive imports or captures.

The package whose modules are resolved (call graph, durable helpers,
solver entry points, baseline paths) is a parameter: `PACKAGE`, this
package's own name, unless the caller names another.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

#: the package a lint run resolves by default: the port itself
PACKAGE = __name__.split(".")[0]

#: directory components whose modules are hot paths (PH001 applies)
HOT_PATH_DIRS = ("ops", "optim", "game", "parallel", "serving", "online",
                 "health", "fleet", "store")

#: path suffixes of modules whose file writes must be durable (PH005);
#: utils/durable.py is the helper implementation and is exempt
DURABLE_MODULE_SUFFIXES = (
    "models/io.py",
    "game/coordinate_descent.py",
    "data/index_map.py",
    "fleet/replog.py",
    "fleet/replica.py",
    "store/cold.py",
    "refit/compactor.py",
)
DURABLE_IMPL_SUFFIX = "utils/durable.py"

#: path suffixes of modules whose code EVERY process of a multi-host run
#: executes (PH014): durable writes / destructive mutations there must be
#: lexically primary-guarded or annotated `# photonlint: all-process`.
#: utils/durable.py itself is exempt (it IS the guard implementation).
MULTIPROCESS_MODULE_SUFFIXES = (
    "cli/train.py",
    "game/coordinate_descent.py",
    "parallel/multihost.py",
    "data/streaming.py",
    "ops/chunked.py",
)

_PRAGMA_RE = re.compile(
    r"#\s*photonlint:\s*(disable-file|disable|flush-point)"
    r"(?:\s*=\s*(PH[0-9]{3}(?:\s*,\s*PH[0-9]{3})*))?")

#: guard declaration pragma (the concurrency pass, PH010/PH013):
#: `self._table = {}  # photonlint: guarded-by=_lock` declares the
#: attribute guarded by `self._lock`; `guarded-by=atomic` declares it
#: deliberately lock-free (an atomic-publish attribute — e.g. a tuple
#: swap read by scoring threads at batch granularity).
_GUARD_RE = re.compile(
    r"#\s*photonlint:\s*guarded-by\s*=\s*"
    r"(atomic|none|(?:self\.)?[A-Za-z_][A-Za-z0-9_]*)")

#: multi-writer intent annotation (PH014): marks a write that is
#: DELIBERATELY executed by every process (per-process heartbeat files,
#: race-tolerant prune sweeps) — reviewable at the call site
_ALL_PROCESS_RE = re.compile(r"#\s*photonlint:\s*all-process")


def baseline_path_of(path: str, package: str) -> str:
    """Path key stable across checkouts: the subpath from the `package`
    component when present."""
    parts = path.replace(os.sep, "/").split("/")
    if package in parts:
        return "/".join(parts[parts.index(package):])
    return "/".join(parts)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation, anchored to a precise span."""

    rule: str
    path: str          # display path (as passed / relative to cwd)
    line: int
    col: int
    message: str
    text: str          # stripped source line — the baseline identity
    #: the evidence chain (PH010–PH013): how the guard was established,
    #: witness call paths of a lock-order inversion, which thread root
    #: makes the access concurrent.  Not part of the baseline identity.
    evidence: Tuple[str, ...] = ()
    #: the package the run resolved (the baseline path's anchor)
    package: str = dataclasses.field(default=PACKAGE, compare=False,
                                     repr=False)

    @property
    def baseline_path(self) -> str:
        return baseline_path_of(self.path, self.package)

    @property
    def baseline_key(self) -> Tuple[str, str, str]:
        # line numbers are deliberately NOT part of the identity: a
        # baselined finding survives unrelated edits above it
        return (self.rule, self.baseline_path, self.text)

    def to_dict(self) -> dict:
        out = {"rule": self.rule, "path": self.path, "line": self.line,
               "col": self.col, "message": self.message, "text": self.text}
        if self.evidence:
            out["evidence"] = list(self.evidence)
        return out

    def render(self) -> str:
        head = (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"{self.message}")
        if self.evidence:
            head += "".join(f"\n    | {e}" for e in self.evidence)
        return head


# -- suppression pragmas ------------------------------------------------------

class Suppressions:
    """Per-file pragma index: line pragmas, file pragmas, flush points."""

    def __init__(self, lines: Sequence[str]):
        self.file_all = False
        self.file_rules: Set[str] = set()
        self.line_all: Set[int] = set()
        self.line_rules: Dict[int, Set[str]] = {}
        self.flush_lines: Set[int] = set()
        self.guard_lines: Dict[int, str] = {}   # lineno -> declared lock
        self.all_process_lines: Set[int] = set()
        for lineno, text in enumerate(lines, start=1):
            if _ALL_PROCESS_RE.search(text):
                self.all_process_lines.add(lineno)
            g = _GUARD_RE.search(text)
            if g:
                name = g.group(1)
                if name.startswith("self."):
                    name = name[len("self."):]
                self.guard_lines[lineno] = name
            m = _PRAGMA_RE.search(text)
            if not m:
                continue
            kind, ids_text = m.group(1), m.group(2)
            ids = ({i.strip() for i in ids_text.split(",")}
                   if ids_text else None)
            if kind == "flush-point":
                self.flush_lines.add(lineno)
            elif kind == "disable-file":
                if ids is None:
                    self.file_all = True
                else:
                    self.file_rules |= ids
            else:  # disable
                if ids is None:
                    self.line_all.add(lineno)
                else:
                    self.line_rules.setdefault(lineno, set()).update(ids)

    def suppressed(self, rule: str, line: int) -> bool:
        return (self.file_all or rule in self.file_rules
                or line in self.line_all
                or rule in self.line_rules.get(line, ()))


# -- graph-capture semantics --------------------------------------------------

#: calls that compile or capture a graph (PH002; a function they wrap is
#: a capture region for PH006)
COMPILE_ORIGINS = {"torch.compile", "torch.jit.script", "torch.jit.trace",
                   "torch.jit.trace_module", "torch.jit.freeze",
                   "torch.jit.optimize_for_inference",
                   "torch.cuda.make_graphed_callables"}
#: CUDA-graph capture: `with torch.cuda.graph(g):` and its graph object
GRAPH_CAPTURE_ORIGINS = {"torch.cuda.graph", "torch.cuda.CUDAGraph",
                         "torch.cuda.graphs.graph",
                         "torch.cuda.graphs.CUDAGraph"}
_PARTIAL_ORIGINS = {"functools.partial"}


class ModuleContext:
    """Parsed module + resolved semantics handed to every rule."""

    def __init__(self, path: str, display_path: str, source: str,
                 package: str = PACKAGE):
        self.path = path
        self.display_path = display_path
        self.source = source
        self.package = package
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        #: every node, in `ast.walk` order, walked once for all the rules
        self.nodes: List[ast.AST] = list(ast.walk(self.tree))
        self.function_defs: List[ast.AST] = [
            n for n in self.nodes
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        self.suppressions = Suppressions(self.lines)
        # import alias tables
        self.modules: Dict[str, str] = {}   # local name -> dotted module
        self.names: Dict[str, str] = {}     # local name -> dotted origin
        self._scan_imports()
        #: capture regions: functions a compile/trace wraps (decorator or
        #: call form) and `with torch.cuda.graph(...)` statements
        self.traced_defs: Dict[ast.AST, str] = {}
        self.capture_withs: List[ast.With] = []
        self._scan_captures()
        #: functions of this module (by name; methods too) whose return
        #: annotation is a tensor or a tuple of them: their results are
        #: device values, as a jitted callable's are in the JAX package
        self.tensor_returning: Set[str] = {
            node.name for node in self.function_defs
            if returns_tensor(self, node.returns)}

    # -- path classification --------------------------------------------------
    @property
    def norm_path(self) -> str:
        return self.display_path.replace(os.sep, "/")

    @property
    def is_hot_path(self) -> bool:
        return any(p in HOT_PATH_DIRS for p in self.norm_path.split("/")[:-1])

    @property
    def is_durable_module(self) -> bool:
        return self.norm_path.endswith(DURABLE_MODULE_SUFFIXES)

    @property
    def is_durable_impl(self) -> bool:
        return self.norm_path.endswith(DURABLE_IMPL_SUFFIX)

    @property
    def is_multiprocess_module(self) -> bool:
        return self.norm_path.endswith(MULTIPROCESS_MODULE_SUFFIXES)

    # -- imports --------------------------------------------------------------
    def _scan_imports(self) -> None:
        for node in self.nodes:
            if isinstance(node, ast.Import):
                for alias in node.names:
                    self.modules[alias.asname or
                                 alias.name.split(".")[0]] = (
                        alias.name if alias.asname else
                        alias.name.split(".")[0])
                    if alias.asname:
                        self.modules[alias.asname] = alias.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                base = node.module  # relative imports keep the tail only
                for alias in node.names:
                    local = alias.asname or alias.name
                    self.names[local] = f"{base}.{alias.name}"

    def resolve(self, node) -> Optional[str]:
        """Dotted origin of a Name/Attribute chain, or None."""
        if isinstance(node, ast.Name):
            if node.id in self.names:
                return self.names[node.id]
            if node.id in self.modules:
                return self.modules[node.id]
            return None
        if isinstance(node, ast.Attribute):
            base = self.resolve(node.value)
            return f"{base}.{node.attr}" if base else None
        return None

    def resolves_to(self, node, origins) -> bool:
        r = self.resolve(node)
        return r is not None and r in origins

    # -- capture decoding -----------------------------------------------------
    def compile_origin(self, node) -> Optional[str]:
        """The compile/trace origin a decorator or wrapper expression
        applies (`@torch.compile`, `@torch.compile(mode=...)`,
        `@functools.partial(torch.jit.script, ...)`), else None."""
        origin = self.resolve(node)
        if origin in COMPILE_ORIGINS:
            return origin
        if isinstance(node, ast.Call):
            func_origin = self.resolve(node.func)
            if func_origin in COMPILE_ORIGINS:
                return func_origin
            if func_origin in _PARTIAL_ORIGINS and node.args:
                return self.compile_origin(node.args[0])
        return None

    def _scan_captures(self) -> None:
        defs: Dict[str, ast.AST] = {}
        for node in self.function_defs:
            defs.setdefault(node.name, node)
        for node in self.nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    origin = self.compile_origin(dec)
                    if origin is not None:
                        self.traced_defs[node] = origin
                        break
            elif isinstance(node, ast.Call):
                # call form: torch.compile(f) / torch.jit.trace(f, example)
                origin = self.resolve(node.func)
                if origin in COMPILE_ORIGINS and node.args:
                    wrapped = node.args[0]
                    target = (defs.get(wrapped.id)
                              if isinstance(wrapped, ast.Name)
                              else wrapped if isinstance(wrapped, ast.Lambda)
                              else None)
                    if target is not None:
                        self.traced_defs.setdefault(target, origin)
            elif isinstance(node, ast.With):
                for item in node.items:
                    expr = item.context_expr
                    if isinstance(expr, ast.Call) and self.resolve(
                            expr.func) in GRAPH_CAPTURE_ORIGINS:
                        self.capture_withs.append(node)
                        break

    def flush_point(self, fn_node) -> bool:
        """True when the `def` line (or the line above it) carries the
        `# photonlint: flush-point` marker."""
        line = getattr(fn_node, "lineno", 0)
        return (line in self.suppressions.flush_lines
                or line - 1 in self.suppressions.flush_lines)

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def finding(self, rule: str, node, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        return Finding(rule=rule, path=self.display_path, line=line,
                       col=col + 1, message=message,
                       text=self.line_text(line), package=self.package)


# -- device-value expression semantics (shared by PH001/PH012) ---------------

#: torch namespaces whose calls answer host values (queries, settings, the
#: process group, the profiler), never tensors
_TORCH_HOST_ROOTS = ("torch.cuda.", "torch.backends.", "torch.distributed.",
                     "torch.utils.", "torch.profiler.", "torch.autograd.",
                     "torch.testing.", "torch.library.", "torch.jit.",
                     "torch.compiler.", "torch.multiprocessing.")
_TORCH_HOST_CALLS = {
    "torch.finfo", "torch.iinfo", "torch.device", "torch.dtype",
    "torch.Size", "torch.Generator", "torch.get_default_dtype",
    "torch.is_tensor", "torch.is_floating_point", "torch.is_complex",
    "torch.numel", "torch.promote_types", "torch.result_type",
    "torch.can_cast", "torch.no_grad", "torch.inference_mode",
    "torch.enable_grad", "torch.set_grad_enabled", "torch.manual_seed",
    "torch.initial_seed", "torch.set_default_dtype",
    "torch.get_num_threads", "torch.set_num_threads", "torch.compile",
    "torch.is_grad_enabled", "torch.use_deterministic_algorithms",
}
#: tensor constructors: a host value unless given `device=` (the `_like`
#: forms follow their operand)
_TORCH_CONSTRUCTORS = {
    "torch.tensor", "torch.as_tensor", "torch.from_numpy", "torch.zeros",
    "torch.ones", "torch.empty", "torch.full", "torch.arange",
    "torch.linspace", "torch.logspace", "torch.eye", "torch.rand",
    "torch.randn", "torch.randint", "torch.randperm", "torch.frombuffer",
    "torch.empty_strided", "torch.asarray",
}
_TORCH_LIKE = {"torch.zeros_like", "torch.ones_like", "torch.empty_like",
               "torch.full_like", "torch.rand_like", "torch.randn_like",
               "torch.randint_like"}
#: the port's hand kernels' wrappers (package-relative): their results
#: live on the card
KERNEL_WRAPPERS = ("ops.hopper_kernels.fused_value_and_gradient",
                   "ops.hopper_kernels.fused_value_and_gradient_lanes",
                   "ops.sparse_kernels.ell_margins",
                   "ops.sparse_kernels.ell_margin_loss",
                   "ops.sparse_kernels.csc_column_sum")
_DEVICE_ANNOTATIONS = {"torch.Tensor", "Tensor", "torch.nn.Parameter"}
_HOST_CALLS = {"numpy.asarray", "numpy.array", "float", "int", "bool",
               "len", "str", "repr", "isinstance", "type", "id"}
#: tensor methods whose result is a host value (metadata, or the fetch
#: itself)
_HOST_METHODS = {"item", "tolist", "numpy", "cpu", "size", "dim", "numel",
                 "nelement", "element_size", "data_ptr", "stride",
                 "is_contiguous", "get_device", "storage_offset",
                 "synchronize", "record", "query", "wait_event",
                 "wait_stream", "tobytes", "is_pinned", "__len__"}
#: static metadata attributes: resolve without a fetch
_STATIC_ATTRS = ("shape", "ndim", "dtype", "size", "nbytes", "device",
                "is_cuda", "itemsize", "layout", "requires_grad")
#: dtype names under `torch.` (a `.to(<dtype>)` keeps the operand's side)
_TORCH_DTYPES = {"float16", "float32", "float64", "bfloat16", "half",
                 "float", "double", "int8", "int16", "int32", "int64",
                 "uint8", "bool", "long", "int", "short", "complex64",
                 "complex128"}


def is_device_annotation(ctx: ModuleContext, node) -> bool:
    if node is None:
        return False
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value in _DEVICE_ANNOTATIONS
    origin = ctx.resolve(node)
    return origin in _DEVICE_ANNOTATIONS if origin else False


def returns_tensor(ctx: ModuleContext, node) -> bool:
    """A return annotation naming a tensor: `torch.Tensor`, or a
    `Tuple[...]` holding one."""
    if is_device_annotation(ctx, node):
        return True
    if isinstance(node, ast.Subscript) and (ctx.resolve(node.value) or "") \
            .rsplit(".", 1)[-1] in ("Tuple", "tuple"):
        elts = (node.slice.elts if isinstance(node.slice, ast.Tuple)
                else [node.slice])
        return any(is_device_annotation(ctx, e) for e in elts)
    return False


def _is_cpu_literal(ctx: ModuleContext, node) -> bool:
    """`"cpu"` or `torch.device("cpu")`."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str) and node.value.split(":")[0] == "cpu"
    if isinstance(node, ast.Call) and ctx.resolve(node.func) == "torch.device" \
            and node.args:
        return _is_cpu_literal(ctx, node.args[0])
    return False


def _names_dtype(ctx: ModuleContext, node) -> bool:
    """A `.to(...)` argument that names a dtype, not a device: a torch
    dtype constant, or a name/attribute spelled `*dtype*`."""
    origin = ctx.resolve(node)
    if origin is not None and origin.startswith("torch.") \
            and origin.rsplit(".", 1)[-1] in _TORCH_DTYPES:
        return True
    leaf = (node.id if isinstance(node, ast.Name)
            else node.attr if isinstance(node, ast.Attribute) else "")
    return "dtype" in leaf.lower()


def to_target(ctx: ModuleContext, call: ast.Call) -> Optional[str]:
    """Where a `.to(...)` call moves its operand: "cpu", "device", or
    None (a dtype cast only)."""
    for kw in call.keywords:
        if kw.arg == "device":
            return "cpu" if _is_cpu_literal(ctx, kw.value) else "device"
    for a in call.args:
        if _is_cpu_literal(ctx, a):
            return "cpu"
        if isinstance(a, ast.Constant) or _names_dtype(ctx, a):
            continue
        return "device"
    return None


class DeviceTracker:
    """Ordered walk of one function (or module) body tracking which local
    names hold device values.  Rules register callbacks for the events
    they care about; the tracker guarantees source order so "assigned
    then used" reasoning is sound."""

    def __init__(self, ctx: ModuleContext):
        self.ctx = ctx
        self.device: Set[str] = set()
        self._wrappers = {f"{ctx.package}.{w}" for w in KERNEL_WRAPPERS}

    # -- expression classification -------------------------------------------
    def _has_device_kw(self, node: ast.Call) -> bool:
        return any(kw.arg == "device" and not _is_cpu_literal(self.ctx,
                                                               kw.value)
                   for kw in node.keywords)

    def _is_device_call(self, node: ast.Call) -> bool:
        origin = self.ctx.resolve(node.func)
        if origin is not None:
            if origin in _HOST_CALLS or origin in _TORCH_HOST_CALLS \
                    or origin.startswith(_TORCH_HOST_ROOTS):
                return False
            if origin in _TORCH_CONSTRUCTORS:
                return self._has_device_kw(node)
            if origin in _TORCH_LIKE:
                return self._has_device_kw(node) or any(
                    self.is_device_expr(a) for a in node.args[:1])
            if origin in self._wrappers:
                return True
            if origin.startswith("torch."):
                return True
            return False
        func = node.func
        if isinstance(func, ast.Name):
            return func.id in self.ctx.tensor_returning
        if not isinstance(func, ast.Attribute):
            return False
        if isinstance(func.value, ast.Name) and func.value.id == "self" \
                and func.attr in self.ctx.tensor_returning:
            return True
        if func.attr == "cuda":
            return True
        if func.attr == "to":
            where = to_target(self.ctx, node)
            if where == "cpu":
                return False
            return where == "device" or self.is_device_expr(func.value)
        if func.attr in _HOST_METHODS:
            return False
        return self.is_device_expr(func.value)

    def is_device_expr(self, node) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.device
        if isinstance(node, ast.Call):
            return self._is_device_call(node)
        if isinstance(node, ast.BinOp):
            return (self.is_device_expr(node.left)
                    or self.is_device_expr(node.right))
        if isinstance(node, ast.UnaryOp):
            return self.is_device_expr(node.operand)
        if isinstance(node, ast.Compare):
            return any(self.is_device_expr(e)
                       for e in [node.left, *node.comparators])
        if isinstance(node, ast.Subscript):
            return self.is_device_expr(node.value)
        if isinstance(node, ast.Attribute):
            # an attribute of a device value is device (`.T`, `.real`),
            # but static metadata attributes are host
            if node.attr in _STATIC_ATTRS:
                return False
            return self.is_device_expr(node.value)
        if isinstance(node, ast.IfExp):
            return (self.is_device_expr(node.body)
                    or self.is_device_expr(node.orelse))
        return False

    # -- statement walk --------------------------------------------------------
    def _bind(self, target, device: bool) -> None:
        for n in ast.walk(target):
            if isinstance(n, ast.Name):
                (self.device.add if device
                 else self.device.discard)(n.id)

    def seed_params(self, fn_node) -> None:
        args = fn_node.args
        for a in (args.posonlyargs + args.args + args.kwonlyargs):
            if is_device_annotation(self.ctx, a.annotation):
                self.device.add(a.arg)

    def walk(self, body, on_expr) -> None:
        """Visit statements in order.  `on_expr(expr_statement_value)` is
        invoked for every expression tree right BEFORE its bindings take
        effect, with the tracker state as of that point."""
        for stmt in body:
            self._walk_stmt(stmt, on_expr)

    def _walk_stmt(self, stmt, on_expr) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # nested scopes are linted separately
        if isinstance(stmt, ast.Assign):
            on_expr(stmt.value)
            dev = self.is_device_expr(stmt.value)
            for tgt in stmt.targets:
                self._bind(tgt, dev)
        elif isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                on_expr(stmt.value)
            dev = (is_device_annotation(self.ctx, stmt.annotation)
                   or (stmt.value is not None
                       and self.is_device_expr(stmt.value)))
            self._bind(stmt.target, dev)
        elif isinstance(stmt, ast.AugAssign):
            on_expr(stmt.value)
            if self.is_device_expr(stmt.value):
                self._bind(stmt.target, True)
        elif isinstance(stmt, ast.For):
            on_expr(stmt.iter)
            self._bind(stmt.target, self.is_device_expr(stmt.iter))
            self.walk(stmt.body, on_expr)
            self.walk(stmt.orelse, on_expr)
        elif isinstance(stmt, (ast.If, ast.While)):
            on_expr(stmt.test)
            self.walk(stmt.body, on_expr)
            self.walk(stmt.orelse, on_expr)
        elif isinstance(stmt, ast.With):
            for item in stmt.items:
                on_expr(item.context_expr)
            self.walk(stmt.body, on_expr)
        elif isinstance(stmt, ast.Try):
            self.walk(stmt.body, on_expr)
            for h in stmt.handlers:
                self.walk(h.body, on_expr)
            self.walk(stmt.orelse, on_expr)
            self.walk(stmt.finalbody, on_expr)
        elif isinstance(stmt, (ast.Return, ast.Expr)):
            if stmt.value is not None:
                on_expr(stmt.value)
        elif isinstance(stmt, (ast.Raise,)):
            if stmt.exc is not None:
                on_expr(stmt.exc)
        # pass/break/continue/import/global/nonlocal/assert/del: no device
        # bindings worth tracking (assert bodies are cold by definition)


def comprehension_device_names(tracker: DeviceTracker, node) -> Set[str]:
    """Loop targets of comprehensions iterating a device value — a
    per-element host sync factory (`float(e) for e in t`)."""
    out: Set[str] = set()
    for comp in getattr(node, "generators", ()):
        if tracker.is_device_expr(comp.iter):
            for n in ast.walk(comp.target):
                if isinstance(n, ast.Name):
                    out.add(n.id)
    return out


def host_sync(ctx: ModuleContext, tracker: DeviceTracker,
              node: ast.Call) -> Optional[str]:
    """Why `node` blocks the host on the card, or None: torch's host
    syncs (PH001, and PH012 under a lock)."""
    func = node.func
    if isinstance(func, ast.Name) and func.id in ("float", "int", "bool"):
        if func.id not in ctx.names and len(node.args) == 1 \
                and tracker.is_device_expr(node.args[0]):
            return (f"{func.id}() on a device value forces a blocking "
                    "device->host sync")
        return None
    if isinstance(func, ast.Name) and func.id == "range":
        if any(tracker.is_device_expr(a) for a in node.args):
            return "range() over a device value syncs via implicit __index__"
        return None
    origin = ctx.resolve(func)
    if origin == "torch.cuda.synchronize":
        return "torch.cuda.synchronize() blocks the host on the card"
    if origin in ("numpy.asarray", "numpy.array") and node.args \
            and tracker.is_device_expr(node.args[0]):
        return (f"{origin}() on a device value is a hidden device->host "
                "transfer")
    if not isinstance(func, ast.Attribute):
        return None
    if func.attr == "synchronize" and not node.args:
        return ".synchronize() on a stream or event blocks the host"
    if func.attr in ("item", "tolist", "cpu", "numpy") and not node.args \
            and tracker.is_device_expr(func.value):
        return (f".{func.attr}() on a device value forces a blocking "
                "device->host sync")
    if func.attr == "to" and to_target(ctx, node) == "cpu" \
            and tracker.is_device_expr(func.value):
        return '.to("cpu") on a device value forces a blocking device->host copy'
    return None


# -- registries (static) ------------------------------------------------------

def _shipped(rel: str) -> str:
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), *rel.split("/"))


def load_sites_registry(paths: Sequence[str]) -> Tuple[Dict[str,
                                                            Tuple[str, ...]],
                                                       Optional[str]]:
    """Statically parse `SITES = {...}` from a linted `faults.py`, falling
    back to this package's shipped `utils/faults.py`.  Returns (site ->
    declared ctx keys, source path) — empty dict when no registry exists
    anywhere (PH004 then reports every literal as undeclared)."""
    candidates = [p for p in paths if p.endswith("faults.py")]
    shipped = _shipped("utils/faults.py")
    if os.path.exists(shipped):
        candidates.append(shipped)
    for cand in candidates:
        try:
            with open(cand, encoding="utf-8") as f:
                tree = ast.parse(f.read())
        except (OSError, SyntaxError):
            continue
        for node in tree.body:
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target] if isinstance(node, ast.AnnAssign)
                       else [])
            if not any(isinstance(t, ast.Name) and t.id == "SITES"
                       for t in targets):
                continue
            value = node.value
            if not isinstance(value, ast.Dict):
                continue
            registry: Dict[str, Tuple[str, ...]] = {}
            for k, v in zip(value.keys, value.values):
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    registry[k.value] = _const_str_tuple(v)
            return registry, cand
    return {}, None


def _const_str_tuple(node) -> Tuple[str, ...]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return (node.value,)
    if isinstance(node, (ast.Tuple, ast.List)):
        return tuple(e.value for e in node.elts
                     if isinstance(e, ast.Constant)
                     and isinstance(e.value, str))
    return ()


def load_str_dict_registry(paths: Sequence[str], suffix: str,
                           var_name: str, shipped_rel: str
                           ) -> Tuple[Dict[str, str], Optional[str]]:
    """Statically parse a module-level `VAR = {"str": "str", ...}` from
    the first linted file whose path ends with `suffix`, falling back to
    this package's shipped module at `shipped_rel` (package-relative).
    How PH008 reads `telemetry.flight.TRIGGERS` and
    `telemetry.events.EVENTS` without importing anything."""
    candidates = [p for p in paths if p.endswith(suffix)]
    shipped = _shipped(shipped_rel)
    if os.path.exists(shipped):
        candidates.append(shipped)
    for cand in candidates:
        try:
            with open(cand, encoding="utf-8") as f:
                tree = ast.parse(f.read())
        except (OSError, SyntaxError):
            continue
        for node in tree.body:
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target] if isinstance(node, ast.AnnAssign)
                       else [])
            if not any(isinstance(t, ast.Name) and t.id == var_name
                       for t in targets):
                continue
            value = node.value
            if not isinstance(value, ast.Dict):
                continue
            registry: Dict[str, str] = {}
            for k, v in zip(value.keys, value.values):
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    registry[k.value] = (v.value if isinstance(v,
                                                               ast.Constant)
                                         else "")
            return registry, cand
    return {}, None


# -- baseline -----------------------------------------------------------------

class Baseline:
    """Committed grandfather list.  Identity = (rule, package-relative
    path, stripped source line) so entries survive line drift; matching is
    multiset-aware (two identical lines need two entries)."""

    def __init__(self, entries: Sequence[dict]):
        self._counts: Dict[Tuple[str, str, str], int] = {}
        for e in entries:
            key = (e["rule"], e["path"], e["text"])
            self._counts[key] = self._counts.get(key, 0) + 1
        self.total = len(entries)

    @staticmethod
    def load(path: str) -> "Baseline":
        try:
            with open(path, encoding="utf-8") as f:
                data = json.load(f)
        except OSError:
            return Baseline([])
        return Baseline(data.get("findings", []))

    @staticmethod
    def write(path: str, findings: Sequence[Finding]) -> int:
        entries = sorted(
            ({"rule": f.rule, "path": f.baseline_path, "text": f.text}
             for f in findings),
            key=lambda e: (e["path"], e["rule"], e["text"]))
        payload = {
            "version": 1,
            "comment": ("photonlint grandfathered findings — regenerate "
                        "with --write-baseline; shrink, never grow"),
            "findings": entries,
        }
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=1)
            f.write("\n")
        os.replace(tmp, path)
        return len(entries)

    def split(self, findings: Sequence[Finding]
              ) -> Tuple[List[Finding], List[Finding], int]:
        """-> (new, baselined, stale_entry_count)."""
        remaining = dict(self._counts)
        new, old = [], []
        for f in findings:
            if remaining.get(f.baseline_key, 0) > 0:
                remaining[f.baseline_key] -= 1
                old.append(f)
            else:
                new.append(f)
        stale = sum(remaining.values())
        return new, old, stale


# -- driver -------------------------------------------------------------------

def iter_py_files(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, names in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                out.extend(os.path.join(root, n) for n in sorted(names)
                           if n.endswith(".py"))
        elif p.endswith(".py"):
            out.append(p)
    return out


_RANGE_RE = re.compile(r"(PH[0-9]+)-(PH[0-9]+)$")


def select_matcher(select: Optional[Sequence[str]]):
    """Selector patterns -> predicate over rule ids.  A pattern is an
    exact id (`PH005`), a prefix (`PH01` selects PH010–PH014), or an
    inclusive range (`PH010-PH013`)."""
    if select is None:
        return lambda rule_id: True
    prefixes: List[str] = []
    ranges: List[Tuple[str, str]] = []
    for pat in select:
        m = _RANGE_RE.fullmatch(pat.strip())
        if m:
            ranges.append((m.group(1), m.group(2)))
        elif pat.strip():
            prefixes.append(pat.strip())

    def match(rule_id: str) -> bool:
        return (any(rule_id == p or rule_id.startswith(p)
                    for p in prefixes)
                or any(lo <= rule_id <= hi for lo, hi in ranges))

    return match


def parse_modules(paths: Sequence[str], package: str = PACKAGE
                  ) -> Tuple[List[ModuleContext], List[Finding]]:
    """Every .py file under `paths` as a ModuleContext, and a PH000
    finding for each one that does not parse."""
    contexts: List[ModuleContext] = []
    broken: List[Finding] = []
    for path in iter_py_files(paths):
        display = os.path.relpath(path) if os.path.isabs(path) else path
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
            contexts.append(ModuleContext(path, display, source, package))
        except (SyntaxError, UnicodeDecodeError, OSError) as e:
            broken.append(Finding(
                rule="PH000", path=display,
                line=getattr(e, "lineno", 1) or 1, col=1,
                message=f"unparseable module: {e}", text="",
                package=package))
    return contexts, broken


def lint_paths(paths: Sequence[str],
               select: Optional[Sequence[str]] = None,
               package: str = PACKAGE) -> List[Finding]:
    """Run every (selected) rule over every .py file under `paths`, with
    `package` the package whose modules calls resolve into.
    Suppressions are applied; the baseline is NOT (lint.py owns that).

    Per-module rules see one `ModuleContext` at a time; PROGRAM rules
    (the concurrency pass, `rule.program_rule` True) run once over every
    successfully parsed module so interprocedural facts — the call graph,
    thread roots, the lock-acquisition-order graph — span the package."""
    return lint_program(paths, select, package)[0]


def lint_program(paths: Sequence[str],
                 select: Optional[Sequence[str]] = None,
                 package: str = PACKAGE):
    """`lint_paths`, and the `ProgramContext` its program rules ran on
    (None when none was selected): one parse gives the findings and the
    lock-order graph (`program.lock_edges`)."""
    from photon_ml_tpu_torch.analysis.concurrency import ProgramContext
    from photon_ml_tpu_torch.analysis.rules import all_rules
    files = iter_py_files(paths)
    registry, registry_path = load_sites_registry(files)
    triggers, triggers_path = load_str_dict_registry(
        files, os.path.join("telemetry", "flight.py"), "TRIGGERS",
        "telemetry/flight.py")
    events, events_path = load_str_dict_registry(
        files, os.path.join("telemetry", "events.py"), "EVENTS",
        "telemetry/events.py")
    matches = select_matcher(select)
    rules = [r for r in all_rules() if matches(r.rule_id)]
    module_rules = [r for r in rules
                    if not getattr(r, "program_rule", False)]
    program_rules = [r for r in rules
                     if getattr(r, "program_rule", False)]
    contexts, findings = parse_modules(files, package)
    for ctx in contexts:
        ctx.sites_registry = registry
        ctx.sites_registry_path = registry_path
        ctx.triggers_registry = triggers
        ctx.triggers_registry_path = triggers_path
        ctx.events_registry = events
        ctx.events_registry_path = events_path
        for rule in module_rules:
            for f in rule.check(ctx):
                if not ctx.suppressions.suppressed(f.rule, f.line):
                    findings.append(f)
    program = None
    if program_rules and contexts:
        program = ProgramContext(contexts, package)
        by_path = {ctx.display_path: ctx for ctx in contexts}
        for rule in program_rules:
            for f in rule.check_program(program):
                ctx = by_path.get(f.path)
                if ctx is None or not ctx.suppressions.suppressed(f.rule,
                                                                  f.line):
                    findings.append(dataclasses.replace(f, package=package))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings, program
