"""photonlint concurrency pass: interprocedural lock/guard analysis
(PH010–PH013), a copy of the JAX package's with the package name a
parameter and torch's host syncs among PH012's blocking calls.

The GAME reproduction composes ~8 hand-rolled threaded subsystems
(streaming Prefetcher, AsyncCheckpointer, serving micro-batcher,
ModelRegistry delta swaps, OnlineUpdater, telemetry/metrics registries)
whose only race protection is convention.  This pass turns the convention
into checked invariants, the same move PH001–PH007 made for the hot-path
sync/retrace/durability rules:

  * it builds a package-wide CALL GRAPH on top of `engine.py`'s semantic
    layer (import-alias resolution for `threading.Thread` / lock
    constructors / blocking calls; name-based resolution for attribute
    calls, biased toward over-approximation — a static lock-order graph
    that contains every real edge is exactly what the runtime tracker in
    `utils/locktrace.py` validates against);
  * it infers PER-CLASS GUARD SETS — which `self._lock`/`self._cv`
    protects which mutable attributes — seeded by the explicit
    `# photonlint: guarded-by=<lock>` annotation (grammar: `guarded-by=`
    a lock attribute name, optionally `self.`-prefixed, or the literal
    `atomic` for deliberately lock-free atomic-publish attributes) and by
    majority-of-accesses inference (>= 3 accesses under one lock and at
    most a quarter outside it);
  * it derives the whole-program LOCK-ACQUISITION-ORDER GRAPH: an edge
    A -> B whenever code acquires B while holding A, lexically or through
    a call chain.  `lock_order_edges()` exports it; the armed
    `utils.locktrace` tracker asserts every acquisition order observed at
    runtime is an edge of this graph — static analysis and dynamic
    evidence must agree or the concurrency stress test fails.

Rules:

  PH010  unguarded read/write of a guarded attribute in a class that is
         reachable from a second thread (thread roots =
         `threading.Thread(target=...)` / `threading.Timer` spawns).
  PH011  lock-order inversion: a cycle in the acquisition-order graph,
         reported once per cycle with BOTH witness paths.
  PH012  blocking call while holding a lock: torch's host syncs (PH001's
         `.item()` / `.tolist()` / `.cpu()` / `.numpy()` / `.to("cpu")` /
         float()/int()/bool() on a device value, `torch.cuda.synchronize()`,
         `.synchronize()`) / solver entry points / `os.fsync` /
         `time.sleep` / thread joins / future results / event waits
         inside a `with self._lock:` region (condition-variable
         `.wait()` on the held lock itself is the sanctioned idiom and
         exempt).  The serving delta-swap p99 gate depends on this: every
         batch resolves `registry.scorer` under the registry lock, so
         anything blocking under it lands directly in scoring latency.
  PH013  thread-unsafe check-then-act: lazy init (`if self._x is None:
         self._x = ...`) outside the lock (the locked-recheck
         double-checked idiom is recognized and compliant), and
         unguarded publish — an attribute written on a spawned thread
         with no lock and read by other methods of the class.

Precision contract (same as rules.py): findings are anchored to resolved
semantics, so what the pass cannot see — callables stowed in attributes
(`self._score_fn`), locks passed across objects — it stays silent on.
The runtime tracker is the backstop for those.
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from photon_ml_tpu_torch.analysis.engine import (
    PACKAGE, DeviceTracker, Finding, ModuleContext, host_sync, iter_py_files,
    parse_modules,
)

# -- constructor / call-origin tables -----------------------------------------

_LOCK_ORIGINS = {"threading.Lock", "threading.RLock", "threading.Condition"}
_TLS_ORIGINS = {"threading.local"}
#: non-lock synchronization primitives: never "guarded attributes"
_SYNC_ORIGINS = {"threading.Event", "threading.Semaphore",
                 "threading.BoundedSemaphore", "threading.Barrier"}
_THREAD_ORIGINS = {"threading.Thread", "threading.Timer"}

#: method names that mutate their receiver: `self._frozen.add(...)` is a
#: WRITE of `_frozen` for guard-inference purposes
_MUTATORS = {"add", "append", "appendleft", "clear", "discard", "extend",
             "insert", "move_to_end", "pop", "popitem", "popleft",
             "remove", "setdefault", "update"}

#: attribute names too generic for name-based call resolution: they are
#: overwhelmingly stdlib container/file/threading methods (`deque.pop`,
#: `file.flush`, `Event.set`), and mapping them onto same-named package
#: methods manufactures phantom call edges (and phantom lock-order
#: cycles).  A package method with one of these names is still resolved
#: exactly through `self.m()` / imported-name calls.
_GENERIC_ATTRS = {
    "acquire", "add", "append", "appendleft", "cancel", "clear", "close",
    "copy", "count", "decode", "discard", "done", "encode", "extend",
    "flush", "format", "get", "index", "insert", "is_set", "items",
    "join", "keys", "locked", "mean", "move_to_end", "notify",
    "notify_all", "open", "pop", "popitem", "popleft", "put", "read",
    "release", "remove", "reverse", "run", "seek", "set", "setdefault",
    "sort", "split", "start", "strip", "sum", "tolist", "update",
    "values", "wait", "write",
}

#: blocking-call table for PH012 (resolved dotted origins); torch's host
#: syncs come from `engine.host_sync`, PH001's classifier
_BLOCKING_ORIGINS = {"time.sleep", "os.fsync"}
#: blocking attribute-call names; `.wait()` on the HELD lock is exempt
_BLOCKING_ATTRS = {"wait", "wait_for"}
#: solver / warmup entry points: a whole compile or inner solve under a
#: lock stalls every thread contending for it
_SOLVER_NAMES = {"solve", "solve_anchored", "solve_streamed", "train_glm",
                 "warmup", "fit"}

_INIT_METHODS = ("__init__", "__post_init__")


# -- program model ------------------------------------------------------------

@dataclasses.dataclass
class Access:
    """One `self.X` touch inside a method (or a nested def closing over
    self)."""

    attr: str
    write: bool
    lineno: int
    col: int
    held: Tuple[str, ...]          # lock nodes held lexically
    func: "FuncInfo"

    def eff_held(self) -> Set[str]:
        return set(self.held) | self.func.extra_held


@dataclasses.dataclass
class Acquire:
    lock: str                       # lock node name ("Class._lock")
    lineno: int
    held: Tuple[str, ...]           # held BEFORE this acquisition
    func: "FuncInfo"

    def eff_held(self) -> Set[str]:
        return set(self.held) | self.func.extra_held


@dataclasses.dataclass
class CallSite:
    node: ast.Call
    lineno: int
    held: Tuple[str, ...]
    func: "FuncInfo"

    def eff_held(self) -> Set[str]:
        return set(self.held) | self.func.extra_held


class FuncInfo:
    """One function body: a method, a module-level function, or a nested
    def (attributed to the enclosing class when it closes over self)."""

    def __init__(self, ctx: ModuleContext, node, cls: Optional["ClassInfo"],
                 name: str, qual: str, is_method: bool):
        self.ctx = ctx
        self.node = node
        self.cls = cls
        self.name = name
        self.qual = qual                # e.g. "OnlineUpdater._loop"
        self.is_method = is_method      # directly in the class body
        self.accesses: List[Access] = []
        self.acquires: List[Acquire] = []
        self.calls: List[CallSite] = []
        self.spawns: List[Tuple[ast.expr, int]] = []   # (target expr, line)
        self.nested: Dict[str, "FuncInfo"] = {}
        self.if_stmts: List[Tuple[ast.If, Tuple[str, ...]]] = []
        #: locks held at EVERY call site (interprocedural caller-holds)
        self.extra_held: Set[str] = set()

    def __repr__(self):
        return f"<FuncInfo {self.qual}>"


class ClassInfo:
    def __init__(self, ctx: ModuleContext, node: ast.ClassDef):
        self.ctx = ctx
        self.node = node
        self.name = node.name
        self.locks: Dict[str, str] = {}        # attr -> "Lock"/"Condition"/...
        self.sync_attrs: Set[str] = set()      # Events/semaphores/locals
        self.methods: Dict[str, FuncInfo] = {}
        self.funcs: List[FuncInfo] = []        # methods + attributed nested
        #: attr -> (declared lock name or "atomic", decl lineno)
        self.guard_decl: Dict[str, Tuple[str, int]] = {}
        self.spawned_roots: List[FuncInfo] = []

    def lock_node(self, attr: str) -> str:
        return f"{self.name}.{attr}"

    @property
    def lock_nodes(self) -> Set[str]:
        return {self.lock_node(a) for a in self.locks}


def _call_origin_in(ctx: ModuleContext, node: ast.Call, origins) -> bool:
    origin = ctx.resolve(node.func)
    return origin is not None and origin in origins


def _value_constructs(ctx: ModuleContext, value, origins) -> bool:
    """True when `value` contains a call to one of `origins` anywhere
    (recognizes `locktrace.tracked(threading.Lock(), "...")` wrappers)."""
    for node in ast.walk(value):
        if isinstance(node, ast.Call) and _call_origin_in(ctx, node,
                                                          origins):
            return True
    return False


def _self_attr(node) -> Optional[str]:
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


# -- per-function scan --------------------------------------------------------

class _FunctionScan:
    """Ordered walk of one function body tracking the lexically held lock
    set.  Nested defs become their own FuncInfo (they execute later, with
    no lock held) attributed to the same class."""

    def __init__(self, program: "ProgramContext", ctx: ModuleContext,
                 info: FuncInfo, module_locks: Dict[str, str]):
        self.program = program
        self.ctx = ctx
        self.info = info
        self.module_locks = module_locks

    # -- lock-expression classification ------------------------------------
    def _lock_of(self, expr) -> Optional[str]:
        attr = _self_attr(expr)
        if attr is not None and self.info.cls is not None \
                and attr in self.info.cls.locks:
            return self.info.cls.lock_node(attr)
        if isinstance(expr, ast.Name) and expr.id in self.module_locks:
            return self.module_locks[expr.id]
        return None

    # -- entry --------------------------------------------------------------
    def run(self) -> None:
        body = (self.info.node.body
                if not isinstance(self.info.node, ast.Module)
                else self.info.node.body)
        self._stmts(body, [])

    # -- statement walk ------------------------------------------------------
    def _stmts(self, body, held: List[str]) -> None:
        for stmt in body:
            self._stmt(stmt, held)

    def _stmt(self, stmt, held: List[str]) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self.program._scan_function(
                self.ctx, stmt, self.info.cls,
                qual=f"{self.info.qual}.{stmt.name}",
                is_method=False, parent=self.info,
                module_locks=self.module_locks)
            return
        if isinstance(stmt, ast.ClassDef):
            return  # nested classes: out of scope
        if isinstance(stmt, ast.With):
            acquired: List[str] = []
            for item in stmt.items:
                lock = self._lock_of(item.context_expr)
                if lock is not None:
                    self.info.acquires.append(Acquire(
                        lock, item.context_expr.lineno,
                        tuple(held) + tuple(acquired), self.info))
                    acquired.append(lock)
                else:
                    self._expr(item.context_expr, held + acquired)
            self._stmts(stmt.body, held + acquired)
            return
        if isinstance(stmt, ast.Assign):
            self._expr(stmt.value, held)
            for tgt in stmt.targets:
                self._target(tgt, held)
            return
        if isinstance(stmt, ast.AugAssign):
            # one access: `x += 1` reads and writes at a single site —
            # counting it twice would skew the majority inference
            self._expr(stmt.value, held)
            self._target(stmt.target, held)
            return
        if isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self._expr(stmt.value, held)
                self._target(stmt.target, held)
            return
        if isinstance(stmt, ast.If):
            self._expr(stmt.test, held)
            self.info.if_stmts.append((stmt, tuple(held)))
            self._stmts(stmt.body, held)
            self._stmts(stmt.orelse, held)
            return
        if isinstance(stmt, ast.While):
            self._expr(stmt.test, held)
            self._stmts(stmt.body, held)
            self._stmts(stmt.orelse, held)
            return
        if isinstance(stmt, ast.For):
            self._expr(stmt.iter, held)
            self._target(stmt.target, held)
            self._stmts(stmt.body, held)
            self._stmts(stmt.orelse, held)
            return
        if isinstance(stmt, ast.Try):
            self._stmts(stmt.body, held)
            for h in stmt.handlers:
                self._stmts(h.body, held)
            self._stmts(stmt.orelse, held)
            self._stmts(stmt.finalbody, held)
            return
        if isinstance(stmt, (ast.Return, ast.Expr)):
            if stmt.value is not None:
                self._expr(stmt.value, held)
            return
        if isinstance(stmt, ast.Raise):
            if stmt.exc is not None:
                self._expr(stmt.exc, held)
            if stmt.cause is not None:
                self._expr(stmt.cause, held)
            return
        if isinstance(stmt, ast.Assert):
            self._expr(stmt.test, held)
            return
        if isinstance(stmt, ast.Delete):
            for tgt in stmt.targets:
                self._target(tgt, held)
            return
        # pass/break/continue/import/global/nonlocal: nothing to track

    # -- assignment targets ---------------------------------------------------
    def _target(self, tgt, held: List[str], also_read: bool = False) -> None:
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for e in tgt.elts:
                self._target(e, held, also_read)
            return
        if isinstance(tgt, ast.Starred):
            self._target(tgt.value, held, also_read)
            return
        attr = _self_attr(tgt)
        if attr is not None:
            if also_read:
                self._note_access(attr, False, tgt, held)
            self._note_access(attr, True, tgt, held)
            return
        if isinstance(tgt, ast.Subscript):
            # self.X[k] = v mutates X (write-through)
            inner = _self_attr(tgt.value)
            if inner is not None:
                self._note_access(inner, True, tgt.value, held)
            else:
                self._expr(tgt.value, held)
            self._expr(tgt.slice, held)
            return
        if isinstance(tgt, ast.Attribute):
            # self.X.y = v mutates X (write-through); other.y = v: scan
            inner = _self_attr(tgt.value)
            if inner is not None:
                self._note_access(inner, True, tgt.value, held)
            else:
                self._expr(tgt.value, held)
            return
        # Name targets bind locals — nothing shared

    # -- expressions ----------------------------------------------------------
    def _expr(self, node, held: List[str]) -> None:
        if node is None:
            return
        if isinstance(node, ast.Lambda):
            # a lambda is scanned AS IF invoked where it is built, with
            # the locks lexically held there: the dominant package idiom
            # is the immediately-run thunk (store.base.with_retries
            # bodies, deferred builds), and a stored-callback lambda is a
            # sound over-approximation (extra edges, never missed ones).
            # Without this, a lock acquired inside a retried thunk has no
            # static counterpart and the armed locktrace cross-validation
            # reports a call-graph gap.
            self._expr(node.body, held)
            return
        if isinstance(node, ast.Call):
            self.info.calls.append(CallSite(node, node.lineno, tuple(held),
                                            self.info))
            self._note_spawn(node)
            # mutator-method write-through: self.X.add(...)
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _MUTATORS:
                inner = _self_attr(node.func.value)
                if inner is not None:
                    self._note_access(inner, True, node.func.value, held)
            self._expr(node.func, held)
            for a in node.args:
                self._expr(a, held)
            for kw in node.keywords:
                self._expr(kw.value, held)
            return
        attr = _self_attr(node)
        if attr is not None and isinstance(node.ctx, ast.Load):
            self._note_access(attr, False, node, held)
            return
        for child in ast.iter_child_nodes(node):
            self._expr(child, held)

    def _note_access(self, attr: str, write: bool, node,
                     held: List[str]) -> None:
        if self.info.cls is None or attr.startswith("__"):
            return
        self.info.accesses.append(Access(
            attr, write, node.lineno, node.col_offset, tuple(held),
            self.info))

    def _note_spawn(self, node: ast.Call) -> None:
        if not _call_origin_in(self.ctx, node, _THREAD_ORIGINS):
            return
        target = None
        for kw in node.keywords:
            if kw.arg in ("target", "function"):
                target = kw.value
        origin = self.ctx.resolve(node.func)
        if target is None and origin == "threading.Timer" \
                and len(node.args) >= 2:
            target = node.args[1]
        if target is not None:
            self.info.spawns.append((target, node.lineno))


# -- the program context ------------------------------------------------------

class ProgramContext:
    """Whole-program facts the PH010–PH013 rules consume: classes with
    their locks/guards, every function's accesses/acquires/calls, thread
    roots + reachability, and the lock-acquisition-order graph."""

    def __init__(self, contexts: Sequence[ModuleContext],
                 package: str = PACKAGE):
        self.contexts = list(contexts)
        self.package = package
        self.classes: List[ClassInfo] = []
        self.functions: List[FuncInfo] = []
        self.methods_by_name: Dict[str, List[FuncInfo]] = {}
        self.module_funcs: Dict[Tuple[str, str], FuncInfo] = {}
        self._module_locks: Dict[ModuleContext, Dict[str, str]] = {}
        self._module_tag: Dict[ModuleContext, str] = {}
        self._dotted: Dict[str, ModuleContext] = {}
        for ctx in self.contexts:
            self._scan_module(ctx)
        self._resolve_guard_decls()
        self._compute_caller_holds()
        self.thread_roots: List[FuncInfo] = []
        self._resolve_spawns()
        self.reachable: Dict[FuncInfo, FuncInfo] = {}  # func -> root
        self._compute_reachability()
        #: (outer, inner) -> witness chain (tuple of step strings)
        self.lock_edges: Dict[Tuple[str, str], Tuple[str, ...]] = {}
        #: (outer, inner) -> (display_path, lineno) anchor of the witness
        self.edge_anchor: Dict[Tuple[str, str], Tuple[str, int]] = {}
        self._compute_lock_edges()

    # -- module scan ---------------------------------------------------------
    def _scan_module(self, ctx: ModuleContext) -> None:
        tag = os.path.basename(ctx.norm_path)[:-3] or ctx.norm_path
        self._module_tag[ctx] = tag
        parts = ctx.norm_path.split("/")
        if self.package in parts:
            dotted = ".".join(parts[parts.index(self.package):])[:-3]
        else:
            dotted = tag
        self._dotted[dotted] = ctx
        module_locks: Dict[str, str] = {}
        for stmt in ctx.tree.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name) \
                    and _value_constructs(ctx, stmt.value, _LOCK_ORIGINS):
                name = stmt.targets[0].id
                module_locks[name] = f"{tag}.{name}"
        self._module_locks[ctx] = module_locks
        # classes first (lock attributes must be known before the
        # function scans classify `with self._lock:` regions)
        classes_here: List[Tuple[ast.ClassDef, ClassInfo]] = []
        for stmt in ctx.tree.body:
            if isinstance(stmt, ast.ClassDef):
                cls = ClassInfo(ctx, stmt)
                self._pre_scan_class(ctx, stmt, cls)
                self.classes.append(cls)
                classes_here.append((stmt, cls))
        for stmt in ctx.tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fi = self._scan_function(ctx, stmt, None, qual=stmt.name,
                                         is_method=False, parent=None,
                                         module_locks=module_locks)
                self.module_funcs[(dotted, stmt.name)] = fi
        for node, cls in classes_here:
            for stmt in node.body:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    fi = self._scan_function(
                        ctx, stmt, cls, qual=f"{cls.name}.{stmt.name}",
                        is_method=True, parent=None,
                        module_locks=module_locks)
                    cls.methods[stmt.name] = fi

    def _pre_scan_class(self, ctx: ModuleContext, node: ast.ClassDef,
                        cls: ClassInfo) -> None:
        """Find lock / sync-primitive / thread-local attributes and
        guarded-by declarations anywhere in the class body (usually
        __init__)."""
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
                target = sub.targets[0]
            elif isinstance(sub, ast.AnnAssign) and sub.value is not None:
                target = sub.target
            else:
                continue
            attr = _self_attr(target)
            if attr is None:
                continue
            if _value_constructs(ctx, sub.value, _LOCK_ORIGINS):
                kind = "Lock"
                for call in ast.walk(sub.value):
                    if isinstance(call, ast.Call):
                        origin = ctx.resolve(call.func)
                        if origin in _LOCK_ORIGINS:
                            kind = origin.rsplit(".", 1)[-1]
                cls.locks[attr] = kind
            elif _value_constructs(ctx, sub.value,
                                   _SYNC_ORIGINS | _TLS_ORIGINS):
                cls.sync_attrs.add(attr)
            decl = None
            for line in range(sub.lineno,
                              (sub.end_lineno or sub.lineno) + 1):
                if line in ctx.suppressions.guard_lines:
                    decl = (ctx.suppressions.guard_lines[line], line)
            if decl is not None:
                cls.guard_decl[attr] = decl

    def _scan_function(self, ctx: ModuleContext, node, cls, *, qual: str,
                       is_method: bool, parent: Optional[FuncInfo],
                       module_locks: Dict[str, str]) -> FuncInfo:
        fi = FuncInfo(ctx, node, cls, node.name, qual, is_method)
        self.functions.append(fi)
        if cls is not None:
            cls.funcs.append(fi)
            self.methods_by_name.setdefault(node.name, []).append(fi)
        if parent is not None:
            parent.nested[node.name] = fi
        _FunctionScan(self, ctx, fi, module_locks).run()
        return fi

    # -- guard declarations ---------------------------------------------------
    def _resolve_guard_decls(self) -> None:
        """Normalize declared guards; a declaration naming an unknown lock
        is recorded as-is — PH010 reports it loudly instead of silently
        guarding nothing."""
        # (nothing further: ClassInfo.guard_decl already holds raw names)

    # -- interprocedural caller-holds-the-lock -------------------------------
    def _compute_caller_holds(self) -> None:
        """A private helper called ONLY with a lock held inherits that
        lock: `FeedbackBuffer._dedup` runs under `offer_batch`'s lock and
        its accesses count as guarded.  Fixpoint over self-call sites."""
        for _round in range(3):
            changed = False
            for cls in self.classes:
                for name, fi in cls.methods.items():
                    if not name.startswith("_") or name.startswith("__"):
                        continue
                    if len(self.methods_by_name.get(name, ())) != 1:
                        continue  # ambiguous name: no propagation
                    sites = [cs for other in cls.funcs for cs in other.calls
                             if cs.func is not fi
                             and _self_attr(cs.node.func) == name]
                    if not sites:
                        continue
                    common = None
                    for cs in sites:
                        eff = cs.eff_held()
                        common = eff if common is None else common & eff
                    if common and common - fi.extra_held:
                        fi.extra_held |= common
                        changed = True
            if not changed:
                break

    # -- thread roots + reachability -----------------------------------------
    def _resolve_spawns(self) -> None:
        for fi in self.functions:
            for target, lineno in fi.spawns:
                root = self._resolve_spawn_target(fi, target)
                if root is None:
                    continue
                if root not in self.thread_roots:
                    self.thread_roots.append(root)
                if root.cls is not None \
                        and root not in root.cls.spawned_roots:
                    root.cls.spawned_roots.append(root)

    def _resolve_spawn_target(self, fi: FuncInfo,
                              target) -> Optional[FuncInfo]:
        attr = _self_attr(target)
        if attr is not None and fi.cls is not None:
            return fi.cls.methods.get(attr)
        if isinstance(target, ast.Name):
            if target.id in fi.nested:
                return fi.nested[target.id]
            dotted = None
            for d, ctx in self._dotted.items():
                if ctx is fi.ctx:
                    dotted = d
            if dotted is not None \
                    and (dotted, target.id) in self.module_funcs:
                return self.module_funcs[(dotted, target.id)]
            origin = fi.ctx.resolve(target)
            if origin is not None:
                return self._func_by_origin(origin)
        if isinstance(target, ast.Attribute):
            origin = fi.ctx.resolve(target)
            if origin is not None:
                return self._func_by_origin(origin)
        return None

    def _func_by_origin(self, origin: str) -> Optional[FuncInfo]:
        mod, _, name = origin.rpartition(".")
        return self.module_funcs.get((mod, name))

    def _resolve_callees(self, cs: CallSite) -> List[FuncInfo]:
        func = cs.node.func
        fi = cs.func
        # exact: resolved dotted origin -> module function
        origin = fi.ctx.resolve(func)
        if origin is not None:
            exact = self._func_by_origin(origin)
            if exact is not None:
                return [exact]
        attr = _self_attr(func)
        if attr is not None:
            if fi.cls is not None and attr in fi.cls.methods:
                return [fi.cls.methods[attr]]
            return []
        if isinstance(func, ast.Name):
            if func.id in fi.nested:
                return [fi.nested[func.id]]
            for d, ctx in self._dotted.items():
                if ctx is fi.ctx and (d, func.id) in self.module_funcs:
                    return [self.module_funcs[(d, func.id)]]
            return []
        if isinstance(func, ast.Attribute):
            # name-based over-approximation: `anything.m(...)` may be any
            # package method named m (dunders and stdlib-generic names
            # excluded — see _GENERIC_ATTRS)
            if func.attr.startswith("__") or func.attr in _GENERIC_ATTRS:
                return []
            return list(self.methods_by_name.get(func.attr, ()))
        return []

    def _compute_reachability(self) -> None:
        frontier = list(self.thread_roots)
        for root in frontier:
            self.reachable[root] = root
        while frontier:
            fi = frontier.pop()
            root = self.reachable[fi]
            for cs in fi.calls:
                for callee in self._resolve_callees(cs):
                    if callee not in self.reachable:
                        self.reachable[callee] = root
                        frontier.append(callee)

    def class_thread_evidence(self, cls: ClassInfo) -> str:
        if cls.spawned_roots:
            root = cls.spawned_roots[0]
            return (f"second thread: {cls.name} spawns "
                    f"threading.Thread(target={root.qual})")
        for fi in cls.funcs:
            root = self.reachable.get(fi)
            if root is not None:
                return (f"second thread: {fi.qual} is reachable from "
                        f"thread root {root.qual}")
        return ("second thread: class owns a lock (treated as "
                "cross-thread by construction)")

    # -- the lock-acquisition-order graph ------------------------------------
    def _compute_lock_edges(self) -> None:
        memo: Dict[FuncInfo, Dict[str, Tuple[str, ...]]] = {}

        def trans_acquires(fi: FuncInfo, stack: Tuple[FuncInfo, ...]
                           ) -> Dict[str, Tuple[str, ...]]:
            if fi in memo:
                return memo[fi]
            # depth cap: the tiered store's delta path legitimately nests
            # registry -> scorer -> store -> commit -> stats (6 frames);
            # the memo keeps the deeper bound cheap
            if fi in stack or len(stack) > 7:
                return {}
            out: Dict[str, Tuple[str, ...]] = {}
            for acq in fi.acquires:
                out.setdefault(acq.lock, (
                    f"{fi.qual} ({fi.ctx.display_path}:{acq.lineno}) "
                    f"acquires {acq.lock}",))
            for cs in fi.calls:
                for callee in self._resolve_callees(cs):
                    sub = trans_acquires(callee, stack + (fi,))
                    for lock, chain in sub.items():
                        out.setdefault(lock, (
                            f"{fi.qual} ({fi.ctx.display_path}:"
                            f"{cs.lineno}) calls {callee.qual}",) + chain)
            memo[fi] = out
            return out

        def note(outer: str, inner: str, chain: Tuple[str, ...],
                 anchor: Tuple[str, int]) -> None:
            if outer == inner:
                return
            key = (outer, inner)
            if key not in self.lock_edges:
                self.lock_edges[key] = chain
                self.edge_anchor[key] = anchor

        for fi in self.functions:
            for acq in fi.acquires:
                for outer in acq.eff_held():
                    note(outer, acq.lock,
                         (f"{fi.qual} ({fi.ctx.display_path}:{acq.lineno})"
                          f" acquires {acq.lock} while holding {outer}",),
                         (fi.ctx.display_path, acq.lineno))
            for cs in fi.calls:
                held = cs.eff_held()
                if not held:
                    continue
                for callee in self._resolve_callees(cs):
                    for lock, chain in trans_acquires(callee, (fi,)).items():
                        for outer in held:
                            note(outer, lock,
                                 (f"{fi.qual} ({fi.ctx.display_path}:"
                                  f"{cs.lineno}) holds {outer} and calls "
                                  f"{callee.qual}",) + chain,
                                 (fi.ctx.display_path, cs.lineno))


def lock_order_edges(paths: Sequence[str],
                     package: str = PACKAGE) -> Set[Tuple[str, str]]:
    """The static lock-acquisition-order graph of `paths` as a set of
    (outer, inner) lock-node pairs — what `utils.locktrace.LockTracker.
    validate_against` checks runtime acquisition orders against."""
    contexts, _ = parse_modules(iter_py_files(paths), package)
    return set(ProgramContext(contexts, package).lock_edges)


# -- guard resolution (shared by PH010/PH013) ---------------------------------

def _class_accesses(cls: ClassInfo) -> Dict[str, List[Access]]:
    out: Dict[str, List[Access]] = {}
    for fi in cls.funcs:
        for a in fi.accesses:
            if a.attr in cls.locks or a.attr in cls.sync_attrs:
                continue
            if a.attr in cls.methods:
                continue
            out.setdefault(a.attr, []).append(a)
    return out


def _resolve_guards(cls: ClassInfo) -> Tuple[Dict[str, Tuple[str, str]],
                                             Set[str], List[Tuple[str, int]]]:
    """-> (attr -> (lock node, evidence), atomic attrs, bad declarations).

    Declared guards win; otherwise an attribute with >= 3 non-init
    accesses under one of the class's locks and at most a quarter outside
    is INFERRED guarded by it."""
    guards: Dict[str, Tuple[str, str]] = {}
    atomic: Set[str] = set()
    bad: List[Tuple[str, int]] = []
    for attr, (lockname, lineno) in cls.guard_decl.items():
        if lockname in ("atomic", "none"):
            atomic.add(attr)
        elif lockname in cls.locks:
            guards[attr] = (cls.lock_node(lockname),
                            f"guard: declared guarded-by={lockname} "
                            f"({cls.ctx.display_path}:{lineno})")
        else:
            bad.append((lockname, lineno))
    accesses = _class_accesses(cls)
    for attr, acc in accesses.items():
        if attr in guards or attr in atomic or attr in cls.guard_decl:
            continue
        live = [a for a in acc if a.func.name not in _INIT_METHODS]
        if len(live) < 3:
            continue
        best_lock, best_g = None, 0
        for lock in cls.lock_nodes:
            g = sum(1 for a in live if lock in a.eff_held())
            if g > best_g:
                best_lock, best_g = lock, g
        u = len(live) - best_g
        if best_lock is not None and best_g >= 3 and u * 3 <= best_g:
            guards[attr] = (best_lock,
                            f"guard: inferred — {best_g}/{len(live)} "
                            f"accesses hold {best_lock}")
    return guards, atomic, bad


# -- PH010: unguarded access to a guarded attribute ---------------------------

class GuardedAttributeRule:
    rule_id = "PH010"
    name = "guarded-attr"
    summary = ("read/write of a lock-guarded attribute (declared via "
               "`# photonlint: guarded-by=` or inferred by majority of "
               "accesses) without holding the lock, in a class used "
               "across threads")
    program_rule = True

    def check_program(self, program: ProgramContext) -> Iterable[Finding]:
        findings: List[Finding] = []
        for cls in program.classes:
            if not cls.locks:
                continue
            guards, atomic, bad = _resolve_guards(cls)
            for lockname, lineno in bad:
                findings.append(Finding(
                    rule=self.rule_id, path=cls.ctx.display_path,
                    line=lineno, col=1,
                    message=(f"guarded-by={lockname!r} on {cls.name} names "
                             f"no lock attribute of the class (locks: "
                             f"{sorted(cls.locks) or 'none'}) — the "
                             "declaration guards nothing"),
                    text=cls.ctx.line_text(lineno)))
            if not guards:
                continue
            thread_note = program.class_thread_evidence(cls)
            accesses = _class_accesses(cls)
            for attr, (lock, source) in guards.items():
                for a in accesses.get(attr, ()):
                    if a.func.name in _INIT_METHODS:
                        continue
                    if lock in a.eff_held():
                        continue
                    kind = "write" if a.write else "read"
                    findings.append(Finding(
                        rule=self.rule_id, path=cls.ctx.display_path,
                        line=a.lineno, col=a.col + 1,
                        message=(f"{kind} of {cls.name}.{attr} in "
                                 f"{a.func.qual} without holding {lock}"
                                 " — a second thread can interleave; "
                                 "take the lock or declare the attribute "
                                 "`# photonlint: guarded-by=atomic`"),
                        text=cls.ctx.line_text(a.lineno),
                        evidence=(source, thread_note)))
        return findings


# -- PH011: lock-order inversion ----------------------------------------------

class LockOrderRule:
    rule_id = "PH011"
    name = "lock-order"
    summary = ("cycle in the whole-program lock-acquisition-order graph "
               "(A taken under B somewhere, B under A elsewhere) — "
               "reported with both witness call paths")
    program_rule = True

    def check_program(self, program: ProgramContext) -> Iterable[Finding]:
        findings: List[Finding] = []
        edges = program.lock_edges
        seen_cycles: Set[frozenset] = set()
        for (a, b), chain in sorted(edges.items()):
            if (b, a) not in edges:
                continue
            key = frozenset((a, b))
            if key in seen_cycles:
                continue
            seen_cycles.add(key)
            path, line = program.edge_anchor[(a, b)]
            reverse = edges[(b, a)]
            evidence = tuple(f"witness {a} -> {b}: {step}"
                             for step in chain)
            evidence += tuple(f"witness {b} -> {a}: {step}"
                              for step in reverse)
            findings.append(Finding(
                rule=self.rule_id, path=path, line=line, col=1,
                message=(f"lock-order inversion between {a} and {b}: "
                         f"this path acquires {b} while holding {a}, but "
                         f"another path acquires {a} while holding {b} — "
                         "two threads taking the two paths concurrently "
                         "deadlock; pick one global order"),
                text=_line_text(program, path, line),
                evidence=evidence))
        # longer cycles (A->B->C->A without any 2-cycle): walk SCCs
        findings.extend(self._long_cycles(program, seen_cycles))
        return findings

    def _long_cycles(self, program: ProgramContext,
                     seen: Set[frozenset]) -> List[Finding]:
        adj: Dict[str, List[str]] = {}
        for a, b in program.lock_edges:
            adj.setdefault(a, []).append(b)
        sccs = _tarjan(adj)
        findings: List[Finding] = []
        for scc in sccs:
            if len(scc) < 3:
                continue  # 2-cycles already reported above
            if any(frozenset(pair) <= set(scc) for pair in seen):
                continue
            cycle = _find_cycle(adj, scc)
            if not cycle:
                continue
            a, b = cycle[0], cycle[1]
            path, line = program.edge_anchor[(a, b)]
            evidence = []
            for i in range(len(cycle)):
                x, y = cycle[i], cycle[(i + 1) % len(cycle)]
                for step in program.lock_edges[(x, y)]:
                    evidence.append(f"witness {x} -> {y}: {step}")
            findings.append(Finding(
                rule=self.rule_id, path=path, line=line, col=1,
                message=(f"lock-order cycle through "
                         f"{' -> '.join(cycle + [cycle[0]])} — threads "
                         "taking different arcs concurrently deadlock"),
                text=_line_text(program, path, line),
                evidence=tuple(evidence)))
        return findings


def _line_text(program: ProgramContext, path: str, line: int) -> str:
    for ctx in program.contexts:
        if ctx.display_path == path:
            return ctx.line_text(line)
    return ""


def _tarjan(adj: Dict[str, List[str]]) -> List[List[str]]:
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    out: List[List[str]] = []
    counter = [0]

    def strongconnect(v: str) -> None:
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        for w in adj.get(v, ()):
            if w not in index:
                strongconnect(w)
                low[v] = min(low[v], low[w])
            elif w in on_stack:
                low[v] = min(low[v], index[w])
        if low[v] == index[v]:
            scc = []
            while True:
                w = stack.pop()
                on_stack.discard(w)
                scc.append(w)
                if w == v:
                    break
            out.append(scc)

    for v in list(adj):
        if v not in index:
            strongconnect(v)
    return out


def _find_cycle(adj: Dict[str, List[str]],
                scc: List[str]) -> List[str]:
    """One simple cycle inside an SCC (DFS)."""
    nodes = set(scc)
    start = sorted(scc)[0]
    path = [start]
    visited = set()

    def dfs(v: str) -> Optional[List[str]]:
        visited.add(v)
        for w in adj.get(v, ()):
            if w not in nodes:
                continue
            if w == start and len(path) > 1:
                return list(path)
            if w not in visited:
                path.append(w)
                found = dfs(w)
                if found:
                    return found
                path.pop()
        return None

    return dfs(start) or []


# -- PH012: blocking call while holding a lock --------------------------------

class BlockingUnderLockRule:
    rule_id = "PH012"
    name = "block-in-lock"
    summary = ("torch host syncs (.item/.tolist/.cpu/.numpy/.to('cpu'), "
               "float/int/bool of a device value, .synchronize) / solver "
               "entry points / time.sleep / os.fsync / joins / event waits "
               "inside a "
               "`with <lock>:` region — every thread contending for the "
               "lock stalls behind the blocked holder")
    program_rule = True

    def check_program(self, program: ProgramContext) -> Iterable[Finding]:
        findings: List[Finding] = []
        self._syncs: Dict[FuncInfo, Dict[ast.Call, str]] = {}
        for fi in program.functions:
            for cs in fi.calls:
                held = cs.eff_held()
                if not held:
                    continue
                reason = self._blocking_reason(program, fi, cs, held)
                if reason is None:
                    continue
                inner = sorted(held)[0]
                findings.append(Finding(
                    rule=self.rule_id, path=fi.ctx.display_path,
                    line=cs.lineno, col=cs.node.col_offset + 1,
                    message=(f"{reason} while holding {inner} in "
                             f"{fi.qual} — move the blocking work outside "
                             "the critical section and publish the result "
                             "under the lock"),
                    text=fi.ctx.line_text(cs.lineno),
                    evidence=(f"locks held: {', '.join(sorted(held))}",)))
        return findings

    def _blocking_reason(self, program: ProgramContext, fi: FuncInfo,
                         cs: CallSite, held: Set[str]) -> Optional[str]:
        func = cs.node.func
        origin = fi.ctx.resolve(func)
        if origin in _BLOCKING_ORIGINS:
            return f"{origin}() blocks"
        sync = self._host_syncs(fi).get(cs.node)
        if sync is not None:
            return sync
        if origin is not None \
                and origin.rsplit(".", 1)[-1] in _SOLVER_NAMES \
                and origin.startswith(program.package + "."):
            return f"solver entry point {origin}() blocks"
        if not isinstance(func, ast.Attribute):
            return None
        attr = func.attr
        if attr in _BLOCKING_ATTRS:
            if attr in ("wait", "wait_for"):
                # condition-variable wait on the HELD lock releases it
                # while waiting: the sanctioned idiom, not a stall
                recv = self._lock_name_of(fi, func.value)
                if recv is not None and recv in held:
                    return None
                return f".{attr}() blocks"
            return f".{attr}() blocks"
        if attr == "join":
            # exclude str.join: literal receivers and iterable-arg calls
            if isinstance(func.value, ast.Constant):
                return None
            args = cs.node.args
            if args and not (isinstance(args[0], ast.Constant)
                             and isinstance(args[0].value, (int, float))):
                return None
            return ".join() blocks until the thread exits"
        if attr == "result" and not cs.node.args:
            return ".result() blocks on the future"
        if attr in _SOLVER_NAMES:
            owners = {f.cls.name
                      for f in program.methods_by_name.get(attr, ())
                      if f.cls is not None}
            if owners:
                return (f"solver/warmup entry .{attr}() "
                        f"(defined on {', '.join(sorted(owners))}) blocks")
        return None

    def _host_syncs(self, fi: FuncInfo) -> Dict[ast.Call, str]:
        """fi's torch host syncs by call node, classified with the device
        values its body holds at each call (PH001's tracker)."""
        if fi in self._syncs:
            return self._syncs[fi]
        out: Dict[ast.Call, str] = {}
        tracker = DeviceTracker(fi.ctx)
        tracker.seed_params(fi.node)

        def on_expr(expr):
            for node in ast.walk(expr):
                if isinstance(node, ast.Call):
                    reason = host_sync(fi.ctx, tracker, node)
                    if reason is not None:
                        out[node] = reason

        tracker.walk(fi.node.body, on_expr)
        self._syncs[fi] = out
        return out

    @staticmethod
    def _lock_name_of(fi: FuncInfo, expr) -> Optional[str]:
        attr = _self_attr(expr)
        if attr is not None and fi.cls is not None \
                and attr in fi.cls.locks:
            return fi.cls.lock_node(attr)
        return None


# -- PH013: check-then-act ----------------------------------------------------

class CheckThenActRule:
    rule_id = "PH013"
    name = "check-then-act"
    summary = ("thread-unsafe lazy init (`if x is None: x = ...` without "
               "the lock; the locked-recheck idiom is compliant) and "
               "unguarded publish of attributes written on a spawned "
               "thread and read elsewhere")
    program_rule = True

    def check_program(self, program: ProgramContext) -> Iterable[Finding]:
        findings: List[Finding] = []
        findings.extend(self._lazy_init(program))
        findings.extend(self._unguarded_publish(program))
        return findings

    # -- (a) lazy init --------------------------------------------------------
    def _lazy_init(self, program: ProgramContext) -> List[Finding]:
        findings: List[Finding] = []
        for fi in program.functions:
            relevant = self._relevant_locks(program, fi)
            if relevant is None:
                continue
            for stmt, held in fi.if_stmts:
                target, negated = self._none_test(fi, stmt.test)
                if target is None:
                    continue
                if set(held) & relevant or fi.extra_held & relevant:
                    continue
                if negated:
                    findings.extend(self._flag_late_write(fi, stmt, target,
                                                          relevant))
                else:
                    findings.extend(self._flag_body_write(fi, stmt, target,
                                                          relevant))
        return findings

    def _relevant_locks(self, program: ProgramContext,
                        fi: FuncInfo) -> Optional[Set[str]]:
        """Lock set that would make a check-then-act safe, or None when
        the function is out of scope (no concurrency in sight)."""
        if fi.cls is not None:
            if not fi.cls.locks and not fi.cls.spawned_roots:
                return None
            return set(fi.cls.lock_nodes) | set(
                program._module_locks[fi.ctx].values())
        module_locks = program._module_locks.get(fi.ctx, {})
        module_has_threads = bool(module_locks) or any(
            c.locks or c.spawned_roots for c in program.classes
            if c.ctx is fi.ctx)
        if not module_has_threads:
            return None
        return set(module_locks.values()) | {
            node for c in program.classes if c.ctx is fi.ctx
            for node in c.lock_nodes}

    def _none_test(self, fi: FuncInfo, test) -> Tuple[Optional[str], bool]:
        """-> (target description, negated).  Matches `self.X is None`,
        `GLOBAL is None`, and the `is not None` early-exit twin."""
        if not (isinstance(test, ast.Compare) and len(test.ops) == 1
                and isinstance(test.ops[0], (ast.Is, ast.IsNot))
                and isinstance(test.comparators[0], ast.Constant)
                and test.comparators[0].value is None):
            return None, False
        negated = isinstance(test.ops[0], ast.IsNot)
        attr = _self_attr(test.left)
        if attr is not None:
            return f"self.{attr}", negated
        if isinstance(test.left, ast.Name):
            # module-global lazy init: only meaningful when the function
            # declares `global X`
            for node in ast.walk(fi.node):
                if isinstance(node, ast.Global) and test.left.id in node.names:
                    return test.left.id, negated
        return None, False

    def _writes_in(self, fi: FuncInfo, target: str, lo: int, hi: int,
                   relevant: Set[str]) -> List[Access]:
        """Unguarded writes of `target` between lines [lo, hi]."""
        if target.startswith("self."):
            attr = target[len("self."):]
            return [a for a in fi.accesses
                    if a.write and a.attr == attr and lo <= a.lineno <= hi
                    and not (set(a.held) | fi.extra_held) & relevant]
        # module global: find Assign statements to the name
        out = []
        for node in ast.walk(fi.node):
            if isinstance(node, ast.Assign) \
                    and any(isinstance(t, ast.Name) and t.id == target
                            for t in node.targets) \
                    and lo <= node.lineno <= hi:
                out.append(Access(target, True, node.lineno,
                                  node.col_offset, (), fi))
        return out

    def _locked_recheck(self, fi: FuncInfo, stmt: ast.If,
                        target: str) -> bool:
        """True when the if-body holds the double-checked idiom: a
        `with <lock>:` whose body re-tests `target is None`."""
        for sub in ast.walk(stmt):
            if not isinstance(sub, ast.With):
                continue
            for inner in ast.walk(sub):
                if isinstance(inner, ast.If):
                    t, neg = self._none_test(fi, inner.test)
                    if t == target and not neg:
                        return True
        return False

    def _flag_body_write(self, fi: FuncInfo, stmt: ast.If, target: str,
                         relevant: Set[str]) -> List[Finding]:
        if self._locked_recheck(fi, stmt, target):
            return []
        end = stmt.body[-1].end_lineno or stmt.body[-1].lineno
        writes = self._writes_in(fi, target, stmt.lineno, end, relevant)
        if not writes:
            return []
        w = writes[0]
        return [Finding(
            rule=self.rule_id, path=fi.ctx.display_path,
            line=stmt.test.lineno, col=stmt.test.col_offset + 1,
            message=(f"check-then-act lazy init of {target} in {fi.qual}: "
                     f"tested here, assigned at line {w.lineno} with no "
                     "lock — two threads can both pass the check and "
                     "double-initialize; use the locked-recheck idiom"),
            text=fi.ctx.line_text(stmt.test.lineno),
            evidence=(f"assignment: {fi.ctx.display_path}:{w.lineno}",))]

    def _flag_late_write(self, fi: FuncInfo, stmt: ast.If, target: str,
                         relevant: Set[str]) -> List[Finding]:
        # `if self._x is not None: return` guard followed by an unguarded
        # assignment later in the function (the start()/close() pattern)
        if not any(isinstance(s, (ast.Return, ast.Raise))
                   for s in stmt.body):
            return []
        end = fi.node.body[-1].end_lineno or fi.node.body[-1].lineno
        writes = self._writes_in(fi, target,
                                 (stmt.end_lineno or stmt.lineno) + 1,
                                 end, relevant)
        if not writes:
            return []
        w = writes[0]
        return [Finding(
            rule=self.rule_id, path=fi.ctx.display_path,
            line=stmt.test.lineno, col=stmt.test.col_offset + 1,
            message=(f"check-then-act on {target} in {fi.qual}: early-exit "
                     f"test here, assigned at line {w.lineno} with no lock "
                     "— two racing callers both pass the test; hold the "
                     "lock across test and assignment"),
            text=fi.ctx.line_text(stmt.test.lineno),
            evidence=(f"assignment: {fi.ctx.display_path}:{w.lineno}",))]

    # -- (b) unguarded publish ------------------------------------------------
    def _unguarded_publish(self, program: ProgramContext) -> List[Finding]:
        findings: List[Finding] = []
        for cls in program.classes:
            if not cls.spawned_roots:
                continue
            guards, atomic, _bad = _resolve_guards(cls)
            root_set = self._root_closure(cls)
            accesses = _class_accesses(cls)
            for attr, acc in sorted(accesses.items()):
                if attr in guards or attr in atomic:
                    continue
                root_writes = [a for a in acc if a.write
                               and a.func in root_set
                               and not a.eff_held()]
                if not root_writes:
                    continue
                outside = [a for a in acc
                           if a.func not in root_set
                           and a.func.name not in _INIT_METHODS]
                if not outside:
                    continue
                w = min(root_writes, key=lambda a: a.lineno)
                o = min(outside, key=lambda a: a.lineno)
                root = cls.spawned_roots[0]
                findings.append(Finding(
                    rule=self.rule_id, path=cls.ctx.display_path,
                    line=w.lineno, col=w.col + 1,
                    message=(f"unguarded publish of {cls.name}.{attr}: "
                             f"written on the {root.qual} thread with no "
                             f"lock and read by {o.func.qual} — guard it "
                             "or declare `# photonlint: "
                             "guarded-by=atomic`"),
                    text=cls.ctx.line_text(w.lineno),
                    evidence=(
                        f"thread root: {root.qual} "
                        f"(threading.Thread target)",
                        f"cross-thread reader: {o.func.qual} "
                        f"({cls.ctx.display_path}:{o.lineno})")))
        return findings

    def _root_closure(self, cls: ClassInfo) -> Set[FuncInfo]:
        out: Set[FuncInfo] = set(cls.spawned_roots)
        frontier = list(out)
        while frontier:
            fi = frontier.pop()
            for cs in fi.calls:
                attr = _self_attr(cs.node.func)
                if attr is not None and attr in cls.methods:
                    callee = cls.methods[attr]
                    if callee not in out:
                        out.add(callee)
                        frontier.append(callee)
        return out


def concurrency_rules() -> List[object]:
    return [GuardedAttributeRule(), LockOrderRule(),
            BlockingUnderLockRule(), CheckThenActRule()]
