"""Source-level AST lint for the threaded runtime + the jit boundary.

``python -m trino_tpu_torch.analysis.lint [paths...] [--fail-on SEVERITY]``

Counterpart of ``trino_tpu/analysis/lint.py``, with the same rules and
findings; its default target is this package and its cross-module
allowlist names this package's modules. The port traces nothing, so the
jit and aot rules find nothing in its tree; they are kept whole so the
two lints agree on any source they are given.

Rule families, each targeting a failure class a threaded engine grows
structurally (lock-ordering faults; a Python side effect inside a
traced function silently runs once at trace time and never again):

**Shared-mutable-state races** (modules that spawn threads —
``server/coordinator.py``, ``server/task_worker.py``,
``exec/remote.py``, ``fte/*`` and anything else that calls
``threading.Thread``/``threading.Timer``):

- ``race-attr-write`` (error): an attribute write rooted at ``self``
  (``self.x = ...``, ``self.x += ...``, ``self.x[k] = ...``) in code
  reachable from a thread target without an enclosing
  ``with self.<lock>`` block.
- ``race-attr-mutate`` (error): a mutating container call
  (``self.xs.append(...)``, ``.add``, ``.pop``, ...) on a
  ``self``-rooted attribute under the same reachability rule.

Reachability is a module-local call graph seeded at every
``threading.Thread(target=...)`` / ``threading.Timer(...,  fn)``
target plus the ``do_*`` request methods of
``BaseHTTPRequestHandler`` subclasses (each request runs on its own
server thread). Calls made inside a ``with <...lock...>`` block
propagate a *locked* context to the callee, so a helper that is only
ever called under the lock is not flagged (the reference pattern:
``probe_once`` mutating ``_Stats`` under the detector lock). Handler
classes' own ``self`` writes are exempt — handler instances are
per-request, thread-local by construction. A ``with`` guard is
recognized by its context expression's last dotted segment containing
``lock`` (``self._lock``, ``st.lock``, ``self._members_lock``, ...).

**jit purity** (``exec/``, ``ops/``, ``parallel/`` — anywhere a
function is passed to ``jax.jit`` / ``shard_map`` or decorated with
them):

- ``jit-impure`` (error): a call with trace-time side effects inside
  the traced function — ``time.*``, ``datetime.now``, ``random.*`` /
  ``np.random.*`` (``jax.random`` is pure and allowed), ``open`` /
  ``print`` / ``input``. These run ONCE at trace time and are baked
  into the compiled program — a cached program replays the first
  trace's clock/sample forever.
- ``jit-closure-mutate`` (warning): mutating a closure variable
  (``results.append(x)`` where ``results`` is free) inside a traced
  function — executed per trace, not per call, which is almost never
  the intent.
- ``aot-unsafe`` (error): data-dependent Python control flow inside a
  traced function — ``.item()`` host syncs, and ``int(x)`` /
  ``float(x)`` / ``bool(x)`` concretizations in ``if``/``while``
  conditions. These already fail lazily at trace time with real data
  (ConcretizationTypeError -> deny-list); on the AOT lower path
  (exec/aot.py — ``jax.jit(fn).lower(avals).compile()`` against
  shape-only avals) there is no data at all, so such a function can
  never be pre-compiled. The rule keeps every cache-eligible program
  AOT-lowerable.

**Metrics hygiene** (every module registering on the process
registry ``METRICS``/``_METRICS``):

- ``metric-missing-help`` (error): a family registered with no help
  text — the exposition's only documentation.
- ``metric-naming`` (error): the ``trino_tpu_`` prefix plus the
  per-kind unit-suffix convention (counters ``_total``, histograms
  ``_seconds``/``_bytes``/..., gauges a unit or counted-noun suffix).
- ``metric-duplicate-registration`` (error, multi-file runs): one
  family registered from two call sites — get-or-create makes it
  legal at runtime, but duplicate definitions drift; define once
  (obs/metrics.py) and import.

**Suppressions** — one line at a time, with a reason::

    self.ended = time.time()  # tt-lint: ignore[race-attr-write] terminal-transition winner is the sole writer

Multiple rules: ``ignore[race-attr-write,race-attr-mutate]``. A
suppression with no trailing justification is itself reported
(``suppression-without-reason``, warning): silencing a race checker
without saying why defeats the point.

Cross-module reachability (``lint_paths`` multi-file runs): thread
seeds stay module-local, but a reachable ``obj.m(...)`` call is ALSO
resolved by method name against classes of the SHARED-RUNTIME callee
modules (``_CROSS_CALLEES``: ``fte/``, ``stage/``, ``obs/metrics.py``,
``obs/trace.py``, ``server/failure.py``,
``server/resourcegroups.py``, ``server/memory.py``) with the
caller's lock context propagated — so the scheduler-thread -> ``fte/spool.py``
edges (``spool.commit``/``release`` from dispatch threads) are
followed and a spool-side unlocked write is flagged in the spool's
file. The callee set is deliberately an allowlist: name-based
receiver matching across the WHOLE tree would drown the signal in
same-name methods of thread-private classes (``session.set`` on a
task-local Session is not ``Gauge.set`` on the process registry);
the allowlisted modules are exactly the ones whose instances cross
thread boundaries by design. Broaden via the ``cross_callees``
parameter (tests pass ``("",)`` to match everything).

Known limits (documented, deliberate): receiver types are matched by
method NAME (same module first, then the callee allowlist), bare-name
calls into other modules (imported functions) are not followed, and
jit bodies are scanned directly (no interprocedural purity
propagation).
"""

from __future__ import annotations

import argparse
import ast
import os
import re
import sys
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

_MUTATORS = frozenset({
    "append", "extend", "insert", "add", "discard", "remove", "pop",
    "popitem", "clear", "update", "setdefault", "appendleft",
    "popleft"})

_IMPURE_ROOTS = {
    "time": "time.* reads the host clock at trace time",
    "_time": "time.* reads the host clock at trace time",
    "random": "the random module draws host entropy at trace time",
}
_IMPURE_DOTTED_PREFIXES = {
    "np.random": "np.random draws host entropy at trace time",
    "numpy.random": "numpy.random draws host entropy at trace time",
    "datetime.datetime.now": "host clock read at trace time",
    "datetime.now": "host clock read at trace time",
}
_IMPURE_BARE = {
    "open": "file I/O inside a traced function",
    "print": "I/O inside a traced function runs once, at trace time",
    "input": "blocking I/O inside a traced function",
}

_SUPPRESS_RE = re.compile(
    r"#\s*tt-lint:\s*ignore\[([A-Za-z0-9_,\- ]+)\]\s*(.*)")


@dataclass
class Finding:
    path: str
    line: int
    col: int
    rule: str
    severity: str          # "error" | "warning"
    message: str
    suppressed: bool = False

    def render(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return (f"{self.path}:{self.line}:{self.col}: "
                f"[{self.severity}] {self.rule}: {self.message}{tag}")


# --------------------------------------------------------------------------
# shared AST helpers
# --------------------------------------------------------------------------

def _dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for nested Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _root_name(node: ast.AST) -> Optional[str]:
    """Base Name of an attribute/subscript chain ('self' for
    self.a.b[k])."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _is_lock_expr(node: ast.AST) -> bool:
    d = _dotted(node)
    if d is None:
        return False
    return "lock" in d.split(".")[-1].lower()


class _FuncInfo:
    """One function/method and its lexical context."""

    __slots__ = ("node", "cls", "parent", "qualname")

    def __init__(self, node: ast.AST, cls: Optional[str],
                 parent: Optional["_FuncInfo"], qualname: str):
        self.node = node          # FunctionDef / AsyncFunctionDef
        self.cls = cls            # enclosing class name (methods +
        #                           functions nested inside methods)
        self.parent = parent
        self.qualname = qualname


class _ModuleIndex(ast.NodeVisitor):
    """Collects functions, classes, and class->methods for one
    module."""

    def __init__(self) -> None:
        self.functions: List[_FuncInfo] = []
        self.by_node: Dict[ast.AST, _FuncInfo] = {}
        self.classes: Dict[str, ast.ClassDef] = {}
        self.methods: Dict[str, List[Tuple[str, _FuncInfo]]] = {}
        self._cls_stack: List[Optional[str]] = [None]
        self._fn_stack: List[Optional[_FuncInfo]] = [None]
        self.handler_classes: Set[str] = set()

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.classes[node.name] = node
        for b in node.bases:
            base = _dotted(b) or ""
            if base.split(".")[-1] == "BaseHTTPRequestHandler":
                self.handler_classes.add(node.name)
        self._cls_stack.append(node.name)
        self.generic_visit(node)
        self._cls_stack.pop()

    def _visit_fn(self, node) -> None:
        cls = self._cls_stack[-1]
        parent = self._fn_stack[-1]
        if parent is not None and cls is not None \
                and parent.cls is not None:
            cls = parent.cls   # nested def inside a method: same class
        qual = (f"{cls}.{node.name}" if cls and parent is None
                else node.name)
        info = _FuncInfo(node, cls, parent, qual)
        self.functions.append(info)
        self.by_node[node] = info
        if cls is not None and parent is None:
            self.methods.setdefault(node.name, []).append((cls, info))
        self._fn_stack.append(info)
        self.generic_visit(node)
        self._fn_stack.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn


# --------------------------------------------------------------------------
# race detector
# --------------------------------------------------------------------------

# shared-runtime modules whose methods thread code in OTHER modules
# calls by design: cross-module edges are followed into these (and only
# these — see the module docstring for why this is an allowlist). Each
# is a module of this package whose instances cross threads:
_CROSS_CALLEES = (
    # the spool, retries, fault points; the exchange and its
    # fetch-once cache
    "fte/", "stage/",
    # the process registry and the span trees that query, task and
    # HTTP threads share
    "obs/metrics.py", "obs/trace.py",
    # admission, pool reservations and the failure detector: dispatch
    # threads call groups.query_finished and memory.reserve at once
    "server/failure.py", "server/resourcegroups.py",
    "server/memory.py",
    # the streamed chunk loop's staging buffers and the shared split
    # scheduler: runner, task and status threads mutate their queues
    "exec/streamjoin.py", "exec/taskexec.py",
    # the OTLP exporter: query threads and the coordinator's HTTP
    # threads both drive export and serialization
    "obs/otlp.py",
    # the fault-point registry fires from dispatch threads, worker HTTP
    # threads and spool commits alike (under fte/ already, listed so
    # narrowing that prefix can never drop it)
    "fte/faultpoints.py",
    # the result cache: query threads fill and hit it while the
    # memory-pressure ladder sheds it
    "exec/resultcache.py",
    # the query history and the learned-stats registry: tracker threads
    # append and observe while status beats merge and handlers read
    "obs/history.py", "exec/learnedstats.py",
    # the scan cache, filled by query and task threads and shed under
    # pressure
    "exec/scancache.py",
    # streaming: ingest HTTP threads append to partition segments while
    # continuous-job threads read windows and commit offsets, and the
    # stream connector's scans run on task threads
    "streaming/", "connectors/stream.py")


class _CrossIndex:
    """Method-name registry over the callee-eligible modules of one
    ``lint_paths`` run: name -> [(owning analyzer, function)]. A
    reachable attribute call resolves here AFTER module-local
    resolution; the walk happens in the OWNING analyzer so findings
    land in the callee's file."""

    def __init__(self) -> None:
        self.methods: Dict[str, List[Tuple["_RaceAnalyzer",
                                           _FuncInfo]]] = {}

    def add_module(self, analyzer: "_RaceAnalyzer") -> None:
        for name, pairs in analyzer.index.methods.items():
            for cls, fi in pairs:
                if cls.startswith("_"):
                    # a private class's instances are module-internal
                    # by convention — they do not cross module
                    # boundaries, so a cross-module name match against
                    # one is definitionally the wrong receiver (e.g.
                    # the detector-lock-guarded _Stats.record vs the
                    # public StragglerDetector.record callers mean)
                    continue
                self.methods.setdefault(name, []).append((analyzer, fi))

    def resolve(self, method: str):
        return self.methods.get(method, ())


class _RaceAnalyzer:
    """Thread-reachability analysis + self-write checks: module-local
    seeding and call graph, plus cross-module edges into a shared
    ``_CrossIndex`` when one is wired (lint_paths)."""

    def __init__(self, tree: ast.Module, path: str):
        self.tree = tree
        self.path = path
        self.index = _ModuleIndex()
        self.index.visit(tree)
        self.findings: List[Finding] = []
        # (function node, locked) states already propagated
        self._visited: Set[Tuple[int, bool]] = set()
        self.cross: Optional[_CrossIndex] = None

    # -- entry discovery ----------------------------------------------
    def _thread_targets(self) -> List[Tuple[_FuncInfo, ast.Call]]:
        out: List[Tuple[_FuncInfo, ast.Call]] = []
        for call in ast.walk(self.tree):
            if not isinstance(call, ast.Call):
                continue
            name = _dotted(call.func) or ""
            base = name.split(".")[-1]
            if base not in ("Thread", "Timer"):
                continue
            target: Optional[ast.AST] = None
            for kw in call.keywords:
                if kw.arg in ("target", "function"):
                    target = kw.value
            if target is None and len(call.args) >= 2:
                # positional forms put the callable at index 1 in BOTH
                # signatures: Thread(group, target, ...) and
                # Timer(interval, function, ...) — args[0] is group/
                # interval, never the target
                target = call.args[1]
            if target is None:
                continue
            scope = self._enclosing_function(call)
            for fi in self._resolve_callable(target, scope):
                out.append((fi, call))
        return out

    def _enclosing_function(self, node: ast.AST) -> Optional[_FuncInfo]:
        # ast has no parent links: find the innermost function whose
        # span contains the node (functions are few per module)
        best: Optional[_FuncInfo] = None
        for fi in self.index.functions:
            f = fi.node
            if f.lineno <= node.lineno <= (f.end_lineno or f.lineno):
                if best is None or f.lineno >= best.node.lineno:
                    best = fi
        return best

    def _resolve_callable(self, expr: ast.AST,
                          scope: Optional[_FuncInfo]
                          ) -> List[_FuncInfo]:
        """Function infos an expression may call into (best effort)."""
        if isinstance(expr, ast.Lambda):
            return []
        if isinstance(expr, ast.Name):
            fi = self._lookup_name(expr.id, scope)
            return [fi] if fi is not None else []
        if isinstance(expr, ast.Attribute):
            root = _root_name(expr.value)
            meth = expr.attr
            if root == "self" and scope is not None \
                    and scope.cls is not None \
                    and isinstance(expr.value, ast.Name):
                for cls, fi in self.index.methods.get(meth, ()):
                    if cls == scope.cls:
                        return [fi]
                return []
            # x.m() / self.obj.m(): match by method name against the
            # module's classes (receiver types are not tracked)
            return [fi for _, fi in self.index.methods.get(meth, ())]
        return []

    def _lookup_name(self, name: str,
                     scope: Optional[_FuncInfo]) -> Optional[_FuncInfo]:
        """Nearest visible def: siblings nested in the same (or an
        enclosing) function, then module-level functions."""
        cur = scope
        while cur is not None:
            for fi in self.index.functions:
                if fi.parent is cur and fi.node.name == name:
                    return fi
            cur = cur.parent
        for fi in self.index.functions:
            if fi.parent is None and fi.cls is None \
                    and fi.node.name == name:
                return fi
        return None

    # -- propagation --------------------------------------------------
    def analyze(self) -> List[Finding]:
        entries: List[_FuncInfo] = [fi for fi, _ in
                                    self._thread_targets()]
        for name, pairs in self.index.methods.items():
            if name.startswith("do_"):
                for cls, fi in pairs:
                    if cls in self.index.handler_classes:
                        entries.append(fi)
        for fi in entries:
            self._walk_function(fi, locked=False)
        return self.findings

    def _walk_function(self, fi: _FuncInfo, locked: bool) -> None:
        # an unlocked visit is strictly stronger than a locked one (it
        # flags everything the locked visit would not), so a locked
        # visit after an unlocked one adds nothing, while an unlocked
        # visit must re-run even after a locked one
        if (id(fi.node), False) in self._visited:
            return
        if locked and (id(fi.node), True) in self._visited:
            return
        self._visited.add((id(fi.node), locked))
        exempt_self = fi.cls in self.index.handler_classes
        self._scan_body(fi, fi.node, locked, exempt_self)

    def _scan_body(self, fi: _FuncInfo, fn_node: ast.AST, locked: bool,
                   exempt_self: bool) -> None:
        own_nested = {f.node for f in self.index.functions
                      if f.parent is fi}

        def scan(node: ast.AST, lock_depth: int) -> None:
            if node in own_nested or isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)) and node is not fn_node:
                return      # nested defs analyzed only when reached
            guarded = locked or lock_depth > 0
            if isinstance(node, ast.With):
                depth = lock_depth + (1 if any(
                    _is_lock_expr(i.context_expr)
                    for i in node.items) else 0)
                for item in node.items:
                    scan(item.context_expr, lock_depth)
                for child in node.body:
                    scan(child, depth)
                return
            if isinstance(node, (ast.Assign, ast.AugAssign,
                                 ast.AnnAssign)) and not guarded \
                    and not exempt_self \
                    and not (isinstance(node, ast.AnnAssign)
                             and node.value is None):
                targets = (node.targets
                           if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if isinstance(t, ast.Tuple):
                        elts = list(t.elts)
                    else:
                        elts = [t]
                    for el in elts:
                        if isinstance(el, (ast.Attribute,
                                           ast.Subscript)) \
                                and _root_name(el) == "self":
                            self._emit(
                                el, "race-attr-write",
                                f"write to '{_target_repr(el)}' is "
                                "reachable from a thread target with "
                                "no enclosing lock")
            if isinstance(node, ast.Call):
                if isinstance(node.func, ast.Attribute) \
                        and node.func.attr in _MUTATORS \
                        and not guarded and not exempt_self \
                        and isinstance(node.func.value,
                                       (ast.Attribute, ast.Subscript)) \
                        and _root_name(node.func.value) == "self":
                    self._emit(
                        node, "race-attr-mutate",
                        f"'{_dotted(node.func) or node.func.attr}(...)'"
                        " mutates shared state reachable from a thread"
                        " target with no enclosing lock")
                for callee in self._resolve_callable(node.func, fi):
                    self._walk_function(callee, locked=guarded)
                if self.cross is not None \
                        and isinstance(node.func, ast.Attribute):
                    # cross-module edge: the scheduler thread calling
                    # spool.commit(...) walks the spool's method in
                    # the spool's analyzer, caller lock context intact
                    for other, cfi in self.cross.resolve(
                            node.func.attr):
                        if other is not self:
                            other._walk_function(cfi, locked=guarded)
            for child in ast.iter_child_nodes(node):
                scan(child, lock_depth)

        for stmt in getattr(fn_node, "body", []):
            scan(stmt, 0)

    def _emit(self, node: ast.AST, rule: str, message: str) -> None:
        self.findings.append(Finding(
            self.path, getattr(node, "lineno", 0),
            getattr(node, "col_offset", 0), rule, "error", message))


def _target_repr(node: ast.AST) -> str:
    d = _dotted(node)
    if d is not None:
        return d
    base = _dotted(getattr(node, "value", None))
    return f"{base}[...]" if base else "self.<attr>"


# --------------------------------------------------------------------------
# jit purity checker
# --------------------------------------------------------------------------

class _JitAnalyzer:
    """Finds functions handed to jax.jit / shard_map and scans their
    bodies for trace-time side effects."""

    def __init__(self, tree: ast.Module, path: str):
        self.tree = tree
        self.path = path
        self.index = _ModuleIndex()
        self.index.visit(tree)
        self.findings: List[Finding] = []

    def analyze(self) -> List[Finding]:
        seen: Set[int] = set()
        for fn in self._traced_functions():
            if id(fn) in seen:
                continue
            seen.add(id(fn))
            self._scan_traced(fn)
        return self.findings

    # -- discovery ----------------------------------------------------
    def _is_jit_name(self, expr: ast.AST) -> bool:
        d = _dotted(expr) or ""
        base = d.split(".")[-1]
        if base in ("jit", "shard_map", "pmap"):
            return True
        # partial(jax.jit, ...) used as a decorator factory
        if isinstance(expr, ast.Call) \
                and (_dotted(expr.func) or "").split(".")[-1] \
                == "partial" and expr.args:
            return self._is_jit_name(expr.args[0])
        return False

    def _traced_functions(self) -> Iterable[ast.AST]:
        for fi in self.index.functions:
            for dec in getattr(fi.node, "decorator_list", []):
                if self._is_jit_name(dec) or (
                        isinstance(dec, ast.Call)
                        and self._is_jit_name(dec.func)):
                    yield fi.node
        for call in ast.walk(self.tree):
            if not isinstance(call, ast.Call) \
                    or not self._is_jit_name(call.func):
                continue
            if not call.args:
                continue
            target = call.args[0]
            if isinstance(target, ast.Lambda):
                yield target
            elif isinstance(target, ast.Name):
                scope = self._enclosing_function(call)
                fi = self._lookup_name(target.id, scope)
                if fi is not None:
                    yield fi.node

    # borrowed resolution helpers (same shapes, no inheritance needed)
    _enclosing_function = _RaceAnalyzer._enclosing_function
    _lookup_name = _RaceAnalyzer._lookup_name

    # -- body scan ----------------------------------------------------
    def _scan_traced(self, fn: ast.AST) -> None:
        local = _local_names(fn)
        for node in ast.walk(fn):
            if isinstance(node, (ast.If, ast.While)):
                # data-dependent Python branch: int(x)/float(x)/bool(x)
                # in the condition concretizes a traced value — lazily
                # a ConcretizationTypeError with real data, a hard
                # impossibility on the AOT lower path (exec/aot.py
                # compiles against shape-only avals: no data to
                # branch on)
                for sub in ast.walk(node.test):
                    if isinstance(sub, ast.Call) \
                            and isinstance(sub.func, ast.Name) \
                            and sub.func.id in ("int", "float",
                                                "bool") \
                            and sub.args \
                            and not isinstance(sub.args[0],
                                               ast.Constant):
                        self._emit(
                            sub, "aot-unsafe", "error",
                            f"'{sub.func.id}(...)' in a branch "
                            "condition inside a traced function "
                            "concretizes a traced value — "
                            "data-dependent Python branches cannot "
                            "be AOT-lowered")
            if isinstance(node, ast.Call):
                d = _dotted(node.func)
                if d is not None:
                    root = d.split(".")[0]
                    why = None
                    if d in _IMPURE_BARE:
                        why = _IMPURE_BARE[d]
                    elif root in _IMPURE_ROOTS and "." in d:
                        why = _IMPURE_ROOTS[root]
                    else:
                        for pref, msg in _IMPURE_DOTTED_PREFIXES \
                                .items():
                            if d == pref or d.startswith(pref + "."):
                                why = msg
                                break
                    if why is not None:
                        self._emit(node, "jit-impure", "error",
                                   f"'{d}' inside a jit/shard_map-"
                                   f"traced function: {why}")
                        continue
                if isinstance(node.func, ast.Attribute) \
                        and node.func.attr == "item" \
                        and not node.args:
                    self._emit(
                        node, "aot-unsafe", "error",
                        f"'{_dotted(node.func) or 'item'}()' inside "
                        "a traced function is a host sync — the AOT "
                        "lower path has no data to sync, so the "
                        "program cannot be compiled ahead of time")
                    continue
                if isinstance(node.func, ast.Attribute) \
                        and node.func.attr in _MUTATORS \
                        and isinstance(node.func.value, ast.Name) \
                        and node.func.value.id not in local:
                    self._emit(
                        node, "jit-closure-mutate", "warning",
                        f"'{node.func.value.id}.{node.func.attr}"
                        "(...)' mutates a closure variable inside a "
                        "traced function — runs at trace time, not "
                        "per call")
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if isinstance(t, ast.Subscript) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id not in local:
                        self._emit(
                            t, "jit-closure-mutate", "warning",
                            f"subscript write to closure variable "
                            f"'{t.value.id}' inside a traced function")

    def _emit(self, node: ast.AST, rule: str, severity: str,
              message: str) -> None:
        self.findings.append(Finding(
            self.path, getattr(node, "lineno", 0),
            getattr(node, "col_offset", 0), rule, severity, message))


# --------------------------------------------------------------------------
# metrics hygiene
# --------------------------------------------------------------------------

# registrations against the process registry only: the singleton's
# canonical names (obs/metrics.py METRICS, imported as _METRICS in
# exec/executor.py). Local test registries (reg = MetricsRegistry())
# are deliberately out of scope.
_METRIC_RECEIVERS = frozenset({"METRICS", "_METRICS"})
_METRIC_KINDS = frozenset({"counter", "gauge", "histogram"})
_METRIC_PREFIX = "trino_tpu_"
# unit-suffix convention per kind (Prometheus naming): counters are
# monotonic totals; histograms carry their unit; gauges name the
# measured quantity (bytes/seconds/...) or the counted noun
_HIST_SUFFIXES = ("_seconds", "_bytes", "_millis", "_nanos")
_GAUGE_SUFFIXES = ("_bytes", "_seconds", "_ratio", "_depth",
                   "_queries", "_workers", "_shapes", "_tasks",
                   "_entries", "_chunks")


@dataclass
class _MetricReg:
    name: str
    kind: str
    path: str
    line: int
    col: int


class _MetricsAnalyzer:
    """Metrics-hygiene pass (gated in tier-1 next to the race/jit
    rules): every family on the process registry must carry non-empty
    help text (``metric-missing-help``) and follow the
    ``trino_tpu_`` prefix + per-kind unit-suffix naming convention
    (``metric-naming``). Registrations are also collected so the
    driver can flag the same family registered from two call sites
    (``metric-duplicate-registration``) — get-or-create makes that
    legal at runtime, but two definitions of one identity WILL drift
    (help text, labels), so the convention is one definition imported
    everywhere (the PR 12 stream families pattern)."""

    def __init__(self, tree: ast.Module, path: str):
        self.tree = tree
        self.path = path
        self.findings: List[Finding] = []
        self.registrations: List[_MetricReg] = []

    def analyze(self) -> List[Finding]:
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call) \
                    or not isinstance(node.func, ast.Attribute) \
                    or node.func.attr not in _METRIC_KINDS:
                continue
            recv = (_dotted(node.func.value) or "").split(".")[-1]
            if recv not in _METRIC_RECEIVERS:
                continue
            kind = node.func.attr
            if not node.args or not isinstance(node.args[0],
                                               ast.Constant) \
                    or not isinstance(node.args[0].value, str):
                continue    # dynamic name: out of the rule's reach
            name = node.args[0].value
            self.registrations.append(_MetricReg(
                name, kind, self.path, node.lineno, node.col_offset))
            self._check_help(node, name)
            self._check_name(node, kind, name)
        return self.findings

    def _check_help(self, node: ast.Call, name: str) -> None:
        help_node = None
        if len(node.args) > 1:
            help_node = node.args[1]
        else:
            for kw in node.keywords:
                if kw.arg == "help":
                    help_node = kw.value
        # only ABSENT or empty-LITERAL help is a violation; a help
        # passed as a name/call is out of the rule's reach, like the
        # dynamic-name case above
        bad = help_node is None or (
            isinstance(help_node, ast.Constant)
            and not str(help_node.value or "").strip())
        if bad:
            self._emit(node, "metric-missing-help",
                       f"metric family '{name}' registered without "
                       "help text — a scraper's only documentation")

    def _check_name(self, node: ast.Call, kind: str,
                    name: str) -> None:
        if not name.startswith(_METRIC_PREFIX):
            self._emit(node, "metric-naming",
                       f"metric family '{name}' must carry the "
                       f"'{_METRIC_PREFIX}' prefix")
            return
        if kind == "counter" and not name.endswith("_total"):
            self._emit(node, "metric-naming",
                       f"counter '{name}' must end in '_total' "
                       "(Prometheus counter convention)")
        elif kind == "histogram" \
                and not name.endswith(_HIST_SUFFIXES):
            self._emit(node, "metric-naming",
                       f"histogram '{name}' must end in a unit "
                       f"suffix {_HIST_SUFFIXES}")
        elif kind == "gauge" and not name.endswith(_GAUGE_SUFFIXES):
            self._emit(node, "metric-naming",
                       f"gauge '{name}' must end in a unit/noun "
                       f"suffix {_GAUGE_SUFFIXES}")

    def _emit(self, node: ast.AST, rule: str, message: str) -> None:
        self.findings.append(Finding(
            self.path, getattr(node, "lineno", 0),
            getattr(node, "col_offset", 0), rule, "error", message))


def _metric_duplicates(regs: Sequence[_MetricReg]) -> List[Finding]:
    """One finding per registration site beyond a family's first
    (ordered by path then line — the first site is the canonical
    definition the others should import)."""
    by_name: Dict[str, List[_MetricReg]] = {}
    for r in regs:
        by_name.setdefault(r.name, []).append(r)
    out: List[Finding] = []
    for name, sites in by_name.items():
        if len(sites) < 2:
            continue
        sites.sort(key=lambda r: (r.path, r.line))
        first = sites[0]
        for r in sites[1:]:
            out.append(Finding(
                r.path, r.line, r.col, "metric-duplicate-registration",
                "error",
                f"metric family '{name}' is already registered at "
                f"{first.path}:{first.line} — import that definition "
                "instead of re-registering (duplicate definitions "
                "drift)"))
    return out


def _local_names(fn: ast.AST) -> Set[str]:
    """Names bound inside ``fn`` (params, assignments, loop/with
    targets, comprehension vars, local imports, nested defs)."""
    names: Set[str] = set()
    args = getattr(fn, "args", None)
    if args is not None:
        for a in (args.posonlyargs + args.args + args.kwonlyargs):
            names.add(a.arg)
        if args.vararg:
            names.add(args.vararg.arg)
        if args.kwarg:
            names.add(args.kwarg.arg)
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and isinstance(
                node.ctx, ast.Store):
            names.add(node.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node is not fn:
            names.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                names.add((alias.asname or alias.name).split(".")[0])
    return names


# --------------------------------------------------------------------------
# suppression handling + driver
# --------------------------------------------------------------------------

def _apply_suppressions(findings: List[Finding],
                        src_lines: Sequence[str],
                        path: str) -> List[Finding]:
    """Mark findings suppressed by their line's tt-lint comment; a
    reason-less suppression is itself a (warning) finding."""
    out = list(findings)
    for i, line in enumerate(src_lines, start=1):
        m = _SUPPRESS_RE.search(line)
        if m is None:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        hit = False
        for f in out:
            if f.path == path and f.line == i and f.rule in rules:
                f.suppressed = True
                hit = True
        if hit and not m.group(2).strip():
            out.append(Finding(
                path, i, line.index("#"), "suppression-without-reason",
                "warning", "tt-lint suppression carries no "
                "justification — say why the race/impurity is safe"))
    return out


def lint_source(src: str, path: str = "<string>") -> List[Finding]:
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 0, e.offset or 0,
                        "syntax-error", "error", str(e))]
    findings = _RaceAnalyzer(tree, path).analyze()
    findings += _JitAnalyzer(tree, path).analyze()
    metrics = _MetricsAnalyzer(tree, path)
    findings += metrics.analyze()
    findings += _metric_duplicates(metrics.registrations)
    findings.sort(key=lambda f: (f.line, f.col, f.rule))
    return _apply_suppressions(findings, src.splitlines(), path)


def lint_paths(paths: Iterable[str],
               cross_callees: Optional[Sequence[str]] = _CROSS_CALLEES
               ) -> List[Finding]:
    """Lint many files with cross-module race reachability: every file
    is indexed first, then thread seeds propagate — following
    attribute calls into methods of the ``cross_callees`` modules (a
    pattern matches by substring of the /-normalized path; None
    disables the cross pass entirely). Findings land in the file that
    owns the flagged write; suppressions apply per file as always."""
    findings: List[Finding] = []
    sources: Dict[str, str] = {}
    analyzers: Dict[str, _RaceAnalyzer] = {}
    trees: Dict[str, ast.Module] = {}
    seen: Set[str] = set()
    files: List[str] = []
    for path in _expand(paths):
        if path in seen:
            continue
        seen.add(path)
        try:
            with open(path, encoding="utf-8") as f:
                src = f.read()
        except OSError as e:
            findings.append(Finding(path, 0, 0, "io-error", "error",
                                    str(e)))
            continue
        try:
            tree = ast.parse(src, filename=path)
        except SyntaxError as e:
            findings.append(Finding(path, e.lineno or 0, e.offset or 0,
                                    "syntax-error", "error", str(e)))
            continue
        files.append(path)
        sources[path] = src
        trees[path] = tree
        analyzers[path] = _RaceAnalyzer(tree, path)
    if cross_callees is not None and len(analyzers) > 1:
        cross = _CrossIndex()
        for path, an in analyzers.items():
            norm = path.replace(os.sep, "/")
            if any(pat in norm for pat in cross_callees):
                cross.add_module(an)
        for an in analyzers.values():
            an.cross = cross
    for an in analyzers.values():
        an.analyze()
    # metrics hygiene: per-file rules, then duplicate-registration
    # detection ACROSS the whole run (the same family registered in
    # two modules is exactly what a single-file pass cannot see)
    all_regs: List[_MetricReg] = []
    metric_findings: Dict[str, List[Finding]] = {}
    for path in files:
        ma = _MetricsAnalyzer(trees[path], path)
        metric_findings[path] = ma.analyze()
        all_regs.extend(ma.registrations)
    for f in _metric_duplicates(all_regs):
        metric_findings.setdefault(f.path, []).append(f)
    # collect AFTER full propagation: a caller module's analyze() may
    # have emitted findings into a callee module's analyzer
    for path in files:
        per_file = list(analyzers[path].findings)
        per_file += _JitAnalyzer(trees[path], path).analyze()
        per_file += metric_findings.get(path, [])
        per_file.sort(key=lambda f: (f.line, f.col, f.rule))
        findings.extend(_apply_suppressions(
            per_file, sources[path].splitlines(), path))
    return findings


def _expand(paths: Iterable[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames
                               if d != "__pycache__"]
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        out.append(os.path.join(dirpath, fn))
        else:
            out.append(p)
    return out


def default_root() -> str:
    """The trino_tpu_torch package directory (the default lint
    target)."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m trino_tpu_torch.analysis.lint",
        description="Concurrency + jit-purity lint for trino_tpu_torch.")
    parser.add_argument("paths", nargs="*",
                        help="files/directories (default: the "
                             "trino_tpu_torch package)")
    parser.add_argument("--fail-on", choices=("error", "warning",
                                              "none"),
                        default="error",
                        help="exit non-zero when unsuppressed findings"
                             " at/above this severity exist "
                             "(default: error)")
    parser.add_argument("--show-suppressed", action="store_true",
                        help="also print suppressed findings")
    args = parser.parse_args(argv)
    paths = args.paths or [default_root()]
    findings = lint_paths(paths)
    active = [f for f in findings if not f.suppressed]
    shown = findings if args.show_suppressed else active
    for f in shown:
        print(f.render())
    n_err = sum(1 for f in active if f.severity == "error")
    n_warn = sum(1 for f in active if f.severity == "warning")
    n_sup = sum(1 for f in findings if f.suppressed)
    print(f"{len(active)} finding(s): {n_err} error(s), "
          f"{n_warn} warning(s); {n_sup} suppressed")
    if args.fail_on == "none":
        return 0
    if args.fail_on == "warning" and (n_err or n_warn):
        return 1
    if args.fail_on == "error" and n_err:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
