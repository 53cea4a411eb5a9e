"""Phase 1 of the whole-program pass: the project symbol graph.

``cclint`` grew up as a per-file rule pack; the interprocedural rules
(``cross-module-lock``, ``jax-transitive``, ``deadline-propagation``,
``journal-schema``) need a view that crosses the function and file
boundary.  This module extracts ONE picklable :class:`ModuleSummary`
per file — imports, classes (locks, attribute types), functions (call
sites with held-context info, attribute accesses, host-sync ops,
membership of the captured step and its ``torch.cuda.graph`` blocks,
event emits), config keys — and assembles the summaries
into a :class:`SymbolGraph` with import resolution and reverse
dependencies.  ``callgraph.py`` layers call edges and reachability on
top.

Summaries are pure data (no AST references), so they cache: the driver
stores them under ``.cclint_torch_cache/`` keyed by file content hash, salted
with a hash of the lint package's own sources (editing any rule
invalidates everything).  A warm run re-extracts nothing and re-parses
only changed files; the whole-program phase then rebuilds the graph
from summaries in milliseconds, which keeps the package-wide pass
inside the budget ``tests/test_torch_cclint_package.py`` sets.

Approximations (documented in docs/STATIC_ANALYSIS.md and
docs/STATIC_ANALYSIS_TORCH.md): receiver types
come from constructor assignments (``x = ClassName(...)``,
``self._y = ClassName(...)``), parameter annotations, and
``var = self`` aliasing — not from dataflow; calls through containers,
dynamic dispatch, and monkey-patching are invisible."""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import pathlib
from typing import Dict, List, Optional, Sequence, Set, Tuple

from cruise_control_tpu_torch.devtools.lint import cfg as cfg_mod
from cruise_control_tpu_torch.devtools.lint import rules_config

#: bump (or just edit any lint source — the salt covers it) to drop
#: cached summaries whose shape this module no longer understands
SUMMARY_VERSION = 2

#: the port's host syncs (torch): a tensor read back, or a wait for the
#: card (``torch.cuda.synchronize``, a Stream's or Event's)
SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
_NP_MODULES = {"np", "numpy", "onp"}
_NP_SYNC_FUNCS = {"asarray", "array"}
_LOCK_CTORS = {"Lock", "RLock", "Condition", "InstrumentedLock"}
_SAFE_CTORS = {"Event", "Semaphore", "BoundedSemaphore", "Barrier",
               "InstrumentedSemaphore",
               "Queue", "SimpleQueue", "LifoQueue", "PriorityQueue",
               "ThreadPoolExecutor", "ProcessPoolExecutor"}
_MUTATORS = {"append", "appendleft", "extend", "extendleft", "insert",
             "add", "update", "setdefault", "pop", "popleft", "popitem",
             "remove", "discard", "clear", "sort", "reverse", "rotate"}
#: callee-name pattern for compile-cache-key factories whose config
#: argument is normalized via dataclasses.replace(...)
_CACHE_FN_HINTS = ("_cached_", "_fn_cache", "cache_key")


# ---- summary records (all picklable, no AST) ------------------------------------
@dataclasses.dataclass(frozen=True)
class CallSite:
    callee: str                  # dotted as written: "f", "mod.f", "self._x.m"
    lineno: int
    nargs: int                   # positional arg count
    kwargs: Tuple[str, ...]      # keyword names present
    none_kwargs: Tuple[str, ...]  # keywords whose value is literal None
    arg_exprs: Tuple[str, ...]   # dotted reprs of the first args ("" = complex)
    with_ctxs: Tuple[str, ...]   # dotted with-contexts held at this site
    first_arg_false: bool = False  # first positional arg is literal False
    spawned: bool = False        # synthesized Thread(target=...) edge —
    #                              the callee runs on ANOTHER thread


@dataclasses.dataclass(frozen=True)
class AttrAccess:
    recv: str                    # "self", "x", "self._y" (dotted receiver)
    attr: str
    write: bool
    lineno: int
    with_ctxs: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class EmitSite:
    callee: str                  # "events.emit", "emit", "self._journal.emit"
    lineno: int
    kind: Optional[str]          # literal kind, None when dynamic
    fields: Tuple[str, ...]      # payload keyword names
    star: bool                   # **kwargs present → field set unknown
    severity: Optional[str]      # literal severity keyword, if any


@dataclasses.dataclass(frozen=True)
class BlockingOp:
    """One potentially blocking operation (I/O, unbounded wait, host
    sync).  ``kind`` gates applicability: "" is unconditional, "queue"
    requires the receiver to resolve to a queue type, "wait" marks a
    wait that releases its own condition lock while blocked."""

    lineno: int
    callee: str                  # dotted as written ("self._fh.flush")
    desc: str
    kind: str = ""


@dataclasses.dataclass
class FuncSummary:
    name: str                    # "f", "C.m", "start>Handler.do_GET"
    cls: Optional[str]           # innermost enclosing class name
    lineno: int
    params: Tuple[str, ...]
    annotations: Dict[str, str]  # param → dotted type as written
    calls: List[CallSite] = dataclasses.field(default_factory=list)
    accesses: List[AttrAccess] = dataclasses.field(default_factory=list)
    var_types: Dict[str, str] = dataclasses.field(default_factory=dict)
    sync_ops: List[Tuple[int, str]] = dataclasses.field(default_factory=list)
    attr_reads: List[Tuple[str, str, int]] = dataclasses.field(
        default_factory=list)          # (recv Name, attr, lineno)
    is_jit: bool = False
    static_params: Tuple[str, ...] = ()
    #: local/global lock bindings: var name → InstrumentedLock name literal
    lock_names: Dict[str, str] = dataclasses.field(default_factory=dict)
    blocking_ops: List[BlockingOp] = dataclasses.field(default_factory=list)
    #: ``return <call>(...)`` facts: (dotted callee, dotted first
    #: positional arg or None) — lockflow resolves context-manager
    #: factories (the model-generation-lock idiom) through these
    returns_calls: List[Tuple[str, Optional[str]]] = dataclasses.field(
        default_factory=list)
    #: control-flow graph, present only for functions with lock events
    cfg: Optional[cfg_mod.CFG] = None
    #: (first, last) lines of each ``with torch.cuda.graph(...)`` block
    #: in this function's own body: captured code, hot like a root
    captured_spans: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)


@dataclasses.dataclass
class ClassSummary:
    name: str
    lineno: int
    bases: Tuple[str, ...]
    lock_attrs: Set[str] = dataclasses.field(default_factory=set)
    safe_attrs: Set[str] = dataclasses.field(default_factory=set)
    attr_types: Dict[str, str] = dataclasses.field(default_factory=dict)
    methods: Set[str] = dataclasses.field(default_factory=set)
    #: attr → InstrumentedLock/Semaphore name literal (Condition-wrapped
    #: locks resolve to the wrapped lock's name)
    lock_names: Dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class WallClockSite:
    """One ``time.time()``/``time.monotonic()``/argless ``datetime.now()``
    call, with the context the wall-clock-discipline rule scopes on."""

    lineno: int
    call: str                    # dotted callee as written
    func: str                    # innermost enclosing function name ("" =
    #                              module level)
    clock_param: bool            # an enclosing function takes an injected
    #                              clock/now parameter
    guarded: bool                # the documented `X if X is None else X`
    #                              wall-clock-as-fallback idiom


@dataclasses.dataclass
class ModuleSummary:
    path: str                                   # repo-relative (driver sets)
    module: Optional[str]                       # dotted name (driver sets)
    #: raw import records: (level, from_module or None, name, alias)
    imports: List[Tuple[int, Optional[str], str, str]] = dataclasses.field(
        default_factory=list)
    functions: Dict[str, FuncSummary] = dataclasses.field(
        default_factory=dict)
    classes: Dict[str, ClassSummary] = dataclasses.field(
        default_factory=dict)
    config_keys: List[Tuple[str, int]] = dataclasses.field(
        default_factory=list)
    emits: List[EmitSite] = dataclasses.field(default_factory=list)
    #: compile-cache-key normalization sites: (lineno, excluded key names)
    normalized_keys: List[Tuple[int, Tuple[str, ...]]] = dataclasses.field(
        default_factory=list)
    #: wall-clock reads (rules_wallclock consumes these in phase 2)
    wallclock_sites: List[WallClockSite] = dataclasses.field(
        default_factory=list)


# ---- dotted-expression helpers --------------------------------------------------
def dotted(node: ast.expr) -> Optional[str]:
    """``a.b.c`` → "a.b.c" for pure Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def anno_to_dotted(node: ast.expr) -> Optional[str]:
    """Annotation → dotted type: plain chains, forward-ref strings
    ("CruiseControlFacade"), and Optional[X] unwrapped to X."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        v = node.value.strip()
        return v if v.replace(".", "").replace("_", "").isalnum() else None
    if isinstance(node, ast.Subscript):
        head = dotted(node.value)
        if head and head.rsplit(".", 1)[-1] == "Optional":
            return anno_to_dotted(node.slice)
        return None
    return dotted(node)


def _lock_name_of(value: ast.expr) -> Optional[str]:
    """The name literal of an ``InstrumentedLock("name")`` /
    ``InstrumentedSemaphore(n, name="name")`` constructor, unwrapping
    ``Condition(InstrumentedLock("name"))`` — the named-lock vocabulary
    the concurrency rules order on."""
    if not isinstance(value, ast.Call):
        return None
    f = dotted(value.func)
    if f is None:
        return None
    tail = f.rsplit(".", 1)[-1]
    if tail in ("InstrumentedLock", "InstrumentedSemaphore"):
        for kw in value.keywords:
            if kw.arg == "name" and isinstance(kw.value, ast.Constant) \
                    and isinstance(kw.value.value, str):
                return kw.value.value
    if tail == "InstrumentedLock":
        if value.args and isinstance(value.args[0], ast.Constant) \
                and isinstance(value.args[0].value, str):
            return value.args[0].value
    elif tail == "InstrumentedSemaphore":
        if len(value.args) >= 2 and isinstance(value.args[1], ast.Constant) \
                and isinstance(value.args[1].value, str):
            return value.args[1].value
    elif tail == "Condition" and value.args:
        return _lock_name_of(value.args[0])
    return None


def _with_ctx_expr(item: ast.withitem) -> Optional[str]:
    """The dotted string a with-item holds: a plain dotted expr for
    ``with self._lock:``, the call's dotted func for
    ``with deadline_scope(...):`` / ``with self.admission.admit(c):``."""
    expr = item.context_expr
    d = dotted(expr)
    if d is not None:
        return d
    if isinstance(expr, ast.Call):
        return dotted(expr.func)
    return None


def module_name_for(path: pathlib.Path) -> Tuple[Optional[str], pathlib.Path]:
    """(dotted module name, package root dir) by ascending while
    ``__init__.py`` exists — works for the real package and for fixture
    packages in tmp dirs alike.  A bare file outside any package gets its
    stem as module name and its parent as root."""
    path = path.resolve()
    parts = [path.stem] if path.name != "__init__.py" else []
    cur = path.parent
    while (cur / "__init__.py").exists():
        parts.insert(0, cur.name)
        nxt = cur.parent
        if nxt == cur:
            break
        cur = nxt
    if not parts:
        parts = [path.parent.name]
    return ".".join(parts), cur


# ---- extraction -----------------------------------------------------------------
class _Extractor:
    """One pass over a module tree producing a ModuleSummary."""

    def __init__(self, tree: ast.Module, jit_funcs=None,
                 capture_names: Optional[Set[str]] = None):
        self.summary = ModuleSummary(path="", module=None)
        #: AST FunctionDef → (non-tensor param names) for hot contexts,
        #: from rules_jax.find_jit_functions (shared, single source of
        #: truth)
        self._jit: Dict[ast.AST, Set[str]] = dict(jit_funcs or ())
        #: this module's spellings of ``torch.cuda.graph``
        self._capture = capture_names or set()
        self._scan_module(tree)

    # -- scope walk -------------------------------------------------------------
    # Function keys encode the lexical nesting: a method is
    # ``ClassKey.name``, a nested def is ``parentkey>name``, a class
    # defined inside a function keys as ``parentkey>ClassName`` (so the
    # Handler-inside-start() idiom resolves).  Closure lookups ascend by
    # splitting on ``>``.
    _MODULE_KEY = "<module>"

    def _scan_module(self, tree: ast.Module) -> None:
        for stmt in tree.body:
            if isinstance(stmt, (ast.Import, ast.ImportFrom)):
                self._record_import(stmt)
            elif isinstance(stmt, ast.If):
                # `if TYPE_CHECKING:` (and try/except import fallbacks
                # one level down) still bind names the resolver needs
                for sub in stmt.body + stmt.orelse:
                    if isinstance(sub, (ast.Import, ast.ImportFrom)):
                        self._record_import(sub)
                rec = self._module_func()
                self._scan_stmt(stmt, rec, (), cls_key=None,
                                func_key=self._MODULE_KEY)
            elif isinstance(stmt, ast.ClassDef):
                self._scan_class(stmt, prefix="")
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._scan_function(stmt, cls_key=None, prefix="", sep="")
            else:
                rec = self._module_func()
                self._scan_stmt(stmt, rec, (), cls_key=None,
                                func_key=self._MODULE_KEY)

    def _module_func(self) -> FuncSummary:
        key = self._MODULE_KEY
        if key not in self.summary.functions:
            self.summary.functions[key] = FuncSummary(
                name=key, cls=None, lineno=0, params=(), annotations={})
        return self.summary.functions[key]

    def _record_import(self, stmt) -> None:
        if isinstance(stmt, ast.Import):
            for a in stmt.names:
                alias = a.asname or a.name.split(".")[0]
                target = a.name if a.asname else a.name.split(".")[0]
                self.summary.imports.append((0, None, target, alias))
        else:
            mod = stmt.module or ""
            for a in stmt.names:
                if a.name == "*":
                    continue
                self.summary.imports.append(
                    (stmt.level, mod, a.name, a.asname or a.name))

    def _scan_class(self, cls: ast.ClassDef, prefix: str) -> None:
        key = f"{prefix}>{cls.name}" if prefix else cls.name
        rec = ClassSummary(
            name=key, lineno=cls.lineno,
            bases=tuple(d for d in (dotted(b) for b in cls.bases) if d),
        )
        self.summary.classes[key] = rec
        for stmt in cls.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                rec.methods.add(stmt.name)
                self._scan_function(stmt, cls_key=key, prefix=key, sep=".")
            elif isinstance(stmt, ast.ClassDef):
                self._scan_class(stmt, prefix)

    def _scan_function(self, fn, cls_key: Optional[str], prefix: str,
                       sep: str) -> None:
        key = f"{prefix}{sep}{fn.name}" if prefix else fn.name
        args = fn.args
        params = tuple(a.arg for a in args.posonlyargs + args.args
                       + args.kwonlyargs)
        annos = {
            a.arg: d
            for a in args.posonlyargs + args.args + args.kwonlyargs
            if a.annotation is not None
            and (d := anno_to_dotted(a.annotation)) is not None
        }
        rec = FuncSummary(name=key, cls=cls_key, lineno=fn.lineno,
                          params=params, annotations=annos)
        if fn in self._jit:
            rec.is_jit = True
            rec.static_params = tuple(sorted(self._jit[fn]))
        self.summary.functions[key] = rec
        for stmt in fn.body:
            self._scan_stmt(stmt, rec, (), cls_key=cls_key, func_key=key)
        # flow-sensitive rules need real control flow wherever locks are
        # touched; everything else stays summary-only (held = ∅)
        if cfg_mod.has_lock_events(fn):
            rec.cfg = cfg_mod.build_cfg(fn)

    # -- statement walk with held with-contexts --
    def _scan_stmt(self, node: ast.stmt, rec: FuncSummary,
                   held: Tuple[str, ...], cls_key: Optional[str],
                   func_key: str) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested def: its body runs later on whatever thread calls it
            self._scan_function(node, cls_key=cls_key, prefix=func_key,
                                sep=">")
            return
        if isinstance(node, ast.ClassDef):
            self._scan_class(node, prefix=func_key)
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            ctxs = tuple(c for c in (_with_ctx_expr(i) for i in node.items)
                         if c)
            if any(isinstance(i.context_expr, ast.Call)
                   and dotted(i.context_expr.func) in self._capture
                   for i in node.items):
                rec.captured_spans.append((node.lineno, node.end_lineno))
            for i in node.items:
                self._scan_expr(i.context_expr, rec, held)
            inner = held + ctxs
            for stmt in node.body:
                self._scan_stmt(stmt, rec, inner, cls_key, func_key)
            return
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            value = node.value
            if value is not None:
                self._scan_expr(value, rec, held)
                self._note_binding(targets, value, rec)
                self._note_key_normalization(targets, value)
            for tgt in targets:
                self._scan_target(tgt, rec, held)
            return
        if isinstance(node, ast.Delete):
            for tgt in node.targets:
                self._scan_target(tgt, rec, held)
            return
        if isinstance(node, ast.Return):
            # record `return Ctor(arg, ...)` so lockflow can resolve
            # context-manager factories (a function that wraps a lock in
            # a guard object and returns it — the model-generation-lock
            # idiom) back to the lock the guard's __enter__ acquires
            if isinstance(node.value, ast.Call):
                f = dotted(node.value.func)
                if f is not None:
                    arg = (dotted(node.value.args[0])
                           if node.value.args else None)
                    rec.returns_calls.append((f, arg))
            if node.value is not None:
                self._scan_expr(node.value, rec, held)
            return
        # compound statements: recurse with the same held set
        for field in ("body", "orelse", "finalbody"):
            for stmt in getattr(node, field, ()):
                self._scan_stmt(stmt, rec, held, cls_key, func_key)
        for handler in getattr(node, "handlers", ()):
            for stmt in handler.body:
                self._scan_stmt(stmt, rec, held, cls_key, func_key)
        for field in ("test", "iter", "value", "exc", "msg"):
            child = getattr(node, field, None)
            if isinstance(child, ast.expr):
                self._scan_expr(child, rec, held)

    def _note_binding(self, targets, value: ast.expr,
                      rec: FuncSummary) -> None:
        """Record receiver-type facts: ``x = ClassName(...)``,
        ``self._y = Lock()`` (class attr kinds), ``alias = self``,
        ``self.tasks = param or Ctor()`` (either operand types it), and
        ``self.cc = param`` when the parameter is annotated."""
        if isinstance(value, ast.BoolOp):
            operand = next(
                (v for v in value.values if isinstance(v, ast.Call)),
                next((v for v in value.values
                      if isinstance(v, ast.Name)), None))
            if operand is not None:
                self._note_binding(targets, operand, rec)
            return
        ctor = None
        if isinstance(value, ast.Call):
            ctor = dotted(value.func)
        elif isinstance(value, ast.Name) and value.id in rec.params:
            ctor = rec.annotations.get(value.id)
        is_self = isinstance(value, ast.Name) and value.id == "self"
        lock_name = _lock_name_of(value)
        for tgt in targets:
            if isinstance(tgt, ast.Name):
                if ctor is not None:
                    rec.var_types[tgt.id] = ctor
                elif is_self:
                    rec.var_types[tgt.id] = "<self>"
                if lock_name is not None:
                    rec.lock_names[tgt.id] = lock_name
            elif isinstance(tgt, ast.Attribute):
                d = dotted(tgt)
                if d is None or ctor is None:
                    continue
                if d.startswith("self.") and d.count(".") == 1 \
                        and rec.cls is not None:
                    attr = d.split(".", 1)[1]
                    csum = self.summary.classes.get(rec.cls)
                    if csum is not None:
                        tail = ctor.rsplit(".", 1)[-1]
                        if lock_name is not None:
                            csum.lock_names.setdefault(attr, lock_name)
                        if tail in _LOCK_CTORS:
                            csum.lock_attrs.add(attr)
                        elif tail in _SAFE_CTORS:
                            csum.safe_attrs.add(attr)
                            # the ctor is still a type fact: the
                            # blocking rule needs queue-typed receivers
                            csum.attr_types.setdefault(attr, ctor)
                        else:
                            csum.attr_types.setdefault(attr, ctor)

    def _note_key_normalization(self, targets, value: ast.expr) -> None:
        """The port keys its kept step loop on a tuple, ``key = (...,
        dataclasses.replace(cfg, time_budget_s=0.0, ...), ...)``: a
        ``dataclasses.replace`` inside a value bound to a ``*key`` name
        declares those fields normalized out of the key, as the
        reference's ``_cached_*`` factory argument does."""
        if not any(isinstance(t, ast.Name) and t.id.endswith("key")
                   for t in targets):
            return
        for node in ast.walk(value):
            if isinstance(node, ast.Call) \
                    and dotted(node.func) in ("dataclasses.replace",
                                              "replace"):
                keys = tuple(kw.arg for kw in node.keywords if kw.arg)
                if keys:
                    self.summary.normalized_keys.append((node.lineno, keys))

    def _scan_target(self, tgt: ast.expr, rec: FuncSummary,
                     held: Tuple[str, ...]) -> None:
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._scan_target(el, rec, held)
            return
        node = tgt
        while isinstance(node, ast.Subscript):
            self._scan_expr(node.slice, rec, held)
            node = node.value
        d = dotted(node)
        if d is not None and "." in d:
            recv, attr = d.rsplit(".", 1)
            rec.accesses.append(AttrAccess(recv, attr, True,
                                           tgt.lineno, held))

    # -- expression walk --
    def _scan_expr(self, expr: ast.expr, rec: FuncSummary,
                   held: Tuple[str, ...]) -> None:
        nodes = list(ast.walk(expr))
        # a call's func attribute is the call site, not an attribute
        # read (self._shed(...) must not make _shed a "guarded attr")
        call_funcs = {id(n.func) for n in nodes
                      if isinstance(n, ast.Call)}
        for node in nodes:
            if isinstance(node, ast.Call):
                self._note_call(node, rec, held)
            elif isinstance(node, ast.Attribute) \
                    and id(node) not in call_funcs \
                    and isinstance(node.ctx, ast.Load):
                d = dotted(node)
                if d is None:
                    continue
                recv, attr = d.rsplit(".", 1)
                if recv == "self":
                    rec.accesses.append(AttrAccess(recv, attr, False,
                                                   node.lineno, held))
                elif "." not in recv:
                    rec.attr_reads.append((recv, attr, node.lineno))
            elif isinstance(node, (ast.Lambda,)):
                pass  # lambdas stay opaque (documented blind spot)

    def _note_call(self, node: ast.Call, rec: FuncSummary,
                   held: Tuple[str, ...]) -> None:
        callee = dotted(node.func)
        if callee is None:
            # a sync on a computed receiver (``x.sum().item()``,
            # ``torch.cuda.current_stream().synchronize()``) is a sync
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in SYNC_METHODS:
                desc = f".{f.attr}() host sync"
                rec.sync_ops.append((node.lineno, desc))
                if f.attr in ("item", "synchronize") and not node.args:
                    rec.blocking_ops.append(
                        BlockingOp(node.lineno, f".{f.attr}", desc))
            return
        tail = callee.rsplit(".", 1)[-1]
        # mutator calls on a dotted receiver are attribute writes
        if tail in _MUTATORS and "." in callee:
            base = callee.rsplit(".", 1)[0]
            if "." in base:
                recv, attr = base.rsplit(".", 1)
                rec.accesses.append(AttrAccess(recv, attr, True,
                                               node.lineno, held))
        kwargs = tuple(kw.arg for kw in node.keywords if kw.arg)
        none_kwargs = tuple(
            kw.arg for kw in node.keywords
            if kw.arg and isinstance(kw.value, ast.Constant)
            and kw.value.value is None
        )
        arg_exprs = tuple(dotted(a) or "" for a in node.args[:4])
        first_false = bool(
            node.args and isinstance(node.args[0], ast.Constant)
            and node.args[0].value is False
        )
        rec.calls.append(CallSite(
            callee=callee, lineno=node.lineno, nargs=len(node.args),
            kwargs=kwargs, none_kwargs=none_kwargs, arg_exprs=arg_exprs,
            with_ctxs=held, first_arg_false=first_false,
        ))
        # Thread(target=f): surface the target as an arg expr so the
        # call graph can treat it as called (kwarg order-independent)
        if tail == "Thread":
            for kw in node.keywords:
                if kw.arg == "target" and (d := dotted(kw.value)):
                    rec.calls.append(CallSite(
                        callee=d, lineno=node.lineno, nargs=0, kwargs=(),
                        none_kwargs=(), arg_exprs=(), with_ctxs=(),
                        spawned=True,
                    ))
        self._note_blocking(node, callee, tail, kwargs, rec)
        # host-sync ops, recorded for EVERY function: the transitive
        # rule decides whether the captured step reaches them
        if tail == "synchronize" and isinstance(node.func, ast.Attribute):
            rec.sync_ops.append(
                (node.lineno, f"{callee}() waits for the device"))
        elif tail in SYNC_METHODS and isinstance(node.func, ast.Attribute):
            rec.sync_ops.append((node.lineno, f".{tail}() host sync"))
        elif callee.endswith("mesh_budget.fetch"):
            rec.sync_ops.append(
                (node.lineno, "mesh_budget.fetch() host read"))
        elif tail in _NP_SYNC_FUNCS and "." in callee \
                and callee.split(".", 1)[0] in _NP_MODULES:
            rec.sync_ops.append(
                (node.lineno, f"{callee}() materializes on host"))
        # events.emit(...) sites for the journal-schema rule
        if tail == "emit":
            kind = None
            if node.args and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                kind = node.args[0].value
            severity = None
            fields = []
            for kw in node.keywords:
                if kw.arg == "severity":
                    if isinstance(kw.value, ast.Constant):
                        severity = kw.value.value
                elif kw.arg in ("operation", "task_id", "kind"):
                    if kw.arg == "kind" and kind is None \
                            and isinstance(kw.value, ast.Constant):
                        kind = kw.value.value
                elif kw.arg is not None:
                    fields.append(kw.arg)
            if len(node.args) >= 2 and severity is None \
                    and isinstance(node.args[1], ast.Constant):
                severity = node.args[1].value
            self.summary.emits.append(EmitSite(
                callee=callee, lineno=node.lineno, kind=kind,
                fields=tuple(fields),
                star=any(kw.arg is None for kw in node.keywords),
                severity=severity,
            ))
        # config getter call sites (rules_config consumes these)
        if isinstance(node.func, ast.Attribute):
            claimed = tail in rules_config._TYPED_GETTERS
            if not claimed and tail == "get":
                recv = node.func.value
                name = (recv.id if isinstance(recv, ast.Name)
                        else recv.attr if isinstance(recv, ast.Attribute)
                        else None)
                claimed = name in rules_config._CONFIG_RECEIVERS
            if claimed and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                self.summary.config_keys.append(
                    (node.args[0].value, node.args[0].lineno))
        # compile-cache-key normalization: a *_cached_* factory taking a
        # dataclasses.replace(cfg, k=..., ...) argument declares k
        # excluded from the compile cache key
        if any(h in callee for h in _CACHE_FN_HINTS):
            for a in node.args:
                if isinstance(a, ast.Call) \
                        and dotted(a.func) in ("dataclasses.replace",
                                               "replace"):
                    keys = tuple(kw.arg for kw in a.keywords if kw.arg)
                    if keys:
                        self.summary.normalized_keys.append(
                            (node.lineno, keys))


    #: socket-shaped method tails (blocking network I/O)
    _SOCKET_TAILS = frozenset((
        "sendall", "recv", "recvfrom", "accept", "connect", "sendto",
    ))

    def _note_blocking(self, node: ast.Call, callee: str, tail: str,
                       kwargs: Tuple[str, ...], rec: FuncSummary) -> None:
        """Record the blocking-op vocabulary for rules_blocking: journal
        flush/fsync, socket I/O, host syncs, unbounded waits/joins and
        queue ops.  Bounded variants (a timeout argument) don't block
        indefinitely and are not recorded."""
        lineno = node.lineno
        ops = rec.blocking_ops
        if "." not in callee and tail != "sleep":
            return
        if tail == "flush" and not node.args:
            ops.append(BlockingOp(lineno, callee, "flush() file I/O"))
        elif tail == "fsync":
            ops.append(BlockingOp(lineno, callee, "fsync() disk barrier"))
        elif tail in self._SOCKET_TAILS:
            ops.append(BlockingOp(lineno, callee,
                                  f".{tail}() socket I/O"))
        elif callee == "time.sleep" or (tail == "sleep"
                                        and callee.endswith("time.sleep")):
            ops.append(BlockingOp(lineno, callee, "time.sleep()"))
        elif tail == "device_get":
            ops.append(BlockingOp(lineno, callee,
                                  "jax.device_get host sync"))
        elif tail == "synchronize" and not node.args:
            ops.append(BlockingOp(lineno, callee,
                                  f"{callee}() host sync"))
        elif tail == "item" and not node.args:
            ops.append(BlockingOp(lineno, callee, ".item() host sync"))
        elif callee.endswith("mesh_budget.fetch"):
            ops.append(BlockingOp(lineno, callee,
                                  "mesh_budget.fetch() host read"))
        elif tail == "block_until_ready":
            ops.append(BlockingOp(lineno, callee,
                                  ".block_until_ready() host sync"))
        elif tail == "wait" and not node.args and "timeout" not in kwargs:
            ops.append(BlockingOp(lineno, callee, "unbounded .wait()",
                                  kind="wait"))
        elif tail == "join" and not node.args and "timeout" not in kwargs:
            # zero-arg filter excludes str.join / os.path.join
            ops.append(BlockingOp(lineno, callee, "unbounded .join()"))
        elif tail == "result" and not node.args \
                and "timeout" not in kwargs:
            ops.append(BlockingOp(lineno, callee,
                                  "unbounded Future.result()"))
        elif tail == "get" and not node.args and not kwargs:
            ops.append(BlockingOp(lineno, callee, "blocking queue get()",
                                  kind="queue"))
        elif tail == "put" and "block" not in kwargs \
                and not node.keywords:
            ops.append(BlockingOp(lineno, callee, "blocking queue put()",
                                  kind="queue"))


#: parameter names that mark a function as receiving an injected clock —
#: inside such a function a direct wall-clock read is drift by definition
CLOCK_PARAMS = frozenset((
    "now", "now_ms", "now_s", "time_ms", "clock", "time_fn", "wall_clock",
))

#: the wall-clock reads the discipline rule cares about
_WALL_CALLS = frozenset(("time.time", "time.monotonic"))


def _is_wall_call(node: ast.Call) -> Optional[str]:
    d = dotted(node.func)
    if d is None:
        return None
    if d in _WALL_CALLS:
        return d
    # argless datetime.now() / datetime.datetime.now()
    if d.endswith("datetime.now") or d == "datetime.now":
        if not node.args and not node.keywords:
            return d
    return None


def _is_none_test(test: ast.expr) -> bool:
    return (
        isinstance(test, ast.Compare)
        and len(test.ops) == 1
        and isinstance(test.ops[0], (ast.Is, ast.IsNot))
        and any(isinstance(c, ast.Constant) and c.value is None
                for c in [test.left] + list(test.comparators))
    )


def _extract_wallclock(tree: ast.Module) -> List[WallClockSite]:
    """One recursive pass tracking the enclosing-function stack and the
    ``is None``-guard stack (the wall-clock-as-fallback idiom)."""
    sites: List[WallClockSite] = []

    def walk(node, funcs, clock_param, guarded):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            a = node.args
            params = {p.arg for p in (a.posonlyargs + a.args + a.kwonlyargs)}
            funcs = funcs + [node.name]
            clock_param = clock_param or bool(params & CLOCK_PARAMS)
        elif isinstance(node, ast.Lambda):
            a = node.args
            params = {p.arg for p in (a.posonlyargs + a.args + a.kwonlyargs)}
            clock_param = clock_param or bool(params & CLOCK_PARAMS)
        elif isinstance(node, (ast.IfExp, ast.If)) \
                and _is_none_test(node.test):
            guarded = True
        elif isinstance(node, ast.Call):
            call = _is_wall_call(node)
            if call is not None:
                sites.append(WallClockSite(
                    lineno=node.lineno, call=call,
                    func=funcs[-1] if funcs else "",
                    clock_param=clock_param, guarded=guarded,
                ))
        for child in ast.iter_child_nodes(node):
            walk(child, funcs, clock_param, guarded)

    walk(tree, [], False, False)
    return sites


def extract_summary(tree: ast.Module, nodes=None) -> ModuleSummary:
    """Build a ModuleSummary for one parsed file.  ``nodes`` is the
    FileContext's memoized flat node list (used only to find the hot
    contexts without an extra walk)."""
    from cruise_control_tpu_torch.devtools.lint.rules_jax import (
        capture_names,
        find_jit_functions,
    )

    jit = [(fn, set(static)) for fn, static in
           find_jit_functions(tree, nodes)]
    summary = _Extractor(tree, jit, capture_names(tree)).summary
    # the scope/guard walk only runs on files that read a wall clock at
    # all (the flat node list answers that in one cheap scan)
    if any(isinstance(n, ast.Call) and _is_wall_call(n) is not None
           for n in (nodes if nodes is not None else ast.walk(tree))):
        summary.wallclock_sites = _extract_wallclock(tree)
    return summary


# ---- the assembled graph --------------------------------------------------------
@dataclasses.dataclass
class SymbolGraph:
    """All module summaries plus resolution helpers."""

    modules: Dict[str, ModuleSummary]          # dotted module → summary
    by_path: Dict[str, ModuleSummary]          # finding path → summary
    package_roots: Dict[str, pathlib.Path]     # dotted module → pkg root

    def __post_init__(self):
        self._import_map: Dict[str, Dict[str, str]] = {}
        self._class_index: Dict[str, Tuple[str, ClassSummary]] = {}
        for mod, s in self.modules.items():
            for cname, csum in s.classes.items():
                self._class_index.setdefault(f"{mod}.{cname}", (mod, csum))

    # -- import resolution --
    def import_aliases(self, module: str) -> Dict[str, str]:
        """alias → absolute dotted target for one module."""
        cached = self._import_map.get(module)
        if cached is not None:
            return cached
        s = self.modules.get(module)
        out: Dict[str, str] = {}
        if s is not None:
            pkg_parts = module.split(".")[:-1]
            for level, from_mod, name, alias in s.imports:
                if level == 0 and from_mod is None:
                    out[alias] = name
                    continue
                if level == 0:
                    base = from_mod
                else:
                    up = pkg_parts[: len(pkg_parts) - (level - 1)]
                    base = ".".join(up + ([from_mod] if from_mod else []))
                out[alias] = f"{base}.{name}" if base else name
        self._import_map[module] = out
        return out

    def module_deps(self, module: str) -> Set[str]:
        """Project modules this module imports (for the import graph)."""
        out: Set[str] = set()
        for target in self.import_aliases(module).values():
            # target may be a module or a module attribute — try both
            if target in self.modules:
                out.add(target)
            else:
                parent = target.rsplit(".", 1)[0] if "." in target else None
                if parent in self.modules:
                    out.add(parent)
        out.discard(module)
        return out

    def reverse_deps(self) -> Dict[str, Set[str]]:
        """module → set of modules importing it (direct)."""
        rev: Dict[str, Set[str]] = {m: set() for m in self.modules}
        for m in self.modules:
            for dep in self.module_deps(m):
                if dep in rev:
                    rev[dep].add(m)
        return rev

    def dependents_closure(self, seeds: Set[str]) -> Set[str]:
        """seeds plus every module that transitively imports one."""
        rev = self.reverse_deps()
        out, stack = set(), list(seeds)
        while stack:
            m = stack.pop()
            if m in out:
                continue
            out.add(m)
            stack.extend(rev.get(m, ()))
        return out

    # -- symbol resolution --
    def resolve_class(self, module: str,
                      name: str) -> Optional[Tuple[str, ClassSummary]]:
        """A dotted class name as written in ``module`` → (defining
        module, ClassSummary), following import aliases."""
        s = self.modules.get(module)
        if s is None:
            return None
        if name in s.classes:
            return module, s.classes[name]
        aliases = self.import_aliases(module)
        head, _, rest = name.partition(".")
        target = aliases.get(head)
        if target is None:
            return self._class_index.get(name)
        full = f"{target}.{rest}" if rest else target
        hit = self._class_index.get(full)
        if hit is not None:
            return hit
        # alias may name a module: "mod.Class"
        if rest and target in self.modules:
            csum = self.modules[target].classes.get(rest)
            if csum is not None:
                return target, csum
        return None

    def class_method(self, module: str, csum: ClassSummary,
                     method: str, _depth=0):
        """(module, FuncSummary) for a method, ascending base classes
        (project classes only, left-to-right, depth-capped)."""
        s = self.modules.get(module)
        if s is not None:
            fs = s.functions.get(f"{csum.name}.{method}")
            if fs is not None:
                return module, fs
        if _depth >= 4:
            return None
        for base in csum.bases:
            hit = self.resolve_class(module, base)
            if hit is not None:
                found = self.class_method(hit[0], hit[1], method,
                                          _depth + 1)
                if found is not None:
                    return found
        return None

    def class_of_receiver(self, module: str, func: FuncSummary,
                          recv: str) -> Optional[Tuple[str, ClassSummary]]:
        """Best-effort class of a receiver expression inside ``func``:
        ``self`` → enclosing class; locals via constructor assignment /
        annotation / ``alias = self``; ``self._y`` via the class's
        constructor-assigned attribute types."""
        head, _, rest = recv.partition(".")
        if head == "self":
            if func.cls is None:
                return None
            s = self.modules.get(module)
            csum = s.classes.get(func.cls) if s else None
            hit = (module, csum) if csum is not None else None
        else:
            ctor = func.var_types.get(head) or func.annotations.get(head)
            if ctor == "<self>":
                hit = self.class_of_receiver(module, func, "self")
            elif ctor is not None:
                hit = self.resolve_class(module, ctor)
            elif ">" in func.name:
                # closure lookup: ascend enclosing functions by key
                s = self.modules.get(module)
                parent_key = func.name.rsplit(">", 1)[0]
                parent = s.functions.get(parent_key) if s else None
                if parent is None and "." in parent_key:
                    # the parent key may cross a class boundary
                    parent = s.functions.get(
                        parent_key.rsplit(".", 1)[0]) if s else None
                hit = (self.class_of_receiver(module, parent, head)
                       if parent is not None else None)
            else:
                hit = None
            if (hit is None and head.isupper()
                    and head not in func.params
                    and head not in func.var_types):
                # module-level singleton: ``JOURNAL = EventJournal()``
                # at module scope types the receiver in every function
                # of the module.  ALL_CAPS only — the constant
                # convention makes local shadowing implausible, which
                # keeps the fallback under-approximate
                s = self.modules.get(module)
                mfunc = (s.functions.get(_Extractor._MODULE_KEY)
                         if s is not None else None)
                if mfunc is not None and mfunc is not func:
                    ctor = mfunc.var_types.get(head)
                    if ctor is not None and ctor != "<self>":
                        hit = self.resolve_class(module, ctor)
        # descend attribute chains through constructor-typed attrs:
        # app.worker → App.attr_types["worker"] → Worker
        while hit is not None and rest:
            attr, _, rest = rest.partition(".")
            cmod, csum = hit
            ctor = csum.attr_types.get(attr)
            hit = self.resolve_class(cmod, ctor) if ctor else None
        return hit


def file_hash(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


def lint_sources_salt() -> str:
    """Hash of the lint package's own sources — editing any rule or this
    module invalidates every cached summary and cached finding."""
    pkg = pathlib.Path(__file__).resolve().parent
    h = hashlib.sha256(str(SUMMARY_VERSION).encode())
    for p in sorted(pkg.glob("*.py")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def build_graph(summaries: Sequence[ModuleSummary]) -> SymbolGraph:
    modules: Dict[str, ModuleSummary] = {}
    by_path: Dict[str, ModuleSummary] = {}
    roots: Dict[str, pathlib.Path] = {}
    for s in summaries:
        if s.module is not None:
            modules.setdefault(s.module, s)
        by_path[s.path] = s
    for s in summaries:
        if s.module is not None and s.path:
            p = pathlib.Path(s.path)
            depth = s.module.count(".")
            root = p
            for _ in range(depth + 1):
                root = root.parent
            roots[s.module] = root
    return SymbolGraph(modules=modules, by_path=by_path,
                       package_roots=roots)
