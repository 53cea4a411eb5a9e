"""jax-hot-path — no host sync inside the captured step.

The port runs a scan call's steps as CUDA graphs: ``analyzer/
step_graph.py: StepChunk`` records ``STEP_CHUNK`` masked steps once
(``torch.cuda.graph``) and replays them until the device carry says the
loop has ended, with one host read a chunk.  A host sync inside the
recorded step either breaks the capture (a synchronizing call is illegal
while a stream captures) or, on the eager path, serializes every step
behind a device→host copy; a Python branch on a tensor reads a value the
graph bakes in once and replays for every carry.  A captured kernel reads
its predicates from the device carry (``analyzer/step_state.py``).  The
rule keeps the reference's id (the suppression vocabulary) and checks the
port's analog of a jit context.

Hot contexts:

* the body of a ``with torch.cuda.graph(...)`` block (any alias of
  ``torch``, ``torch.cuda`` or ``torch.cuda.graph``);
* the module-level functions named in the module's one
  ``CAPTURED_ROOTS`` tuple — the functions a step chunk records.
  ``StepChunk`` stores the step as a callable, so the capture's
  ``self.step(True)`` cannot be resolved statically and the module that
  defines the step names it (today ``analyzer/cuda_optimizer.py:
  _step``);
* defs nested inside either.

Flags, inside a hot context:

* host syncs — ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``.synchronize()`` (``torch.cuda.synchronize`` and a ``Stream`` or
  ``Event``'s), ``mesh_budget.fetch(...)``, ``np.asarray``/``np.array``
  on a tensor parameter, and ``print``;
* ``float()``/``int()``/``bool()`` applied to a tensor parameter;
* Python ``if``/``while``/``assert`` whose test reads a tensor parameter
  (``x is None`` tests are exempt: they ask about the argument, not its
  data).

A tensor parameter is one annotated ``torch.Tensor`` (or ``Tensor``,
``Optional[...]`` unwrapped); an unannotated parameter is not one (an
under-approximation: the step's own parameters are host objects, a loop
and a flag).  In a captured ``with`` block of an ordinary function, the
enclosing function's tensor parameters count.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from cruise_control_tpu_torch.devtools.lint.context import FileContext
from cruise_control_tpu_torch.devtools.lint.findings import Finding
from cruise_control_tpu_torch.devtools.lint.graph import (
    SYNC_METHODS,
    dotted as _dotted,
)

RULE_ID = "jax-hot-path"

#: the module-level tuple naming a module's captured-step functions
ROOTS_NAME = "CAPTURED_ROOTS"
NP_MODULES = {"np", "numpy", "onp"}
NP_SYNC_FUNCS = {"asarray", "array"}
_CONCRETIZERS = {"float", "int", "bool"}


def capture_names(tree: ast.Module) -> Set[str]:
    """The dotted spellings of ``torch.cuda.graph`` in this module, from
    its imports: ``torch.cuda.graph``, ``<torch alias>.cuda.graph``,
    ``<torch.cuda alias>.graph`` and a direct ``graph`` import."""
    names = {"torch.cuda.graph"}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch" and a.asname:
                    names.add(f"{a.asname}.cuda.graph")
                elif a.name == "torch.cuda" and a.asname:
                    names.add(f"{a.asname}.graph")
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            for a in node.names:
                alias = a.asname or a.name
                if node.module == "torch" and a.name == "cuda":
                    names.add(f"{alias}.graph")
                elif node.module == "torch.cuda" and a.name == "graph":
                    names.add(alias)
    return names


def is_capture(item: ast.withitem, names: Set[str]) -> bool:
    expr = item.context_expr
    return isinstance(expr, ast.Call) and _dotted(expr.func) in names


def captured_withs(tree: ast.Module, nodes=None) -> List[ast.With]:
    """Every ``with`` statement that opens a CUDA-graph capture."""
    names = capture_names(tree)
    return [n for n in (nodes if nodes is not None else ast.walk(tree))
            if isinstance(n, (ast.With, ast.AsyncWith))
            and any(is_capture(i, names) for i in n.items)]


def root_names(tree: ast.Module) -> Set[str]:
    """The names in the module's ``CAPTURED_ROOTS = ("f", ...)``."""
    out: Set[str] = set()
    for stmt in tree.body:
        if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            if any(isinstance(t, ast.Name) and t.id == ROOTS_NAME
                   for t in targets) \
                    and isinstance(stmt.value, (ast.Tuple, ast.List)):
                out.update(e.value for e in stmt.value.elts
                           if isinstance(e, ast.Constant)
                           and isinstance(e.value, str))
    return out


def _is_tensor_annotation(node: Optional[ast.expr]) -> bool:
    if node is None:
        return False
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.rsplit(".", 1)[-1] == "Tensor"
    if isinstance(node, ast.Subscript):
        head = _dotted(node.value)
        return bool(head) and head.rsplit(".", 1)[-1] == "Optional" \
            and _is_tensor_annotation(node.slice)
    d = _dotted(node)
    return d is not None and d.rsplit(".", 1)[-1] == "Tensor"


def tensor_params(fn: ast.AST) -> Set[str]:
    if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return set()
    a = fn.args
    return {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs
            if _is_tensor_annotation(p.annotation)}


def _all_params(fn: ast.AST) -> Set[str]:
    a = fn.args
    return {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs}


def find_jit_functions(tree: ast.Module, nodes=None):
    """[(FunctionDef, non-tensor param names)] for every hot function:
    the roots ``CAPTURED_ROOTS`` names, defs nested inside them, and defs
    nested inside a captured ``with`` block.  The second item plays the
    reference's static arguments: the parameters that hold no tensor."""
    hot: Dict[ast.AST, Set[str]] = {}
    roots = root_names(tree)
    for stmt in tree.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and stmt.name in roots:
            hot[stmt] = _all_params(stmt) - tensor_params(stmt)
    seeds = list(hot) + captured_withs(tree, nodes)
    for seed in seeds:
        for node in ast.walk(seed):
            if node is not seed and isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                hot.setdefault(node,
                               _all_params(node) - tensor_params(node))
    return [(fn, static) for fn, static in hot.items()]


def _tensor_name_in_test(test: ast.expr, params: Set[str]) -> Optional[str]:
    """The first tensor-parameter name a branch test reads, if any;
    names inside ``x is None`` / ``x is not None`` are exempt."""
    structural = set()
    for node in ast.walk(test):
        if (isinstance(node, ast.Compare)
                and all(isinstance(op, (ast.Is, ast.IsNot))
                        for op in node.ops)
                and all(isinstance(c, ast.Constant) and c.value is None
                        for c in node.comparators)):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Name):
                    structural.add(sub)
    for node in ast.walk(test):
        if isinstance(node, ast.Name) and node.id in params \
                and node not in structural:
            return node.id
    return None


def _walk_own_body(stmts):
    """Walk statements without descending into nested defs (each is a
    hot context of its own in :func:`find_jit_functions`)."""
    stack = list(stmts)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def sync_desc(node: ast.Call, params: Set[str]) -> Optional[str]:
    """What a call does to the host, when it is a sync in a hot context."""
    f = node.func
    callee = _dotted(f)
    if isinstance(f, ast.Attribute) and f.attr in SYNC_METHODS:
        if f.attr == "synchronize":
            return f"{callee or '.synchronize'}() waits for the device"
        return f".{f.attr}() host sync"
    if callee is not None and callee.endswith("mesh_budget.fetch"):
        return "mesh_budget.fetch() reads the device back to the host"
    if (isinstance(f, ast.Attribute) and f.attr in NP_SYNC_FUNCS
            and isinstance(f.value, ast.Name) and f.value.id in NP_MODULES
            and node.args and isinstance(node.args[0], ast.Name)
            and node.args[0].id in params):
        return (f"{f.value.id}.{f.attr}() copies tensor parameter "
                f"'{node.args[0].id}' to the host")
    if isinstance(f, ast.Name) and f.id == "print":
        return ("print() inside the captured step (runs at capture only, "
                "or syncs on a tensor)")
    if (isinstance(f, ast.Name) and f.id in _CONCRETIZERS
            and len(node.args) == 1 and isinstance(node.args[0], ast.Name)
            and node.args[0].id in params):
        return (f"{f.id}() reads tensor parameter '{node.args[0].id}' on "
                "the host")
    return None


def _scan(stmts, params: Set[str], out: List[Tuple[int, str]]) -> None:
    for node in _walk_own_body(stmts):
        if isinstance(node, ast.Call):
            desc = sync_desc(node, params)
            if desc is not None:
                out.append((node.lineno, desc))
        elif isinstance(node, (ast.If, ast.While)):
            name = _tensor_name_in_test(node.test, params)
            if name is not None:
                out.append((
                    node.lineno,
                    f"Python branching on tensor parameter '{name}' — a "
                    "captured graph replays one branch for every value; "
                    "read the predicate from the device carry",
                ))
        elif isinstance(node, ast.Assert):
            name = _tensor_name_in_test(node.test, params)
            if name is not None:
                out.append((
                    node.lineno,
                    f"assert on tensor parameter '{name}' (syncs, and is "
                    "checked at capture only)",
                ))


def find_host_syncs(tree: ast.Module, nodes=None, parents=None):
    """(lineno, description) for host syncs and tensor branching inside
    hot contexts."""
    out: List[Tuple[int, str]] = []
    hot = find_jit_functions(tree, nodes)
    hot_fns = {fn for fn, _ in hot}
    for fn, static in hot:
        _scan(fn.body, _all_params(fn) - static, out)
    if parents is None:
        parents = {c: p for p in ast.walk(tree)
                   for c in ast.iter_child_nodes(p)}
    for w in captured_withs(tree, nodes):
        enclosing = parents.get(w)
        while enclosing is not None and not isinstance(
                enclosing, (ast.FunctionDef, ast.AsyncFunctionDef)):
            enclosing = parents.get(enclosing)
        if enclosing in hot_fns:
            continue  # the hot function's own scan covered the block
        _scan(w.body, tensor_params(enclosing), out)
    return sorted(set(out))


class JaxHotPathRule:
    id = RULE_ID
    summary = ("no host syncs or tensor-valued branching inside the "
               "captured step (torch.cuda.graph blocks and the "
               "CAPTURED_ROOTS functions)")

    def check_file(self, ctx: FileContext) -> List[Finding]:
        return [Finding(ctx.path, lineno, self.id, desc)
                for lineno, desc in find_host_syncs(
                    ctx.tree, ctx.all_nodes, ctx.parents)]
