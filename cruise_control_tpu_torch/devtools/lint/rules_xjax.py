"""jax-transitive — host syncs reachable from the captured step.

``rules_jax`` flags host syncs lexically inside the captured step (a
``torch.cuda.graph`` block or a ``CAPTURED_ROOTS`` function); a helper
one call away is invisible to it.  The port's step calls a dozen kernel
wrappers, and one ``.item()`` in any of them would break the capture or
serialize each step behind a device→host read.  This rule walks the
project call graph from every hot context — the ``CAPTURED_ROOTS``
functions and the calls made inside a ``torch.cuda.graph`` block — and
flags:

* **transitive host syncs** — ``.item()``/``.tolist()``/``.cpu()``/
  ``.numpy()``/``.synchronize()``/``mesh_budget.fetch``/``np.asarray``/
  ``np.array`` in any function reachable from a hot context (the hot
  function's own body is the per-file rule's finding, not repeated
  here), with the call path in the message;

* **cache-key leaks** — the kept step loop is keyed on ``key = (...,
  dataclasses.replace(cfg, time_budget_s=0.0, profiler_trace_dir=""),
  ...)`` (``analyzer/cuda_optimizer.py``): those fields are normalized
  out of the key, because one captured graph serves every value of
  them.  A read of such a field (``cfg.time_budget_s``) inside a hot
  context of the same module would bake one value into a graph that is
  replayed for every value.  Host-loop reads stay legal.

Branching on tensors is NOT checked transitively: whether a callee's
argument is a tensor depends on the call site, which the summary does
not track through calls — a documented blind spot
(docs/STATIC_ANALYSIS_TORCH.md)."""

from __future__ import annotations

from typing import Dict, List, Tuple

from cruise_control_tpu_torch.devtools.lint.callgraph import render_path
from cruise_control_tpu_torch.devtools.lint.findings import Finding

RULE_ID = "jax-transitive"


def _in_spans(lineno: int, spans) -> bool:
    return any(a <= lineno <= b for a, b in spans)


def hot_roots(cg) -> Dict[str, Tuple[str, ...]]:
    """function id → the path prefix that makes it hot: a
    ``CAPTURED_ROOTS`` function (or a def nested in one) roots itself; a
    function called inside a ``torch.cuda.graph`` block is rooted at
    the block's function."""
    roots: Dict[str, Tuple[str, ...]] = {}
    for fid, fn in sorted(cg.funcs.items()):
        if fn.is_jit:
            roots[fid] = (fid,)
    for fid, fn in sorted(cg.funcs.items()):
        if not fn.captured_spans or fn.is_jit:
            continue
        for e in cg.edges.get(fid, ()):
            if not e.spawn and _in_spans(e.lineno, fn.captured_spans):
                roots.setdefault(e.callee,
                                 (f"{fid} (torch.cuda.graph)", e.callee))
    return roots


class JaxTransitiveRule:
    id = RULE_ID
    summary = ("no host syncs in functions reachable from the captured "
               "step via the call graph; fields normalized out of the "
               "step loop's key must not be read inside it")
    project_rule = True

    def check_file(self, ctx) -> List[Finding]:
        return []

    def check_project(self, project) -> List[Finding]:
        graph = project.graph
        cg = project.callgraph
        roots = hot_roots(cg)
        out: List[Finding] = []
        reach = cg.reachable_from(set(roots))
        for fid, path in sorted(reach.items()):
            fn = cg.funcs[fid]
            if fn.is_jit:
                continue  # its own body is per-file jurisdiction
            mod = fid.split(":", 1)[0]
            s = graph.modules.get(mod)
            if s is None:
                continue
            full = roots[path[0]][:-1] + path
            for lineno, desc in fn.sync_ops:
                out.append(Finding(
                    s.path, lineno, self.id,
                    f"{desc} reachable from the captured step: "
                    f"{render_path(full)} — under capture this breaks "
                    "the graph or serializes the step behind a "
                    "device→host read; hoist the sync out of the step's "
                    "call chain",
                ))
        # cache-key leaks: per module with normalization sites
        for mod, s in graph.modules.items():
            if not s.normalized_keys:
                continue
            excluded = {}
            for site_line, keys in s.normalized_keys:
                for k in keys:
                    excluded.setdefault(k, site_line)
            for fkey, fn in s.functions.items():
                whole = fn.is_jit or f"{mod}:{fkey}" in reach
                if not whole and not fn.captured_spans:
                    continue  # host-loop reads of the key stay legal
                for recv, attr, lineno in fn.attr_reads:
                    if attr not in excluded or not (
                            whole or _in_spans(lineno, fn.captured_spans)):
                        continue
                    out.append(Finding(
                        s.path, lineno, self.id,
                        f"'{attr}' is normalized out of the step loop's "
                        f"key (line {excluded[attr]}) but read inside "
                        "the captured step — the graph would bake in one "
                        "value and replay it for every value; read it in "
                        "the host loop or key the loop on it",
                    ))
        out.sort(key=lambda f: (f.path, f.line))
        return out
