"""cross-module-lock — the Eraser-style lockset, across files.

``rules_lock`` checks lockset consistency *inside* a class.  This rule
closes the two escapes the serving/replan work opened: mutable state
guarded in one module is now written from others (the facade pokes the
admission controller, the replan planner patches monitor state), and
helper functions receive ``self`` and write its attributes on the
caller's behalf.

Over the project symbol graph, for every lock-bearing class ``C`` with
guarded attributes (accessed under ``with self.<lock>:`` somewhere in
``C``):

* **external off-lock write** — a write ``obj.attr = ...`` (or a
  mutator call ``obj.attr.append(...)``) anywhere in the project where
  the receiver's class resolves to ``C`` (constructor assignment,
  parameter annotation, ``self._y = C(...)`` attribute types) and
  ``attr`` is guarded in ``C``, without ``with obj.<lock>:`` held at
  the write.  Freshly-constructed receivers (``x = C(); x.attr = v``)
  are pre-publication and exempt, as is ``C``'s own body (the per-file
  rule's jurisdiction).

* **helper off-lock write** — a function takes a parameter ``p``
  resolving to ``C`` (annotation, or call sites passing a known-``C``
  object) and writes ``p.attr`` for a guarded ``attr`` without
  ``with p.<lock>:``; the write is a finding unless EVERY resolved
  call site passes the object with the lock held (the cross-module
  generalization of the held-only-helper fixpoint in ``rules_lock``).

Receiver typing is approximate (see docs/STATIC_ANALYSIS.md): the rule
under-approximates — it misses aliased receivers rather than invent
findings on unknown ones."""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

from cruise_control_tpu_torch.devtools.lint.findings import Finding
from cruise_control_tpu_torch.devtools.lint.graph import (
    AttrAccess,
    ClassSummary,
    FuncSummary,
)

RULE_ID = "cross-module-lock"


def _guarded_attrs(module: str, cls: ClassSummary,
                   functions: Dict[str, FuncSummary]) -> Dict[str, int]:
    """attr → first line accessed under the class's own lock, from the
    class's methods (and their nested defs)."""
    locks = {f"self.{la}" for la in cls.lock_attrs}
    skip = cls.lock_attrs | cls.safe_attrs
    out: Dict[str, int] = {}
    for key, fn in functions.items():
        if fn.cls != cls.name:
            continue
        for a in fn.accesses:
            if a.recv != "self" or a.attr in skip:
                continue
            if any(w in locks for w in a.with_ctxs):
                out.setdefault(a.attr, a.lineno)
    return out


def _lock_held(access: AttrAccess, lock_attrs: Set[str]) -> bool:
    return any(w == f"{access.recv}.{la}" for la in lock_attrs
               for w in access.with_ctxs)


class CrossModuleLockRule:
    id = RULE_ID
    summary = ("writes to another object's lock-guarded attributes must "
               "hold that object's lock — across modules and through "
               "helper functions")
    project_rule = True

    def check_file(self, ctx) -> List[Finding]:
        return []

    def check_project(self, project) -> List[Finding]:
        graph = project.graph
        cg = project.callgraph
        # lock-bearing classes and their guarded surfaces
        guarded: Dict[Tuple[str, str], Dict[str, int]] = {}
        for mod, s in graph.modules.items():
            for cname, csum in s.classes.items():
                if not csum.lock_attrs:
                    continue
                g = _guarded_attrs(mod, csum, s.functions)
                if g:
                    guarded[(mod, cname)] = g

        out: List[Finding] = []
        seen: Set[Tuple[str, int, str]] = set()
        param_types = self._param_types_from_callsites(cg)

        def flag(path: str, lineno: int, msg: str) -> None:
            key = (path, lineno, msg[:60])
            if key not in seen:
                seen.add(key)
                out.append(Finding(path, lineno, self.id, msg))

        from cruise_control_tpu_torch.devtools.lint.callgraph import fid as _fid
        for mod, s in graph.modules.items():
            for fkey, fn in s.functions.items():
                for a in fn.accesses:
                    if not a.write or a.recv == "self":
                        continue
                    hit = graph.class_of_receiver(mod, fn, a.recv)
                    if hit is None and a.recv in fn.params:
                        # helper parameter: type it from its call sites
                        for cmod_c, cname in sorted(param_types.get(
                                _fid(mod, fkey), {}).get(a.recv, ())):
                            g = guarded.get((cmod_c, cname))
                            csum_c = graph.modules[cmod_c].classes.get(
                                cname)
                            if g and a.attr in g and csum_c is not None:
                                hit = (cmod_c, csum_c)
                                break
                    if hit is None:
                        continue
                    cmod, csum = hit
                    g = guarded.get((cmod, csum.name))
                    if g is None or a.attr not in g:
                        continue
                    if a.attr in csum.lock_attrs | csum.safe_attrs:
                        continue
                    # pre-publication: receiver constructed in this func
                    vt = fn.var_types.get(a.recv)
                    if vt is not None and vt != "<self>":
                        continue
                    if _lock_held(a, csum.lock_attrs):
                        continue
                    # helper propagation: a parameter receiver defers to
                    # its call sites' lock state
                    if a.recv in fn.params:
                        if self._all_callsites_locked(
                                cg, mod, fkey, fn, a.recv, csum):
                            continue
                    first_lock = sorted(csum.lock_attrs)[0]
                    flag(
                        s.path, a.lineno,
                        f"{csum.name}.{a.attr} written without holding the "
                        "owning object's lock — the attribute is guarded "
                        f"in {cmod} (e.g. line {g[a.attr]}); take `with "
                        f"{a.recv}.{first_lock}:` here or move the write "
                        "behind a locked method",
                    )
        return out

    @staticmethod
    def _param_types_from_callsites(cg) -> Dict[str, Dict[str, Set[tuple]]]:
        """callee fid → param name → {(module, class name)} inferred from
        the positional arguments its resolved call sites pass.  Bound
        method callees shift by one for ``self``."""
        out: Dict[str, Dict[str, Set[tuple]]] = {}
        for caller_id, edges in cg.edges.items():
            cmod = caller_id.split(":", 1)[0]
            caller = cg.funcs[caller_id]
            sites_by_line = {}
            for site in caller.calls:
                sites_by_line.setdefault(site.lineno, []).append(site)
            for e in edges:
                callee = cg.funcs.get(e.callee)
                if callee is None:
                    continue
                params = list(callee.params)
                if callee.cls is not None and params[:1] == ["self"]:
                    params = params[1:]
                for site in sites_by_line.get(e.lineno, ()):
                    for i, arg in enumerate(site.arg_exprs):
                        if not arg or i >= len(params):
                            continue
                        hit = cg.graph.class_of_receiver(cmod, caller, arg)
                        if hit is None:
                            continue
                        out.setdefault(e.callee, {}).setdefault(
                            params[i], set()).add(
                                (hit[0], hit[1].name))
        return out

    def _all_callsites_locked(self, cg, mod: str, fkey: str,
                              fn: FuncSummary, param: str,
                              csum: ClassSummary) -> bool:
        """True when every resolved call site passes an object for
        ``param`` with that object's lock held (and at least one call
        site resolves — an uncalled annotated helper stays silent only
        via its own lexical lock)."""
        params = list(fn.params)
        if fn.cls is not None and params[:1] == ["self"]:
            params = params[1:]  # bound calls don't pass self positionally
        try:
            idx = params.index(param)
        except ValueError:
            return False
        from cruise_control_tpu_torch.devtools.lint.callgraph import fid
        target = fid(mod, fkey)
        sites = []
        for caller_id, edges in cg.edges.items():
            for e in edges:
                if e.callee != target:
                    continue
                caller = cg.funcs[caller_id]
                cmod = caller_id.split(":", 1)[0]
                # find the matching recorded call site(s) by line
                for site in caller.calls:
                    if site.lineno != e.lineno:
                        continue
                    args = site.arg_exprs
                    if idx < len(args) and args[idx]:
                        sites.append((cmod, caller, args[idx], site))
        if not sites:
            return False
        for cmod, caller, arg, site in sites:
            hit = cg.graph.class_of_receiver(cmod, caller, arg)
            if hit is None or hit[1].name != csum.name:
                continue  # unknown receiver: benefit of the doubt
            held = any(w == f"{arg}.{la}" for la in csum.lock_attrs
                       for w in site.with_ctxs)
            if not held:
                return False
        return True
