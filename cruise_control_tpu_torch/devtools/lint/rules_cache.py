"""cache-key-discipline — model-state caches must carry a freshness term.

The delta-replan subsystem (this PR) lives and dies on cache freshness:
a plan, a memo, a table cached against the *model* is only servable while
the model generation it was computed against still describes the cluster.
The stale-plan-served-as-fresh bug — a cache keyed on nothing, or an
attribute cache with no version/TTL companion — is invisible in review
and catastrophic in production (the executor happily executes a plan for
a cluster that no longer exists).  This rule makes the discipline
checkable at lint time.

Flagged constructions (non-test code):

* **Keyed cache stores** ``self.<X>[key] = value`` where ``X`` looks like
  a cache (``*cache*``/``*memo*`` in the attribute name) and neither
  holds: the key expression carries a generation-ish term (an identifier
  or attribute containing ``gen``/``generation``/``version``/``epoch``/
  ``seq``/``window``/``mark``/``fingerprint``), or the enclosing class
  clears/reassigns that cache inside a method named like
  ``invalidate``/``clear``/``reset``/``evict``/``expire`` (clear-on-
  mutation is version-keying by other means).
* **Attribute cache stores** ``self.<X> = value`` where ``X`` starts with
  ``cache``/``cached`` (modulo a leading underscore) and none of: a
  sibling store in the same method records freshness (an attribute whose
  name carries a generation-ish term or ends in ``_at``/``_at_ms``/
  ``_time``/``_ms``), the stored value's constructor call carries a
  generation-ish keyword (e.g. ``CachedPlan(generation=...)``), or the
  class has an invalidate-style method reassigning/clearing it.

Never flagged: stores of ``None``/empty literals (that IS invalidation),
lock/semaphore attributes, and non-``self`` locals (a function-local dict
dies with the call — it cannot serve stale across model generations).
Deliberate exceptions take the usual
``# cclint: disable=cache-key-discipline -- reason``.
"""

from __future__ import annotations

import ast
import re
from typing import List, Optional

from cruise_control_tpu_torch.devtools.lint.context import FileContext
from cruise_control_tpu_torch.devtools.lint.findings import Finding

RULE_ID = "cache-key-discipline"

_CACHE_SUBSCRIPT = re.compile(r"(cache|memo)", re.IGNORECASE)
_CACHE_ATTR = re.compile(r"^_?(cache|cached)(_|$)", re.IGNORECASE)
_FRESHNESS = re.compile(
    r"(gen|generation|version|epoch|seq|window|mark|fingerprint)",
    re.IGNORECASE,
)
_SIBLING_FRESH = re.compile(
    r"(gen|generation|version|epoch|seq|mark|fingerprint)|(_at|_at_ms|_time|_ms)$",
    re.IGNORECASE,
)
_INVALIDATOR = re.compile(
    r"(invalidate|clear|reset|evict|expire)", re.IGNORECASE
)
_LOCK_CTORS = {"Lock", "RLock", "Semaphore", "BoundedSemaphore", "Condition"}


def _names_in(node: ast.AST) -> List[str]:
    out = []
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            out.append(n.id)
        elif isinstance(n, ast.Attribute):
            out.append(n.attr)
        elif isinstance(n, ast.Constant) and isinstance(n.value, str):
            out.append(n.value)
    return out


def _is_self_attr(node: ast.AST) -> Optional[str]:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _is_trivial_value(value: ast.AST) -> bool:
    """None / empty literal stores are invalidation, not caching."""
    if isinstance(value, ast.Constant) and value.value is None:
        return True
    if isinstance(value, (ast.Dict, ast.List, ast.Set, ast.Tuple)):
        return not getattr(value, "keys", None) and not getattr(
            value, "elts", None
        )
    return False


def _is_lock_value(value: ast.AST) -> bool:
    if not isinstance(value, ast.Call):
        return False
    f = value.func
    name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")
    return name in _LOCK_CTORS


def _class_invalidates(cls: ast.ClassDef, attr: str) -> bool:
    """True when some invalidate-style method clears / reassigns /
    deletes ``self.<attr>`` — the clear-on-mutation version key."""
    for item in ast.walk(cls):
        if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not _INVALIDATOR.search(item.name):
            continue
        for n in ast.walk(item):
            # self.<attr>.clear()
            if (
                isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr == "clear"
                and _is_self_attr(n.func.value) == attr
            ):
                return True
            # self.<attr> = <anything> (reassignment drops the cache)
            if isinstance(n, ast.Assign) and any(
                _is_self_attr(t) == attr for t in n.targets
            ):
                return True
            # del self.<attr>[...] / del self.<attr>
            if isinstance(n, ast.Delete):
                for t in n.targets:
                    base = t.value if isinstance(t, ast.Subscript) else t
                    if _is_self_attr(base) == attr:
                        return True
    return False


def _value_has_fresh_kwarg(value: ast.AST) -> bool:
    return isinstance(value, ast.Call) and any(
        kw.arg and _FRESHNESS.search(kw.arg) for kw in value.keywords
    )


def find_undisciplined_caches(tree: ast.AST, nodes=None) -> List[tuple]:
    out: List[tuple] = []
    for cls in (nodes if nodes is not None else ast.walk(tree)):
        if not isinstance(cls, ast.ClassDef):
            continue
        for fn in [
            n for n in ast.walk(cls)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]:
            fresh_sibling = any(
                isinstance(st, ast.Assign)
                and any(
                    (a := _is_self_attr(t)) is not None
                    and _SIBLING_FRESH.search(a)
                    for t in st.targets
                )
                for st in ast.walk(fn)
            )
            for st in ast.walk(fn):
                if not isinstance(st, ast.Assign):
                    continue
                for target in st.targets:
                    # self.<cache>[key] = value
                    if isinstance(target, ast.Subscript):
                        attr = _is_self_attr(target.value)
                        if attr is None or not _CACHE_SUBSCRIPT.search(attr):
                            continue
                        if _is_trivial_value(st.value):
                            continue
                        key_ok = any(
                            _FRESHNESS.search(nm)
                            for nm in _names_in(target.slice)
                        )
                        if key_ok or _class_invalidates(cls, attr):
                            continue
                        out.append((
                            st.lineno,
                            f"cache store self.{attr}[...] is keyed on "
                            "model state but carries no generation/version "
                            "term and the class never invalidates it — a "
                            "stale entry will be served as fresh (add a "
                            "generation component to the key, or clear the "
                            "cache in an invalidate()-style method)",
                        ))
                        continue
                    # self.<cached_x> = value
                    attr = _is_self_attr(target)
                    if attr is None or not _CACHE_ATTR.search(attr):
                        continue
                    if attr.endswith("_lock") or _is_lock_value(st.value):
                        continue
                    if _is_trivial_value(st.value):
                        continue
                    if fresh_sibling or _value_has_fresh_kwarg(st.value):
                        continue
                    if _class_invalidates(cls, attr):
                        continue
                    out.append((
                        st.lineno,
                        f"cached attribute self.{attr} is stored with no "
                        "freshness companion (no generation/TTL sibling "
                        "store, no generation field on the cached value, "
                        "no invalidate path) — nothing can ever tell this "
                        "cache is stale",
                    ))
    return out


class CacheKeyDisciplineRule:
    id = RULE_ID
    summary = (
        "caches/memos of model-derived state must carry a generation/"
        "version term (or a clear-on-invalidate path)"
    )

    def check_file(self, ctx: FileContext) -> List[Finding]:
        return [
            Finding(ctx.path, lineno, self.id, message)
            for lineno, message in find_undisciplined_caches(ctx.tree,
                                                 ctx.all_nodes)
        ]
