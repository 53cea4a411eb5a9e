"""Optimization verifier — the shared test oracle (upstream
``analyzer/OptimizationVerifier.java``; SURVEY.md §4 tier-1).

Checks any engine's OptimizerResult against the invariants upstream's random
cluster tests assert: hard goals hold, soft violations didn't regress,
proposals exactly reproduce the final placement, no replicas remain on dead /
excluded brokers, excluded topics untouched.  Used to compare greedy vs TPU
engines on identical inputs (greedy-parity, BASELINE.json metric)."""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from cruise_control_tpu_torch.common.resources import EMPTY_SLOT
from cruise_control_tpu_torch.analyzer.context import AnalyzerContext, OptimizationOptions
from cruise_control_tpu_torch.analyzer.goal_optimizer import OptimizerResult
from cruise_control_tpu_torch.analyzer.goals.base import Goal
from cruise_control_tpu_torch.models.cluster_state import ClusterState, sanity_check


class VerificationError(AssertionError):
    pass


def verify_result(
    initial: ClusterState,
    result: OptimizerResult,
    goals: Sequence[Goal],
    options: Optional[OptimizationOptions] = None,
) -> None:
    options = options or OptimizationOptions()
    final = result.final_state
    sanity_check(final)

    final_ctx = AnalyzerContext(final, options)

    # 1. hard goals hold
    for g in goals:
        if g.is_hard:
            v = g.violations(final_ctx)
            if v:
                raise VerificationError(f"hard goal {g.name} violated: {v}")

    # 2. soft violation score did not regress
    if result.violation_score_after > result.violation_score_before:
        raise VerificationError(
            f"violation score regressed: "
            f"{result.violation_score_before} -> {result.violation_score_after}"
        )

    # 3. proposals reproduce the final placement exactly
    a = np.array(initial.assignment)
    ls = np.array(initial.leader_slot)
    for prop in result.proposals:
        p = prop.partition
        old = [int(b) for b in a[p] if b != EMPTY_SLOT]
        if set(old) != set(prop.old_replicas):
            raise VerificationError(f"proposal {p}: stale old replicas")
        row = np.full(a.shape[1], EMPTY_SLOT, a.dtype)
        row[: len(prop.new_replicas)] = prop.new_replicas
        a[p] = row
        ls[p] = 0  # proposals are leader-first
    fa = np.array(final.assignment)
    fls = np.array(final.leader_slot)
    for p in range(fa.shape[0]):
        want = set(int(b) for b in fa[p] if b != EMPTY_SLOT)
        got = set(int(b) for b in a[p] if b != EMPTY_SLOT)
        if want != got:
            raise VerificationError(f"partition {p}: proposals diverge from final")
        want_leader = int(fa[p, fls[p]])
        got_leader = int(a[p, ls[p]])
        if want_leader != got_leader:
            raise VerificationError(f"partition {p}: leader diverges")

    # 4. nothing left on dead / removed brokers; no offline replicas
    alive = np.array(final.broker_alive())
    occupied = fa[fa != EMPTY_SLOT]
    if not alive[occupied].all():
        raise VerificationError("replicas remain on dead brokers")
    if np.array(final.replica_offline).any():
        raise VerificationError("offline replicas remain")
    for b in options.brokers_to_remove:
        if (fa == b).any():
            raise VerificationError(f"removed broker {b} still hosts replicas")

    # 5. excluded topics untouched — except partitions that *had* to move
    # (replicas on dead/removed brokers: self-healing overrides exclusion,
    # matching upstream's dead-broker precedence over excluded topics)
    if options.excluded_topics:
        topics = np.array(initial.partition_topic)
        excluded = np.isin(topics, list(options.excluded_topics))
        ia = np.array(initial.assignment)
        init_alive = np.array(initial.broker_alive())
        removed = np.zeros(init_alive.shape[0], bool)
        if options.brokers_to_remove:
            removed[list(options.brokers_to_remove)] = True
        must_move = ((ia != EMPTY_SLOT) & (~init_alive | removed)[np.clip(ia, 0, None)]).any(
            axis=1
        ) | np.array(initial.replica_offline).any(axis=1)
        frozen = excluded & ~must_move
        if not (fa[frozen] == ia[frozen]).all():
            raise VerificationError("excluded topic placement changed")


# ---------------------------------------------------------------------------------
# Per-goal input signatures — the partial-verify primitive (delta replan)
# ---------------------------------------------------------------------------------

#: input-field vocabulary → the context arrays it covers.  Goals declare
#: which fields their ``violations()`` verdict reads (``Goal.inputs``);
#: two contexts with bit-identical declared inputs necessarily yield the
#: same verdict, so a previously verified result can be reused EXACTLY —
#: this is a memo over immutable bytes, not a heuristic.
INPUT_FIELDS = {
    "assignment": ("assignment",),
    "leader_slot": ("leader_slot",),
    "loads": ("leader_load", "follower_load",
              "leader_cap_load", "follower_cap_load"),
    "capacity": ("broker_capacity",),
    "racks": ("broker_rack",),
    "broker_state": ("broker_state",),
    "topics": ("partition_topic",),
    "offline": ("replica_offline",),
    "disks": ("replica_disk", "disk_capacity", "disk_offline"),
}


def _field_hash(ctx: AnalyzerContext, field: str, _cache: dict) -> str:
    """Hash one input field's arrays (shared across goals via _cache)."""
    try:
        return _cache[field]
    except KeyError:
        import hashlib

        h = hashlib.sha256()
        for attr in INPUT_FIELDS[field]:
            arr = getattr(ctx, attr, None)
            if arr is None:
                h.update(b"none")
                continue
            a = np.ascontiguousarray(arr)
            h.update(str(a.dtype).encode())
            h.update(str(a.shape).encode())
            h.update(a.tobytes())
        out = _cache[field] = h.hexdigest()
        return out


def goal_input_signatures(
    ctx: AnalyzerContext, goals: Sequence[Goal]
) -> dict:
    """{goal name: signature} over each goal's declared inputs.  Each
    underlying array is hashed once and shared across goals, so the cost
    is ~one pass over the model, not one per goal."""
    cache: dict = {}
    out = {}
    for g in goals:
        out[g.name] = "|".join(
            _field_hash(ctx, f, cache) for f in sorted(g.inputs)
        )
    return out


def partial_violations(
    ctx: AnalyzerContext,
    goals: Sequence[Goal],
    prev_signatures: Optional[dict] = None,
    prev_violations: Optional[dict] = None,
    force_full: bool = False,
) -> tuple:
    """Per-goal violations with exact signature-based reuse.

    Returns ``(violations, signatures, reused_names)``.  A goal's verdict
    is reused from ``prev_violations`` only when its input signature is
    BIT-IDENTICAL to ``prev_signatures`` — reuse is exact, so it applies
    to hard goals too.  ``force_full`` (the ``replan.full.verify`` safety
    net) recomputes everything while still returning fresh signatures."""
    sigs = goal_input_signatures(ctx, goals)
    out: dict = {}
    reused = []
    for g in goals:
        if (
            not force_full
            and prev_signatures is not None
            and prev_violations is not None
            and g.name in prev_violations
            and prev_signatures.get(g.name) == sigs[g.name]
        ):
            out[g.name] = prev_violations[g.name]
            reused.append(g.name)
        else:
            out[g.name] = g.violations(ctx)
    return out, sigs, reused


def violation_score(
    state: ClusterState, goals: Sequence[Goal], options: Optional[OptimizationOptions] = None
) -> int:
    """Aggregate goal-violation score (BASELINE.json metric; hard goals
    weighted heavily so any hard violation dominates)."""
    ctx = AnalyzerContext(state, options or OptimizationOptions())
    score = 0
    for g in goals:
        v = g.violations(ctx)
        score += v * (1000 if g.is_hard else 1)
    return score
