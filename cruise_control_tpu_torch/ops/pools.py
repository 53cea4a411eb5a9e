"""Candidate-pool row tables and their incremental maintenance (the
pool-rebuild diet).

The move-pool priority of every replica splits into:

* **row tables** — per-replica values derived ONLY from immutable loads and
  the replica's own partition state (normalized size, repair bonuses,
  eligibility).  They change exactly when the partition's row changes;
* **broker terms** — per-broker overage/stress gathered through the
  assignment, rebuilt fresh on every repool.

Keeping the row tables across steps and refreshing ONLY the partitions the
applied batches touched (:func:`pool_row_tables_update`) gives tables
bit-identical to a full recompute: every per-row value is elementwise in
that row (sums over the slot and resource axes are written out in a fixed
order), and loads are immutable during a search.  The sums over the broker
axis (the mean capacity, the cluster's load and alive capacity) are exact
(:func:`ops.segment.column_sum`), so they do not depend on the order a
device adds in, and kernel K10 (``csrc/pool_tables.cu``) reproduces every
table to the bit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cruise_control_tpu_torch.common.resources import EMPTY_SLOT
from cruise_control_tpu_torch.ops.cost import rsum
from cruise_control_tpu_torch.ops.segment import column_sum

#: forced-priority bonuses: offline (must-move) replicas and rack-violating
#: replicas repair hard goals, so they outrank every balance-driven candidate
POOL_MUST_MOVE_PRIO = 1e6
POOL_RACK_PRIO = 1e5


def _row_tables(
    m, row, lslot, lead, fol, must, excl
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row tables for the given partition rows → (size [N, S], base [N, S]).

    ``size`` is the replica's capacity-normalized load; ``base`` folds the
    repair bonuses and eligibility (-inf = never in the pool)."""
    S = row.shape[1]
    slot_exists = row != EMPTY_SLOT
    ar = torch.arange(S, device=row.device)
    is_leader = ar[None, :] == lslot[:, None]
    rload = torch.where(
        is_leader[:, :, None], lead[:, None, :], fol[:, None, :]
    )
    cap_sum = column_sum(torch.clamp_min(m.capacity, 1e-9))
    # a tensor divisor: PyTorch's CUDA division by a CPU scalar multiplies
    # by its reciprocal, which may round apart from the division
    cap_mean = cap_sum / torch.full_like(cap_sum, m.capacity.shape[0])
    size = rsum(rload / cap_mean)                               # [N, S]
    # rack-violating replicas (lower-indexed slot of same partition shares
    # the rack — the canonical-holder rule) must enter the pool for repair
    racks = torch.where(slot_exists, m.rack[row.clamp_min(0).long()],
                        torch.full_like(row, -1))
    same_rack = racks[:, :, None] == racks[:, None, :]          # [N, s, k]
    k_lt_s = ar[:, None] > ar[None, :]                          # k < s
    rack_dup = (
        (same_rack & k_lt_s[None, :, :] & slot_exists[:, None, :]).any(dim=2)
        & slot_exists
    )
    bonus = (torch.where(rack_dup, POOL_RACK_PRIO, 0.0)
             + torch.where(must, POOL_MUST_MOVE_PRIO, 0.0))
    # excluded topics leave the pool — except must-move replicas, whose
    # evacuation overrides exclusion (greedy parity)
    eligible = slot_exists & (~excl[:, None] | must)
    base = bonus.masked_fill(~eligible, float("-inf"))
    return size, base


def pool_row_tables(m) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full [P, S] recompute of the move-pool row tables."""
    return _row_tables(
        m, m.assignment, m.leader_slot, m.leader_load, m.follower_load,
        m.must_move, m.excluded,
    )


def pool_row_tables_update(
    m, size, base, touched_p, rows_budget: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Budgeted exact refresh: recompute the rows of up to ``rows_budget``
    touched partitions; untouched rows keep their stored values.  The
    caller guarantees ``sum(touched_p) <= rows_budget`` (it falls back to
    :func:`pool_row_tables` otherwise), so the result equals the full
    recompute bit-for-bit."""
    P = touched_p.shape[0]
    RB = min(P, rows_budget)
    # stable: touched rows first, in partition order
    order = torch.argsort((~touched_p).to(torch.uint8), stable=True)
    ridx = order[:RB]
    rok = touched_p[ridx]
    size_r, base_r = _row_tables(
        m, m.assignment[ridx], m.leader_slot[ridx], m.leader_load[ridx],
        m.follower_load[ridx], m.must_move[ridx], m.excluded[ridx],
    )
    size = size.clone()
    base = base.clone()
    size[ridx] = torch.where(rok[:, None], size_r, size[ridx])
    base[ridx] = torch.where(rok[:, None], base_r, base[ridx])
    return size, base


def pool_broker_terms(m, ca) -> torch.Tensor:
    """[B, 2] broker terms of the move-pool priority (overage, stress)."""
    cap = torch.clamp_min(m.capacity, 1e-9)
    util = m.broker_load / cap                                   # [B, R]
    overage = rsum(torch.clamp_min(util - ca["util_upper"], 0.0))
    if m.broker_cload is not None:
        # percentile-capacity overage is a hard-goal repair signal
        cutil = m.broker_cload / cap
        overage = overage + 10.0 * rsum(
            torch.clamp_min(cutil - ca["cap_threshold"], 0.0)
        )
    alive_cap = torch.where(m.alive[:, None], m.capacity, 0.0)
    avg_u = column_sum(m.broker_load) / torch.clamp_min(
        column_sum(alive_cap), 1e-9
    )
    stress = rsum(torch.clamp_min(util - avg_u[None, :], 0.0))
    return torch.stack([overage, stress], dim=1)                 # [B, 2]


def _prio_combine(g2, size, base) -> torch.Tensor:
    surplus = g2[..., 1]
    fit = surplus - torch.abs(size - surplus)
    return g2[..., 0] * 10.0 + surplus * 2.0 + fit + base


def pool_prio(m, ca, size, base) -> torch.Tensor:
    """[P, S] move-pool priority from fresh broker terms + stored row
    tables: hard overage ≫ above-average stress, plus a surplus-matched
    size term; ``base`` carries the repair bonuses and -inf for ineligible
    rows."""
    btab = pool_broker_terms(m, ca)
    g2 = btab[m.assignment.clamp_min(0).long()]                  # [P, S, 2]
    return _prio_combine(g2, size, base)
