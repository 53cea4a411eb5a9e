"""The fused soft-goal broker cost — single source of truth for the engine.

Global cost = Σ_b broker_cost(b); every candidate action changes exactly two
brokers, so its score is an exact O(1) delta.  Terms mirror the reference's
soft-goal stack: utilization spread per resource, balance-bound overruns,
replica/leader count balance, leader-bytes-in balance, potential-NW-out
overrun, plus a heavy capacity-overrun term that drives hard-goal repair.

Shapes broadcast: callers pass scalars, [N] columnar batches, or [K, D]
grids — everything reduces over the trailing resource axis only.  Sums over
that axis are written out left to right (:func:`rsum`), so the plain torch
path and the hand-written grid kernel (``csrc/grid_top_r.cu``) add the same
terms in the same order.
"""

from __future__ import annotations

from typing import Dict

import torch

from cruise_control_tpu_torch.common.resources import NUM_RESOURCES, Resource

#: hard-goal repair pressure added to per-candidate scores — shared by ALL
#: scoring paths; change here, nowhere else
EVAC_BONUS = -1e6       # offline replicas leave regardless of cost
RACK_FIX_BONUS = -1e4   # rack-violating replicas prefer a clean rack


def rsum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the trailing axis in a fixed left-to-right order."""
    out = x[..., 0]
    for i in range(1, x.shape[-1]):
        out = out + x[..., i]
    return out


def pack_pload(leader_load, follower_load, excluded,
               leader_cload=None, follower_cload=None):
    """Pack the IMMUTABLE per-partition scoring columns into one f32 row
    table ``[P, 2R+1]`` (``[P, 4R+1]`` with percentile capacity loads):
    ``[leader_load | follower_load | excluded | leader_cload |
    follower_cload]`` — one row gather per scoring site."""
    cols = [leader_load, follower_load,
            excluded.to(leader_load.dtype)[..., None]]
    if leader_cload is not None:
        cols += [leader_cload, follower_cload]
    return torch.cat(cols, dim=-1)


def pload_rows(pl):
    """Unpack gathered :func:`pack_pload` rows ``[..., W]`` into
    ``(leader_load, follower_load, excluded, leader_cload, follower_cload)``
    — the cloads are ``None`` when the table was packed without them."""
    R = NUM_RESOURCES
    lead = pl[..., :R]
    fol = pl[..., R:2 * R]
    excluded = pl[..., 2 * R] > 0.5
    if pl.shape[-1] > 2 * R + 1:
        leadc = pl[..., 2 * R + 1:3 * R + 1]
        folc = pl[..., 3 * R + 1:4 * R + 1]
    else:
        leadc = folc = None
    return lead, fol, excluded, leadc, folc


def _relu(x):
    return torch.clamp_min(x, 0.0)


def rcount_terms(cfg, ca, rcount):
    """(replica-count balance term, replica-count bound term) of
    :func:`broker_cost` — shared with the grid kernel's destination table,
    which precomputes them per destination with these exact operations."""
    t_rc = rcount / ca["avg_rcount"] - 1.0
    c_rc = t_rc * t_rc * cfg.w_count
    c_rc_b = (
        _relu(rcount - ca["rcount_upper"]) + _relu(ca["rcount_lower"] - rcount)
    ) / ca["avg_rcount"] * cfg.w_bound
    return c_rc, c_rc_b


def broker_cost(
    cfg,
    ca: Dict[str, torch.Tensor],
    cap: torch.Tensor,         # f32 [..., R] broker capacity
    load: torch.Tensor,        # f32 [..., R] broker load (possibly hypothetical)
    leader_nwin: torch.Tensor, # f32 [...]
    pot_nwout: torch.Tensor,   # f32 [...]
    rcount: torch.Tensor,      # f32 [...]
    lcount: torch.Tensor,      # f32 [...]
    cload: torch.Tensor = None,  # f32 [..., R] capacity-estimate load
) -> torch.Tensor:
    """Per-broker contribution to the global soft-goal cost (see module doc).

    ``cload`` is the capacity-estimation load: the heavy capacity-overrun
    repair term uses it, the balance terms use the mean ``load``."""
    cap = torch.clamp_min(cap, 1e-9)
    util = load / cap
    c_var = rsum(util * util) * cfg.w_util_var
    over = _relu(util - ca["util_upper"])
    under = _relu(ca["util_lower"] - util)
    c_bound = rsum(over + under) * cfg.w_bound
    cutil = util if cload is None else cload / cap
    c_cap = rsum(_relu(cutil - ca["cap_threshold"])) * 1000.0
    c_rc, c_rc_b = rcount_terms(cfg, ca, rcount)
    t_lc = lcount / ca["avg_lcount"] - 1.0
    c_lc = t_lc * t_lc * cfg.w_leader_count
    c_lc_b = (
        _relu(lcount - ca["lcount_upper"]) + _relu(ca["lcount_lower"] - lcount)
    ) / ca["avg_lcount"] * cfg.w_bound
    lnw = leader_nwin / cap[..., Resource.NW_IN]
    c_lnw = lnw * lnw * cfg.w_leader_nwin
    c_lnw_b = _relu(lnw - ca["leader_nwin_upper"]) * cfg.w_bound
    pot_u = pot_nwout / cap[..., Resource.NW_OUT]
    c_pot = _relu(pot_u - ca["cap_threshold"][Resource.NW_OUT]) * cfg.w_pot_nwout
    return (
        c_var + c_bound + c_cap + c_rc + c_lc + c_rc_b + c_lc_b
        + c_lnw + c_lnw_b + c_pot
    )
