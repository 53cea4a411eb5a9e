"""The what-if verdict chain: its plain twin and the hand-written CUDA
kernel that replaces it on the card.

* K12 :func:`whatif_verdict` (``csrc/whatif_verdict.cu``): for N futures
  over one shared placement — each future a ``dead[B]`` broker mask and a
  ``scale[P]`` traffic multiplier — the survivability verdict, the goal
  violation counts, the cost of healing and the top suggested actions.
  Plain twin :func:`verdict_plain`, the reference's ``_verdict_one``
  (``whatif/engine.py:39-137``) batched over N.

Sums are exact.  The reference sums the hosted load, the cluster total,
the surviving capacity and the data to move in f32 in XLA's order; here
each goes through the order-free int64 fixed point of
:mod:`ops.segment`, with a scale per future and per resource: the slot
loads' scale from the largest of that future's scaled slot loads and the
P·S slot count (the hosted load, the total and the data to move share
it), the capacity's from the largest surviving capacity and B.  A
batch-wide scale would make a future's bits depend on the other futures
in its batch; per future, a batched row equals its single-future
dispatch bit for bit.  The kernel takes the same maxima and sums the same
integers (by broker, over a broker-ordered list of the slots), so it
equals the twin bit for bit.

The wrapper runs the twin for CPU tensors and for CUDA tensors launches
the kernel or raises; there is no fallback.  It counts its calls (seven
launches each) in ``whatif_verdict.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from cruise_control_tpu_torch.common.resources import NUM_RESOURCES, Resource
from cruise_control_tpu_torch.ops import kernels

#: suggested actions returned per future
TOP_ACTIONS = 4

#: resources a traffic multiplier applies to (rates); DISK is an
#: integral, not a rate — the workload synthesizer's rule
_RATE_MASK = (1.0, 1.0, 1.0, 0.0)

#: fixed-point headroom bits (ops/segment.py: _FP_BITS)
_FP_BITS = 60
#: widest replica-slot axis the kernel keeps in registers
_MAX_S = 8
#: brokers K12 takes at most (csrc/whatif_verdict.cu: MAX_B; its part pass
#: holds 8 futures' survivor bits in shared memory)
_MAX_B = 32_768
#: slot-load elements the twin holds at once: it walks the futures in
#: chunks of this size (results are per future, so chunking moves no bit)
_PLAIN_CHUNK = 1 << 24

_P, _I = ctypes.c_void_p, ctypes.c_int

#: the 13 verdict keys and their dtypes, in the reference's order
KEYS = {
    "survivable": torch.bool,
    "unavailablePartitions": torch.int32,
    "underReplicated": torch.int32,
    "capacityInfeasible": torch.bool,
    "overloadedBrokers": torch.int32,
    "rackViolations": torch.int32,
    "movesRequired": torch.int32,
    "leadershipMoves": torch.int32,
    "dataMoveMB": torch.float32,
    "maxBrokerUtilization": torch.float32,
    "topActionPartition": torch.int32,
    "topActionSource": torch.int32,
    "topActionDestination": torch.int32,
}


# ---------------------------------------------------------------------------------
# Plain twin
# ---------------------------------------------------------------------------------

def _fixed(v: torch.Tensor):
    """float [n, M, C] → (int64 fixed point [n, M, C], f64 scale [n, C]):
    :func:`ops.segment._to_fixed` with one scale per future and column."""
    v64 = v.double()
    M = v.shape[1]
    mx = v64.abs().amax(dim=1) if M else v64.new_zeros(v.shape[:1]
                                                       + v.shape[2:])
    _, ex = torch.frexp(mx)
    sc = torch.exp2(_FP_BITS - (ex.double() + (max(M, 1) - 1).bit_length()))
    return torch.round(v64 * sc[:, None, :]).to(torch.int64), sc


def _unfixed(acc: torch.Tensor, sc: torch.Tensor) -> torch.Tensor:
    """int64 sums → f32, scaled back once."""
    return (acc.double() / sc).to(torch.float32)


def _verdict_rows(assignment, leader_slot, leader_load, follower_load,
                  capacity, rack, alive0, dead, scale):
    """:func:`verdict_plain` for one chunk of futures, with the hosted
    load ``[n, B, R]`` beside the verdicts as ``"hosted"``."""
    P, S = assignment.shape
    B, R = capacity.shape
    n = dead.shape[0]
    dev = assignment.device
    f32 = torch.float32
    exists = assignment >= 0                                  # [P, S]
    bid = assignment.clamp_min(0).long()                      # [P, S]
    alive = alive0[None, :] & ~dead                           # [n, B]
    slot_alive = exists[None] & alive[:, bid.reshape(-1)].reshape(n, P, S)
    rf = exists.sum(dim=1)                                    # [P]
    alive_replicas = slot_alive.sum(dim=2)                    # [n, P]
    has = rf > 0
    unavailable = (has & (alive_replicas == 0)).sum(dim=1)
    under = (has & (alive_replicas > 0) & (alive_replicas < rf)).sum(dim=1)

    rmask = torch.tensor(_RATE_MASK, dtype=f32, device=dev)
    one = torch.ones((), dtype=f32, device=dev)
    lscale = one + (scale[:, :, None] - one) * rmask          # [n, P, R]
    lead = leader_load[None] * lscale
    fol = follower_load[None] * lscale
    is_lead = torch.arange(S, device=dev)[None, :] == leader_slot[:, None]
    slot_load = torch.where(is_lead[None, :, :, None], lead[:, :, None, :],
                            fol[:, :, None, :]) * exists[None, :, :, None]

    # exact sums: hosted load per surviving broker (dead and empty slots
    # fall into the dump segment B), the total (orphaned load included)
    q, sc = _fixed(slot_load.reshape(n, P * S, R))
    seg = torch.where(slot_alive.reshape(n, P * S), bid.reshape(1, -1), B)
    seg = seg + (B + 1) * torch.arange(n, device=dev)[:, None]
    acc = torch.zeros((n * (B + 1), R), dtype=torch.int64, device=dev)
    acc.index_add_(0, seg.reshape(-1), q.reshape(-1, R))
    hosted = _unfixed(acc.reshape(n, B + 1, R)[:, :B], sc[:, None, :])
    total = _unfixed(q.sum(dim=1), sc)                        # [n, R]
    cq, csc = _fixed(capacity[None] * alive[:, :, None])
    cap_alive = _unfixed(cq.sum(dim=1), csc)                  # [n, R]
    infeasible = (total > cap_alive).any(dim=1)
    over = (hosted > capacity[None]).any(dim=2) & alive
    overloaded = over.sum(dim=1)

    # rack co-location among SURVIVING replicas (S is small: pairwise)
    neg = -1 - torch.arange(S, device=dev)
    rk = torch.where(slot_alive, rack[bid][None], neg[None, None, :])
    dup = torch.zeros((n, P), dtype=torch.bool, device=dev)
    for i in range(S):
        for j in range(i + 1, S):
            dup |= (slot_alive[:, :, i] & slot_alive[:, :, j]
                    & (rk[:, :, i] == rk[:, :, j]))
    rack_violations = dup.sum(dim=1)

    offline = exists[None] & ~slot_alive                      # [n, P, S]
    moves = offline.sum(dim=(1, 2))
    lead_alive = torch.gather(
        slot_alive, 2, leader_slot.long()[None, :, None].expand(n, P, 1))
    leadership_moves = (~lead_alive[:, :, 0] & has).sum(dim=1)
    # data to move: the DISK column's fixed-point slot loads over the
    # offline slots, in the slot loads' scale
    disk_q = q[:, :, Resource.DISK] * offline.reshape(n, P * S)
    data_move = _unfixed(disk_q.sum(dim=1), sc[:, Resource.DISK])

    # top suggested actions: the heaviest replicas needing re-placement,
    # larger first, ties to the lowest flat index (lax.top_k's order), as
    # one int64 key a slot (prio's bits above the inverted index); a slot
    # whose priority is not > 0 suggests nothing
    prio = offline * (slot_load[..., Resource.DISK]
                      + slot_load[..., Resource.NW_IN] + one)
    prio = prio.reshape(n, P * S)
    inv = (0xFFFFFFFF - torch.arange(P * S, device=dev))[None, :]
    key = torch.where(prio > 0, (prio.view(torch.int32).long() << 32) | inv,
                      0)
    top = torch.topk(key, TOP_ACTIONS, dim=1).values
    top_idx = 0xFFFFFFFF - (top & 0xFFFFFFFF)
    valid = top > 0
    top_part = torch.where(valid, top_idx // S, -1)
    top_src = torch.where(valid, bid.reshape(-1)[top_idx.clamp_max(P * S - 1)],
                          -1)

    util_raw = (hosted / capacity.clamp_min(1e-9)[None]).amax(dim=2)
    inf = torch.full_like(util_raw, float("inf"))
    dst = torch.argmin(torch.where(alive, util_raw, inf), dim=1)
    max_util = torch.where(alive, util_raw, torch.zeros_like(util_raw)).amax(
        dim=1)

    i32 = torch.int32
    return {
        "hosted": hosted,
        "survivable": (unavailable == 0) & ~infeasible,
        "unavailablePartitions": unavailable.to(i32),
        "underReplicated": under.to(i32),
        "capacityInfeasible": infeasible,
        "overloadedBrokers": overloaded.to(i32),
        "rackViolations": rack_violations.to(i32),
        "movesRequired": moves.to(i32),
        "leadershipMoves": leadership_moves.to(i32),
        "dataMoveMB": data_move,
        "maxBrokerUtilization": max_util,
        "topActionPartition": top_part.to(i32),
        "topActionSource": top_src.to(i32),
        "topActionDestination": dst.to(i32)[:, None].expand(
            n, TOP_ACTIONS).contiguous(),
    }


def verdict_plain(assignment, leader_slot, leader_load, follower_load,
                  capacity, rack, alive0, dead, scale) -> Dict[str, torch.Tensor]:
    """Verdicts for N futures (``dead [N, B]`` bool, ``scale [N, P]`` f32)
    over one base — ``assignment [P, S]`` int32, ``leader_slot [P]``
    int32, ``leader_load`` / ``follower_load [P, R]`` f32, ``capacity
    [B, R]`` f32, ``rack [B]`` int32, ``alive0 [B]`` bool — as the 13
    stacked arrays of the reference's ``_EVALUATE`` (:data:`KEYS`).  The
    futures are taken in chunks of :data:`_PLAIN_CHUNK` slot-load elements;
    each row depends on its own future only."""
    N = dead.shape[0]
    P, S = assignment.shape
    chunk = max(1, _PLAIN_CHUNK // max(1, P * S * NUM_RESOURCES))
    rows = [_verdict_rows(assignment, leader_slot, leader_load,
                          follower_load, capacity, rack, alive0,
                          dead[i:i + chunk], scale[i:i + chunk])
            for i in range(0, N, chunk)]
    return {k: torch.cat([r[k] for r in rows]) for k in KEYS}


# ---------------------------------------------------------------------------------
# K12: the verdict chain on the card
# ---------------------------------------------------------------------------------

#: the outputs as the kernel packs them: (keys, dtype), each group one
#: run of its arrays in the call's buffer
_GROUPS = (
    (("unavailablePartitions", "underReplicated", "overloadedBrokers",
      "rackViolations", "movesRequired", "leadershipMoves",
      "topActionPartition", "topActionSource", "topActionDestination"),
     torch.int32),
    (("dataMoveMB", "maxBrokerUtilization"), torch.float32),
    (("survivable", "capacityInfeasible"), torch.bool),
)


#: the outputs of TOP_ACTIONS elements a future
_TOP_KEYS = ("topActionPartition", "topActionSource", "topActionDestination")


def _width(key: str) -> int:
    """Elements a future of output ``key``."""
    return TOP_ACTIONS if key in _TOP_KEYS else 1


@functools.lru_cache(maxsize=64)
def _layout(N: int, P: int, S: int, B: int, sms: int):
    """(the views of one call's buffer — for each output group of
    :data:`_GROUPS` its keys, dtype, byte range and elements a key — and
    the buffer's bytes), from the kernel's own ``whatif_verdict_layout``;
    raises unless its offsets pack each group as one run."""
    lib = kernels.load("whatif_verdict")
    fn = lib.whatif_verdict_layout
    fn.restype = ctypes.c_int
    fn.argtypes = [_I] * 5 + [_P]
    off = (ctypes.c_longlong * 14)()
    kernels.launched("whatif_verdict", fn(N, P, S, B, sms, off))
    at = dict(zip(KEYS, off[:13]))
    plan = []
    for keys, dt in _GROUPS:
        o = start = at[keys[0]]
        for k in keys:
            if at[k] != o:
                raise RuntimeError(f"whatif_verdict: the kernel's layout "
                                   f"does not pack {keys}")
            o += dt.itemsize * N * _width(k)
        plan.append((keys, dt, start, o, [N * _width(k) for k in keys]))
    return tuple(plan), off[13]


def whatif_verdict(assignment, leader_slot, leader_load, follower_load,
                   capacity, rack, alive0, dead, scale) -> Dict[str, torch.Tensor]:
    """The verdicts of the plain twin :func:`verdict_plain` (same
    arguments and outputs).  On the card one call is one buffer (the 13
    outputs are views of it, the workspace follows them) and seven
    launches, with no memset and no host read."""
    if kernels.on_cpu(dead):
        return verdict_plain(assignment, leader_slot, leader_load,
                             follower_load, capacity, rack, alive0, dead,
                             scale)
    dev = dead.device
    P, S = assignment.shape
    B = capacity.shape[0]
    N = dead.shape[0]
    NR = NUM_RESOURCES
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    chk = functools.partial(kernels.check, "whatif_verdict", device=dev)
    for name, x, dt, shape in (
        ("assignment", assignment, i32, (P, S)),
        ("leader_slot", leader_slot, i32, (P,)),
        ("leader_load", leader_load, f32, (P, NR)),
        ("follower_load", follower_load, f32, (P, NR)),
        ("capacity", capacity, f32, (B, NR)),
        ("rack", rack, i32, (B,)),
        ("alive0", alive0, b8, (B,)),
        ("dead", dead, b8, (N, B)),
        ("scale", scale, f32, (N, P)),
    ):
        chk(name, x, dt, shape)
    if not 1 <= S <= _MAX_S or not 1 <= P < 1 << 28 \
            or not 1 <= B <= _MAX_B or not 1 <= N <= 65_535 \
            or P * S >= 1 << 31 or P * S < TOP_ACTIONS:
        raise ValueError(f"whatif_verdict: N={N}, P={P}, S={S}, B={B} out "
                         f"of range (1 <= S <= {_MAX_S}, P < 2^28, "
                         f"B <= {_MAX_B}, {TOP_ACTIONS} <= P·S < 2^31)")
    if leader_load.data_ptr() % 16 or follower_load.data_ptr() % 16:
        raise ValueError("whatif_verdict: the load rows must start at a "
                         "16-byte boundary (the kernel reads a row as one "
                         "float4)")
    lib = kernels.bind("whatif_verdict", "whatif_verdict_launch",
                       [_P] * 9 + [_I] * 5 + [_P] * 2)
    sms = kernels.sm_count(dev)
    plan, nbytes = _layout(N, P, S, B, sms)
    buf = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    views = {}
    for keys, dt, o, end, sizes in plan:
        views.update(zip(keys, buf[o:end].view(dt).split_with_sizes(sizes)))
    for k in _TOP_KEYS:
        views[k] = views[k].view(N, TOP_ACTIONS)
    out = {k: views[k] for k in KEYS}
    err = lib.whatif_verdict_launch(
        assignment.data_ptr(), leader_slot.data_ptr(),
        leader_load.data_ptr(), follower_load.data_ptr(),
        capacity.data_ptr(), rack.data_ptr(), alive0.data_ptr(),
        dead.data_ptr(), scale.data_ptr(), N, P, S, B, sms, buf.data_ptr(),
        kernels.stream(dev),
    )
    kernels.launched("whatif_verdict", err)
    whatif_verdict.launches += 1
    return out


whatif_verdict.launches = 0
