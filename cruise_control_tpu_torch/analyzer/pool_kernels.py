"""The repool: its plain twins and the hand-written CUDA kernels that
replace them on the card.

* K10 :func:`pool_tables` (``csrc/pool_tables.cu``): the priority side of
  a repool — the move-pool row tables (full or only the touched rows), the
  [P, S] move and leadership priorities and the destination scores — with
  the repool's predicates decided on the device.  Plain twin
  :func:`pool_tables_plain` over :mod:`ops.pools` and
  :func:`_leadership_prio_terms` / :func:`_leadership_prio_rows`
  (reference ``ops/pools.py:50-213``, ``tpu_optimizer.py:2120-2172``,
  ``:1016-1022``).
* K11 :func:`top_select` (``csrc/top_select.cu``): exact top-k with ties to
  the lowest index, in the floats' total order — XLA's ``top_k`` order.
  Plain twin :func:`_top_desc`, a stable descending sort of the total-order
  keys (reference ``_select_round_pools`` ``:688``, ``_leadership_pool``
  ``:2173``).

A repool writes into :class:`PoolBuffers`, which live for a whole search
(the captured step chunks bake their addresses in).  Both kernels read the
step loop's carry (:mod:`analyzer.step_state`): K10 acts only when the
step is active and needs a repool and sets the carry's repool flag; K11
acts only under that flag.  Each wrapper runs its plain twin for CPU
tensors and for CUDA tensors launches its kernel or raises; there is no
fallback.  Each counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from cruise_control_tpu_torch.analyzer import step_state as SS
from cruise_control_tpu_torch.common.resources import (
    EMPTY_SLOT,
    NUM_RESOURCES,
    Resource,
)
from cruise_control_tpu_torch.ops import kernels
from cruise_control_tpu_torch.ops.pools import (
    pool_prio,
    pool_row_tables,
    pool_row_tables_update,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
_INF = float("inf")
#: K11's block width, the entries a selecting block takes at least and
#: the kept entries a block ranks (csrc/top_select.cu)
_TOP_THREADS = 1024
_TOP_PER_BLOCK = 4 * _TOP_THREADS
_TOP_RANK = 64
#: K11's zeroed workspace words (three passes' bins and the counters) and
#: its static shared memory, bytes (bins, scan scratch, a few scalars)
_TOP_CONTROL = 2048 + 2048 + 1024 + 8
_TOP_STATIC_SMEM = 4 * (2048 + 33 + 3) + 1024
#: widest replica-slot axis K10 takes (as K1)
_MAX_S = 8
#: int64 words of K10's workspace header (``csrc/pool_tables.cu:
#: WS_HEADER_WORDS``: the column maxima and sums and the touched count,
#: zero between launches); two float4 tables of B brokers follow
POOL_WS_HEADER_WORDS = 32
#: K10's device phases in the order block 0's phase stamps close them
#: (``csrc/pool_tables.cu``, built with ``-DCC_PHASE_STAMPS`` by
#: ``tools/time_kernels.py``): the touched count, the columns' maxima
#: and the broker terms that need no sum; the column sums; block 0's
#: share of the rows
POOL_TABLES_PHASES = ("touched_max_terms", "sums", "rows")


# ---------------------------------------------------------------------------------
# Plain twins
# ---------------------------------------------------------------------------------

def _top_desc(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest f32 entries, ties to the lowest index, in
    the floats' total order (-0.0 below +0.0): XLA's ``top_k`` order, which
    the reference's CPU backend gives (its ``sort`` and ``approx_max_k``
    tie the two zeros).  A stable descending sort of the total-order
    integer keys."""
    bits = x.contiguous().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return torch.sort(key, descending=True, stable=True).indices[:k]


def _leadership_prio_terms(m, ca):
    """[B]-scale terms of the leadership-pool priority → (stress [B],
    ltab [B, 2])."""
    cap = torch.clamp_min(m.capacity, 1e-9)
    util = m.broker_load / cap
    lc_over = torch.clamp_min(m.lcount - ca["lcount_upper"], 0.0) / \
        torch.clamp_min(ca["lcount_upper"], 1.0)
    lc_need = torch.clamp_min(ca["lcount_lower"] - m.lcount, 0.0) / \
        torch.clamp_min(ca["lcount_lower"], 1.0)
    stress = (
        util.max(dim=1).values + m.leader_nwin / cap[:, Resource.NW_IN]
        + lc_over
    )
    ltab = torch.stack([lc_need, m.lead_ok.to(torch.float32)], dim=1)
    return stress, ltab


def _leadership_prio_rows(stress, ltab, row, lslot, must, excl):
    """[N, S] leadership-pool priority (-inf = invalid) for the given
    partition rows."""
    S = row.shape[1]
    lb = torch.gather(row, 1, lslot.long()[:, None])[:, 0]
    lb_c = lb.clamp_min(0).long()
    g2 = ltab[row.clamp_min(0).long()]                       # [N, S, 2]
    prio = stress[lb_c][:, None] + g2[..., 0]
    ar = torch.arange(S, device=row.device)
    valid = (
        (row != EMPTY_SLOT)
        & (ar[None, :] != lslot[:, None])
        & ~excl[:, None]
        & ~must
        & (g2[..., 1] > 0.0)
    )
    return prio.masked_fill(~valid, -_INF)


def _dest_score(m) -> torch.Tensor:
    """[B] destination score: the broker's highest utilization, +inf for a
    broker that may not take moves (``_select_round_pools``)."""
    util = m.broker_load / torch.clamp_min(m.capacity, 1e-9)
    return util.max(dim=1).values + torch.where(m.dest_ok, 0.0, _INF)


@dataclasses.dataclass
class PoolBuffers:
    """What a repool reads and writes, fixed for a search: the stored row
    tables and the touched set, the priorities, and the selected pools —
    top-K move slots (partition ``kp``, slot ``ks``, flat ``slot``), top-D
    destinations and top-L leadership slots (``lp``, ``lsl``) — and the
    workspaces of K10 (:func:`pool_tables`) and K11 (:func:`top_select`),
    whose counters are zero between launches."""

    size: torch.Tensor        # f32 [P, S]
    base: torch.Tensor        # f32 [P, S]
    tpp: torch.Tensor         # bool [P] touched since the last repool
    prio: torch.Tensor        # f32 [P, S]
    lprio: torch.Tensor       # f32 [P, S]
    dneg: torch.Tensor        # f32 [B] negated destination score
    kp: torch.Tensor          # int32 [K]
    ks: torch.Tensor          # int32 [K]
    slot: torch.Tensor        # int64 [K] kp·S + ks
    dest_pool: torch.Tensor   # int32 [D]
    lp: torch.Tensor          # int32 [L]
    lsl: torch.Tensor         # int32 [L]
    select_ws: torch.Tensor   # int32, K11's counters, bins and keys
    pool_ws: torch.Tensor     # int64, K10's column sums and broker tables

    @classmethod
    def empty(cls, P: int, S: int, B: int, K: int, D: int, L: int, device):
        f = functools.partial(torch.zeros, dtype=torch.float32,
                              device=device)
        i = functools.partial(torch.zeros, dtype=torch.int32, device=device)
        return cls(f((P, S)), f((P, S)),
                   torch.zeros(P, dtype=torch.bool, device=device),
                   f((P, S)), f((P, S)), f(B), i(K), i(K),
                   torch.zeros(K, dtype=torch.int64, device=device), i(D),
                   i(L), i(L),
                   i(top_select_words(max(K, D, L), max(P * S, B))),
                   torch.zeros(pool_ws_words(B), dtype=torch.int64,
                               device=device))


def pool_ws_words(B: int) -> int:
    """int64 words of K10's workspace at B brokers: the header, then the
    brokers' utilization rows and terms, a float4 each."""
    return POOL_WS_HEADER_WORDS + 4 * B


def pool_tables_plain(m, ca, pb: PoolBuffers, state, rows_budget: int):
    """Plain twin of K10: unless the carry ``state`` says the step is
    inactive or needs no repool, refresh ``pb``'s row tables — only the
    touched rows when the stored tables are valid and at most
    ``rows_budget`` partitions were touched (``rows_budget`` < 0: always
    every row) — and write the priorities and destination scores; clear
    the touched set and update the carry (the reference's :1016-1022)."""
    go = bool(int(state[SS.ACTIVE])) and bool(int(state[SS.NEED_POOL]))
    state[SS.REPOOL] = int(go)
    if not go:
        return
    incr = (rows_budget >= 0 and bool(int(state[SS.PT_VALID]))
            and int(pb.tpp.sum()) <= rows_budget)
    if incr:
        size, base = pool_row_tables_update(m, pb.size, pb.base, pb.tpp,
                                            rows_budget)
    else:
        size, base = pool_row_tables(m)
    pb.size.copy_(size)
    pb.base.copy_(base)
    pb.prio.copy_(pool_prio(m, ca, size, base))
    stress, ltab = _leadership_prio_terms(m, ca)
    pb.lprio.copy_(_leadership_prio_rows(
        stress, ltab, m.assignment, m.leader_slot, m.must_move, m.excluded))
    pb.dneg.copy_(-_dest_score(m))
    pb.tpp.zero_()
    for i, v in ((SS.FULL, int(not incr)),
                 (SS.N_INCR, int(state[SS.N_INCR]) + int(incr)),
                 (SS.N_REPOOL, int(state[SS.N_REPOOL]) + 1),
                 (SS.SINCE_POOL, 0), (SS.PT_VALID, 1), (SS.NEED_POOL, 0)):
        state[i] = v


def top_select_plain(x, hi, lo=None, flat=None, S: int = 1, state=None,
                     ws=None):
    """Plain twin of K11: the k = ``hi.shape[0]`` largest entries of
    ``x [N]`` (:func:`_top_desc`) as ``idx // S`` into ``hi`` and, when
    given, ``idx % S`` into ``lo`` and ``idx`` into ``flat`` — unless the
    carry ``state`` says the step does not repool.  ``ws`` (the kernel's
    workspace) is not used."""
    if state is not None and not int(state[SS.REPOOL]):
        return
    idx = _top_desc(x, hi.shape[0])
    hi.copy_(idx // S)
    if lo is not None:
        lo.copy_(idx % S)
    if flat is not None:
        flat.copy_(idx)


# ---------------------------------------------------------------------------------
# K10: the repool's tables and priorities
# ---------------------------------------------------------------------------------

def pool_tables_work(P: int, S: int, B: int, NR: int, has_cap: bool,
                     n_ref=None):
    """K10's work → (bytes, operations): the broker tables; a partition's
    slots, leader slot, must-move flags, exclusion and touched mark; a
    refreshed row's load rows and written tables (``n_ref`` rows, every
    row where not counted), an untouched row's stored tables; both
    priorities out, the destination scores.  ~60 operations a broker; a
    refreshed slot's divisions and rack scan; ~12 a slot for the two
    priorities."""
    n_ref = P if n_ref is None else n_ref
    return (B * (4 * NR * (3 if has_cap else 2) + 15) + P * (5 * S + 6)
            + n_ref * (8 * NR + 8 * S) + (P - n_ref) * 8 * S + P * 8 * S
            + B * 4,
            B * 60 + n_ref * S * (2 * NR + S + 6) + P * S * 12)


def pool_tables(m, ca, pb: PoolBuffers, state, rows_budget: int,
                checked: bool = False):
    """The repool's priority side of the plain twin
    :func:`pool_tables_plain` (same arguments; ``pb`` and the carry
    ``state`` are updated in place).  On the card one cooperative launch
    (a gated step's blocks return at once), no host read; it uses
    ``pb.pool_ws`` and leaves its counters zero.  ``checked=True`` skips
    the input checks."""
    if kernels.on_cpu(state):
        return pool_tables_plain(m, ca, pb, state, rows_budget)
    dev = state.device
    P, S = m.assignment.shape
    B, NR = m.capacity.shape
    W = m.pload.shape[1]
    has_cap = m.broker_cload is not None
    if not checked:
        i32, f32, b8 = torch.int32, torch.float32, torch.bool
        chk = functools.partial(kernels.check, "pool_tables", device=dev)
        for name, x, dt, shape in (
            ("capacity", m.capacity, f32, (B, NUM_RESOURCES)),
            ("broker_load", m.broker_load, f32, (B, NR)),
            ("alive", m.alive, b8, (B,)),
            ("dest_ok", m.dest_ok, b8, (B,)),
            ("lead_ok", m.lead_ok, b8, (B,)),
            ("leader_nwin", m.leader_nwin, f32, (B,)),
            ("lcount", m.lcount, f32, (B,)),
            ("util_upper", ca["util_upper"], f32, (NR,)),
            ("cap_threshold", ca["cap_threshold"], f32, (NR,)),
            ("lcount_upper", ca["lcount_upper"], f32, ()),
            ("lcount_lower", ca["lcount_lower"], f32, ()),
            ("assignment", m.assignment, i32, (P, S)),
            ("leader_slot", m.leader_slot, i32, (P,)),
            ("must_move", m.must_move, b8, (P, S)),
            ("excluded", m.excluded, b8, (P,)),
            ("rack", m.rack, i32, (B,)),
            ("pload", m.pload, f32, (P, W)),
            ("state", state, i32, (SS.NSTATE,)),
            ("size", pb.size, f32, (P, S)),
            ("base", pb.base, f32, (P, S)),
            ("tpp", pb.tpp, b8, (P,)),
            ("prio", pb.prio, f32, (P, S)),
            ("lprio", pb.lprio, f32, (P, S)),
            ("dneg", pb.dneg, f32, (B,)),
            ("pool_ws", pb.pool_ws, torch.int64, (pool_ws_words(B),)),
            *((("broker_cload", m.broker_cload, f32, (B, NR)),)
              if has_cap else ()),
        ):
            chk(name, x, dt, shape)
        if not 1 <= S <= _MAX_S or W < 2 * NR + 1:
            raise ValueError(f"pool_tables: S={S}, table width {W} out of "
                             "range")
    lib = kernels.bind("pool_tables", "pool_tables_launch",
                       [_P] * 12 + [_I] + [_P] * 6 + [_I] * 4 + [_P] * 8
                       + [_I, _P])
    err = lib.pool_tables_launch(
        m.capacity.data_ptr(), m.broker_load.data_ptr(),
        m.broker_cload.data_ptr() if has_cap else None, m.alive.data_ptr(),
        m.dest_ok.data_ptr(), m.lead_ok.data_ptr(), m.leader_nwin.data_ptr(),
        m.lcount.data_ptr(), ca["util_upper"].data_ptr(),
        ca["cap_threshold"].data_ptr(), ca["lcount_upper"].data_ptr(),
        ca["lcount_lower"].data_ptr(), B, m.assignment.data_ptr(),
        m.leader_slot.data_ptr(), m.must_move.data_ptr(),
        m.excluded.data_ptr(), m.rack.data_ptr(), m.pload.data_ptr(), P, S,
        W, rows_budget, state.data_ptr(), pb.pool_ws.data_ptr(),
        pb.size.data_ptr(), pb.base.data_ptr(), pb.tpp.data_ptr(),
        pb.prio.data_ptr(), pb.lprio.data_ptr(), pb.dneg.data_ptr(),
        kernels.sm_count(dev), kernels.stream(dev),
    )
    kernels.launched("pool_tables", err)
    pool_tables.launches += 1
    kernels.note_work("pool_tables", lambda: pool_tables_work(
        P, S, B, NR, has_cap))


pool_tables.launches = 0


def pool_tables_attrs(S: int) -> dict:
    """The built K10 for S replica slots, as the card reports it
    (:func:`ops.kernels.attrs`).  Needs the card."""
    lib = kernels.bind("pool_tables", "pool_tables_attrs",
                       [_I, ctypes.POINTER(ctypes.c_int)])
    return kernels.attrs("pool_tables", lib.pool_tables_attrs, S)


# ---------------------------------------------------------------------------------
# K11: exact top-k, ties to the lowest index
# ---------------------------------------------------------------------------------

def top_select_grid(n: int, k: int, sms: int) -> int:
    """K11's grid for k kept of ``n`` entries on a card of ``sms`` SMs: a
    block per 4 096 entries for the selection and a block per 64 kept
    entries for the ranking, whichever is more, at most one an SM.  The
    launch caps it further at the blocks the card holds at once and is
    cooperative, so its grid barriers never wait on a block that is not
    resident: such a grid fails to launch and raises."""
    return max(1, min(sms, max(-(-n // _TOP_PER_BLOCK), -(-k // _TOP_RANK))))


def top_select_words(k: int, n: int) -> int:
    """int32 words of K11's workspace for k kept of n entries, on any card:
    the bins and counters (zero between launches), two counts a block of
    the largest grid :func:`top_select_grid` gives, and the k kept keys
    and indices (``top_select_ws_words`` in the kernel's source)."""
    g = max(-(-n // _TOP_PER_BLOCK), -(-k // _TOP_RANK))
    return _TOP_CONTROL + 2 * g + 2 * k


def top_select_max_k() -> int:
    """The most entries K11 keeps: its 1 024 threads' static shared memory
    and the k kept keys (4 B each) staged for the ranking."""
    return (kernels.SMEM_LIMIT - _TOP_STATIC_SMEM) // 4


def top_select_attrs(k: int) -> dict:
    """The built K11 for k kept, as the card reports it (registers and
    spilled bytes a thread, static and dynamic shared bytes, resident
    blocks an SM: :func:`ops.kernels.attrs`).  Needs the card."""
    lib = kernels.bind("top_select", "top_select_attrs",
                       [_I, ctypes.POINTER(ctypes.c_int)])
    return kernels.attrs("top_select", lib.top_select_attrs, k)


def top_select_work(N: int, k: int, slots: bool = False,
                    flat: bool = False):
    """K11's work → (bytes, operations): each key read once; the k
    indices (and slots, flat ids) out; three radix passes and the gather
    over N keys, the rank of the k kept (k log2 k, the least a comparison
    sort needs)."""
    log_k = max(k - 1, 1).bit_length()
    return (N * 4 + k * 4 * (1 + slots) + k * 8 * flat,
            4 * N + k * log_k)


def top_select(x, hi, lo=None, flat=None, S: int = 1, state=None,
               ws=None):
    """The top-k of the plain twin :func:`top_select_plain` (same
    arguments; the outputs are written in place).  On the card one
    cooperative launch of :func:`top_select_grid` blocks, no host read;
    k is at most :func:`top_select_max_k`.  ``ws`` is a workspace of at
    least :func:`top_select_words` int32 words, zero before its first
    launch (the kernel leaves it so); None allocates one."""
    if kernels.on_cpu(x):
        return top_select_plain(x, hi, lo, flat, S, state)
    dev = x.device
    N, k = x.shape[0], hi.shape[0]
    i32 = torch.int32
    chk = functools.partial(kernels.check, "top_select", device=dev)
    chk("x", x, torch.float32, (N,))
    chk("hi", hi, i32, (k,))
    if lo is not None:
        chk("lo", lo, i32, (k,))
    if flat is not None:
        chk("flat", flat, torch.int64, (k,))
    if state is not None:
        chk("state", state, i32, (SS.NSTATE,))
    if not 1 <= k <= min(N, top_select_max_k()) or N >= 1 << 31 or S < 1:
        raise ValueError(f"top_select: k={k} of N={N} (S={S}) out of range")
    G = top_select_grid(N, k, kernels.sm_count(dev))
    words = top_select_words(k, N)
    if ws is None:
        ws = torch.zeros(words, dtype=i32, device=dev)
    elif ws.dtype != i32 or ws.device != dev or not ws.is_contiguous() \
            or ws.numel() < words:
        raise ValueError(f"top_select: workspace must be a contiguous int32 "
                         f"tensor of at least {words} words on {dev}")
    lib = kernels.bind("top_select", "top_select_launch",
                       [_P, _I, _I, _I] + [_P] * 5 + [_I, _P])
    err = lib.top_select_launch(
        x.data_ptr(), N, k, S, hi.data_ptr(),
        None if lo is None else lo.data_ptr(),
        None if flat is None else flat.data_ptr(),
        None if state is None else state.data_ptr(), ws.data_ptr(), G,
        kernels.stream(dev),
    )
    kernels.launched("top_select", err)
    top_select.launches += 1
    kernels.note_work("top_select", lambda: top_select_work(
        N, k, lo is not None, flat is not None))


top_select.launches = 0
