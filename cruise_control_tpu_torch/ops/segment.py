"""Deterministic segment sums and segmented prefix sums.

The reference sums per-broker aggregates with ``jax.ops.segment_sum`` /
``.at[].add``.  The CUDA counterparts (``index_add_``, ``scatter_add_``)
accumulate floats with atomics, whose order changes from run to run, so
plans would not repeat.  Here every float sum goes through exact integer
arithmetic instead: each column is scaled by a power of two, rounded to
int64 fixed point, summed (integer addition is associative, so any order
gives the same bits), and scaled back.  The scale is order-free: ``2^e`` bounds ``N · max|v|`` over a column's N
rows (``e`` is the frexp exponent of the column's exact maximum plus
ceil(log2 N)), so no partial sum of the column leaves int64, and a kernel
that sums in another order — the budgeted cohort, hand kernel K4
(``csrc/budget_accept.cu``), reproduces these sums bit for bit — finds
the same scale.  An exponent from a float sum of magnitudes would depend
on that sum's order.  The sum is exact to within 2^-60 · N · max|v|,
rounded once to the input dtype — deterministic on every device.
"""

from __future__ import annotations

import math

import torch

#: fixed-point headroom: a column whose N rows satisfy N · max|v| ≤ 2^e
#: is quantized at 2^(e - _FP_BITS), so no partial sum can leave int64
_FP_BITS = 60


def _to_fixed(v: torch.Tensor):
    """float [N, C] → (int64 [N, C], per-column f64 scale [C])."""
    v64 = v.double()
    n = v.shape[0]
    # an all-zero (or empty) column has exponent 0: a finite scale
    mx = v64.abs().amax(dim=0) if n else v64.new_zeros(v.shape[1:])
    _, ex = torch.frexp(mx)
    e = ex.double() + (max(n, 1) - 1).bit_length()
    scale = torch.exp2(_FP_BITS - e)
    return torch.round(v64 * scale).to(torch.int64), scale


def segment_sum(values: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``out[b] = Σ values[i] over ids[i] == b`` for ``values [N, ...]``.

    ``ids`` must lie in ``[0, num_segments)`` (callers route padding to a
    dump segment and slice it off, as the reference does)."""
    ids = ids.long()
    shape = (num_segments,) + tuple(values.shape[1:])
    if not values.is_floating_point():
        return torch.zeros(shape, dtype=values.dtype,
                           device=values.device).index_add_(0, ids, values)
    flat = values.reshape(values.shape[0], math.prod(values.shape[1:]))
    q, scale = _to_fixed(flat)
    acc = torch.zeros((num_segments, flat.shape[1]), dtype=torch.int64,
                      device=values.device).index_add_(0, ids, q)
    return (acc.double() / scale).to(values.dtype).reshape(shape)


def column_sum(x: torch.Tensor) -> torch.Tensor:
    """Exact column sums of ``x [N, C]`` (the order-free fixed point of
    :func:`segment_sum`), rounded once to ``x``'s dtype: the kernels that
    need a broker-axis sum (K4, K10) reproduce it bit for bit."""
    return segment_sum(x, torch.zeros(x.shape[0], dtype=torch.long,
                                      device=x.device), 1)[0]


def segment_excl_prefix_sorted(sv: torch.Tensor,
                               first: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum of ``sv [N, C]`` (float) restarted at every row
    where ``first [N]`` is set — rows already grouped by segment, in order.
    Exact integer scan with the order-free scale of :func:`_to_fixed`, so
    the result does not depend on how the device schedules the scan, and
    K4 reproduces it."""
    n = sv.shape[0]
    q, scale = _to_fixed(sv)
    cs = torch.cumsum(q, dim=0)
    rank = torch.arange(n, device=sv.device)
    start = torch.cummax(torch.where(first, rank, torch.full_like(rank, -1)),
                         dim=0).values
    offset = cs[start] - q[start]
    return ((cs - offset - q).double() / scale).to(sv.dtype)
