"""K10's plain twin (``pool_tables_plain``, the repool's tables and
priorities) against the JAX reference on the hard cases ``chip_smoke.py``
holds the kernel to on the card, where the reference can express them:
replication factors 1 and 8, the incremental diet over every row, at a
touched count equal to its budget and one above it (the full rebuild),
every partition excluded, must-move slots beside a dead broker, and the
broker tables tiled to many brokers.

Both packages read the same model (the reference builds it, its arrays
are carried across).  Tolerances as ``tests/test_torch_pool_kernels.py``:
``base`` and every -inf pattern exact, ``size`` within rtol 1e-5,
priorities and destination scores within rtol 1e-5 / atol 1e-4 (f32 sums
in another order, on priorities that carry 1e6 / 1e5 repair bonuses)."""

import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import tpu_optimizer as T
from cruise_control_tpu.analyzer.context import AnalyzerContext as RefContext
from cruise_control_tpu.models.generators import random_cluster as ref_random
from cruise_control_tpu.ops import pools as ref_pools
from cruise_control_tpu_torch.analyzer import pool_kernels as PK
from cruise_control_tpu_torch.analyzer import step_state as SS
from cruise_control_tpu_torch.models.convert import device_model_from_numpy
from test_torch_ops import ATOL, RTOL

BASE = dict(seed=11, num_brokers=24, num_racks=6, num_partitions=360)


def _models(kw, edit=None):
    """(reference model, constraints), (port model, constraints) over one
    placement; ``edit`` maps the model's numpy fields to replacements,
    applied to both."""
    ctx = RefContext(ref_random(**kw))
    opt = T.TpuGoalOptimizer()
    m = opt._device_model(ctx)
    fields = {f.name: (None if getattr(m, f.name) is None
                       else np.asarray(getattr(m, f.name)))
              for f in dataclasses.fields(m)}
    if edit is not None:
        fields.update(edit(fields))
        m = dataclasses.replace(m, **{k: jnp.asarray(v) for k, v in
                                      fields.items() if v is not None})
    can = opt._constraint_arrays_np(ctx)
    ca_r = {k: jnp.asarray(v) for k, v in can.items()}
    pm = device_model_from_numpy(fields, device="cpu")
    ca = {k: torch.as_tensor(v) for k, v in can.items()}
    return (m, ca_r), (pm, ca)


def _carry(pt_valid):
    st = SS.StepState.empty(4, 4, 8, "cpu")
    st.state.copy_(st.initial(pt_valid))
    return st.state


def _buffers(pm):
    P, S = pm.assignment.shape
    return PK.PoolBuffers.empty(P, S, pm.capacity.shape[0], 16, 4, 16, "cpu")


def _close(got, want):
    want = np.asarray(want)
    assert np.array_equal(np.isinf(got), np.isinf(want))
    assert np.array_equal(got[np.isinf(got)], want[np.isinf(want)])
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


def _check(pb, m, ca_r, size_r, base_r):
    """The port's buffers against the reference's tables, priorities and
    destination scores over the given row tables."""
    np.testing.assert_allclose(pb.size.numpy(), np.asarray(size_r),
                               rtol=RTOL)
    assert np.array_equal(pb.base.numpy(), np.asarray(base_r))
    _close(pb.prio.numpy(), ref_pools.pool_prio(m, ca_r, size_r, base_r))
    _close(pb.lprio.numpy(), T._leadership_prio_rows(
        *T._leadership_prio_terms(m, ca_r), m.assignment, m.leader_slot,
        m.must_move, m.excluded))
    util = m.broker_load / jnp.maximum(m.capacity, 1e-9)
    _close(pb.dneg.numpy(), -(jnp.max(util, axis=1)
                              + jnp.where(m.dest_ok, 0.0, jnp.inf)))


def _full_repool(ref, port):
    (m, ca_r), (pm, ca) = ref, port
    pb, state = _buffers(pm), _carry(False)
    PK.pool_tables_plain(pm, ca, pb, state, -1)
    assert (int(state[SS.REPOOL]), int(state[SS.FULL])) == (1, 1)
    _check(pb, m, ca_r, *ref_pools.pool_row_tables(m))
    return pb


@pytest.mark.parametrize("rf", [1, 8])
def test_repool_at_replication_factor(rf):
    """A slot axis of one (no rack scan at all) and of eight (the widest
    the kernel takes; some partitions hold fewer replicas than slots)."""
    ref, port = _models(dict(BASE, num_racks=10, replication_factor=rf))
    assert port[0].assignment.shape[1] == rf
    _full_repool(ref, port)


def _moved(fields, rng, n):
    """``n`` partitions with one replica moved to another broker and the
    leader slot redrawn among the partition's replicas → (edit, touched)."""
    a = fields["assignment"].copy()
    ls = fields["leader_slot"].copy()
    B = fields["capacity"].shape[0]
    touched = np.zeros(a.shape[0], bool)
    for p in rng.choice(a.shape[0], size=n, replace=False):
        s = int(rng.integers(0, a.shape[1]))
        if a[p, s] >= 0:
            a[p, s] = int(rng.integers(0, B))
        ls[p] = int(rng.choice(np.nonzero(a[p] >= 0)[0]))
        touched[p] = True
    return {"assignment": a, "leader_slot": ls}, touched


@pytest.mark.parametrize("over", [None, 0, 1],
                         ids=["every_row", "at_budget", "over_budget"])
def test_incremental_diet_edges(over):
    """Tables stored from one placement, then some partitions moved: the
    repool refreshes only the touched rows when their count is at most
    the budget (every row touched, or exactly the budget) and rebuilds
    every row when it is one above — the reference's
    ``pool_row_tables_update`` and ``pool_row_tables`` either way."""
    ref0, port0 = _models(BASE)
    stored = _full_repool(ref0, port0)
    m0, _ = ref0
    rng = np.random.default_rng(3)
    P = port0[0].assignment.shape[0]
    n = P if over is None else 30
    fields = {f: np.asarray(getattr(m0, f)) for f in
              ("assignment", "leader_slot", "capacity")}
    edit, touched = _moved(fields, rng, n)
    ref, port = _models(BASE, edit=lambda f: edit)
    (m, ca_r), (pm, ca) = ref, port
    k = int(touched.sum())
    budget = k - (over or 0)
    pb = copy.deepcopy(stored)
    pb.tpp.copy_(torch.as_tensor(touched))
    state = _carry(True)
    PK.pool_tables_plain(pm, ca, pb, state, budget)
    incr = over != 1
    assert (int(state[SS.FULL]), int(state[SS.N_INCR])) == (int(not incr),
                                                            int(incr))
    assert not pb.tpp.any()
    size0, base0 = ref_pools.pool_row_tables(m0)
    tables = (ref_pools.pool_row_tables_update(
        m, size0, base0, jnp.asarray(touched), budget) if incr
        else ref_pools.pool_row_tables(m))
    _check(pb, m, ca_r, *tables)


def _all_excluded(f):
    return {"excluded": np.ones_like(f["excluded"])}


def _must_move_dead(f):
    """A dead broker whose replicas must move, a few more must-move slots
    elsewhere, and the dead broker closed to moves and leadership."""
    a = f["assignment"]
    dead = int(a[a >= 0][0])
    rng = np.random.default_rng(5)
    must = (a == dead) | ((rng.random(a.shape) < 0.05) & (a >= 0))
    out = {"must_move": must}
    for k in ("alive", "dest_ok", "lead_ok"):
        v = f[k].copy()
        v[dead] = False
        out[k] = v
    return out


def _tiled(f, tile=12):
    """The broker tables tiled ``tile`` times and the replicas spread over
    every copy at random (empty slots kept)."""
    rng = np.random.default_rng(7)
    B = f["capacity"].shape[0]
    out = {}
    for k, v in f.items():
        if v is not None and v.ndim >= 1 and v.shape[0] == B \
                and k not in ("assignment",):
            out[k] = np.concatenate([v] * tile, axis=0)
    a = f["assignment"]
    out["assignment"] = np.where(
        a >= 0, rng.integers(0, B * tile, a.shape), a).astype(a.dtype)
    return out


@pytest.mark.parametrize("edit", [_all_excluded, _must_move_dead, _tiled],
                         ids=["all_excluded", "must_move_dead", "tiled"])
def test_repool_on_edge_models(edit):
    """Every partition excluded (only must-move slots may enter the pool),
    must-move slots beside a dead broker, and twelve times the brokers
    (the broker-axis sums and scales over a longer column)."""
    kw = dict(BASE, dead_brokers=1) if edit is _must_move_dead else BASE
    ref, port = _models(kw, edit=edit)
    pb = _full_repool(ref, port)
    if edit is _must_move_dead:
        assert bool(port[0].must_move.any())
        assert np.isfinite(pb.base.numpy()).any()
    if edit is _all_excluded:
        base = pb.base.numpy()
        must = port[0].must_move.numpy()
        assert np.isinf(base[~must]).all()
