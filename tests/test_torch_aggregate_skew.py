"""The plain twins of K12 ``whatif_verdict`` and K9 ``recompute_aggregates``
against the JAX reference on skewed placements: one broker hosts at least
a quarter of all replica slots, and in some futures it is dead.  These
are the contention cases of the kernels' per-broker sums
(``chip_smoke.py`` holds the kernels to the same twins on the card, bit
for bit, on the same kind of placement).

K12's twin (``whatif.verdict_kernels.verdict_plain``) is held to the
reference's ``_EVALUATE`` key by key, as ``test_torch_whatif_kernel.py``
does and with its tolerances: integer and bool keys equal on tie-free
cases, ``dataMoveMB`` and ``maxBrokerUtilization`` within ``FLOAT_RTOL``.
K9's twin (``analyzer.commit_kernels._recompute_aggregates``) is held to
the reference's ``_recompute_aggregates``: counts equal, float aggregates
within rtol 1e-6 / atol 1e-5 (exact fixed point against XLA's f32 order),
as ``test_torch_commit_kernel.py`` does."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cruise_control_tpu import whatif as ref
from cruise_control_tpu.analyzer import tpu_optimizer as T
from cruise_control_tpu.models.generators import random_cluster as ref_random
from cruise_control_tpu.whatif.engine import _EVALUATE
from cruise_control_tpu_torch.analyzer import commit_kernels as K89
from cruise_control_tpu_torch.whatif import verdict_kernels as VK
from test_torch_step_kernels import carried
from test_torch_whatif_kernel import FLOAT_RTOL, _inputs, _tie_free

RTOL, ATOL = 1e-6, 1e-5
AGGREGATES = ("broker_load", "leader_nwin", "pot_nwout", "rcount", "lcount",
              "broker_cload")
HOT = 0


def skewed(a: np.ndarray) -> np.ndarray:
    """numpy reference of ``chip_smoke.skew_placement``: broker HOT in the
    first slot of every partition without it, but one in four."""
    a = a.copy()
    for p in range(a.shape[0]):
        if p % 4 != 0 and not (a[p] == HOT).any():
            a[p, 0] = HOT
    return a


def share(a: np.ndarray) -> float:
    live = a[a >= 0]
    return np.bincount(live).max() / live.size


def test_skew_placement_matches_numpy_and_holds_a_quarter():
    state = ref_random(seed=21, num_brokers=30, num_racks=5,
                       num_partitions=400)
    a = np.asarray(state.assignment)
    got = chip_smoke.skew_placement(torch.tensor(a), HOT).numpy()
    assert np.array_equal(got, skewed(a))
    assert np.array_equal(a, np.asarray(state.assignment))   # not in place
    assert share(got) >= 0.25 > share(a)
    # one replica a broker a partition, as before
    for row in got:
        live = row[row >= 0]
        assert len(set(live.tolist())) == live.size


def _skew_case(name):
    """(numpy inputs, valid futures) on a skewed placement: the hot broker
    alive in every future, or lost (alone or with its rack) in some."""
    state = ref_random(seed=23, num_brokers=16, num_racks=4,
                       num_partitions=320)
    state = state.replace(
        assignment=jnp.asarray(skewed(np.asarray(state.assignment))))
    hot_rack = int(np.asarray(state.broker_rack)[HOT])
    other = (hot_rack + 1) % 4
    if name == "hot_alive":
        futures = [ref.FutureSpec(name="x1.3",
                                  events=(ref.traffic_scale(1.3),)),
                   ref.FutureSpec(name="b5", events=(ref.broker_loss(5),)),
                   ref.FutureSpec(name="r", events=(ref.rack_loss(other),))]
    else:
        futures = [ref.FutureSpec(name="hot", events=(ref.broker_loss(HOT),)),
                   ref.FutureSpec(name="x1.2",
                                  events=(ref.traffic_scale(1.2),)),
                   ref.FutureSpec(name="hot_rack",
                                  events=(ref.rack_loss(hot_rack),))]
    return _inputs(state, ref.compile_futures(state, futures)), len(futures)


@pytest.mark.parametrize("case", ["hot_alive", "hot_dead"])
def test_skewed_verdicts_match_reference(case):
    args, n_valid = _skew_case(case)
    assert share(args[0]) >= 0.25
    why = _tie_free(*args)
    assert not why, f"{case} is not tie-free: {why}"
    want = {k: np.asarray(v) for k, v in _EVALUATE(
        *(jnp.asarray(x) for x in args)).items()}
    got = {k: v.numpy() for k, v in VK.verdict_plain(
        *(torch.tensor(x) for x in args)).items()}
    assert sorted(got) == sorted(want) == sorted(VK.KEYS)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if w.dtype == np.float32:
            np.testing.assert_allclose(g, w, rtol=FLOAT_RTOL, err_msg=k)
        else:
            assert np.array_equal(g, w), (case, k, g, w)
    dead_hot = args[7][:n_valid, HOT]
    moves = got["movesRequired"][:n_valid]
    hosted = int((args[0] == HOT).sum())
    if case == "hot_alive":
        assert not dead_hot.any()
        # the hot broker is the most utilized survivor and overloaded
        assert (got["overloadedBrokers"][:n_valid] >= 1).all()
    else:
        assert dead_hot[0] and dead_hot[2] and not dead_hot[1]
        # every slot the hot broker held goes offline
        assert moves[0] == hosted and moves[2] > hosted
        assert (got["topActionSource"][[0, 2]] >= 0).all()


@pytest.mark.parametrize("cload", [False, True], ids=["mean", "percentile"])
def test_skewed_aggregates_match_reference(cload):
    (m, _, _, _), (pm, _, _) = carried(8, cload)
    a = skewed(np.asarray(m.assignment))
    assert share(a) >= 0.25
    m = dataclasses.replace(m, assignment=jnp.asarray(a))
    pm = dataclasses.replace(pm, assignment=torch.tensor(a))
    want = T._recompute_aggregates(m)
    before = K89.recompute_aggregates.launches
    got = K89.recompute_aggregates(pm)
    assert K89.recompute_aggregates.launches == before    # CPU: the twin
    plain = K89._recompute_aggregates(pm)
    for f in AGGREGATES:
        g, w = getattr(got, f), getattr(want, f)
        if g is None:
            assert w is None and not cload
            continue
        assert torch.equal(g, getattr(plain, f)), f
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=f)
    assert float(got.rcount[HOT]) == (a == HOT).sum()
