"""The plain twin of hand kernel K12 (``whatif.verdict_kernels:
verdict_plain``, the version the card's kernel is held to bit for bit in
``chip_smoke.py``) against the reference's ``_EVALUATE``
(``cruise_control_tpu/whatif/engine.py``), key by key.

Both read the same numpy arrays.  Integer and bool keys must be equal.
They are read from sums — the reference's f32 sums in XLA's order, the
port's exact fixed-point ones — so each case is first checked to be
tie-free, in f64: every surviving broker's hosted load more than
``TIE_MARGIN`` (relative) from its capacity, the total clear of the
surviving capacity, and the smallest utilization unique or an exact 0.0.
A case that is not tie-free fails: it would not test what it claims.
``dataMoveMB`` and ``maxBrokerUtilization`` agree within ``FLOAT_RTOL``:
an f32 sum of up to P·S positive terms, in any order, is within about
log2(P·S) · 2^-24 of the exact sum in a tree order and within P·S · 2^-24
in a sequential one; the fixtures' largest gap is ~1e-7."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu import whatif as ref
from cruise_control_tpu.models.generators import random_cluster as ref_random
from cruise_control_tpu.whatif import artifact as ref_artifact
from cruise_control_tpu.whatif.engine import _EVALUATE, _RATE_MASK
from cruise_control_tpu_torch.whatif import verdict_kernels as VK

FLOAT_RTOL = 1e-5
TIE_MARGIN = 1e-4


def _inputs(state, batch):
    """The engine's nine arrays, as numpy."""
    return (np.asarray(state.assignment), np.asarray(state.leader_slot),
            np.asarray(state.leader_load, np.float32),
            np.asarray(state.follower_load, np.float32),
            np.asarray(state.broker_capacity, np.float32),
            np.asarray(state.broker_rack), np.asarray(state.broker_alive()),
            batch.dead, batch.scale)


def _case(name):
    """(numpy inputs, valid futures) of one named case."""
    if name == "ragged":
        # 77 brokers (3 dead), 3 001 partitions, a bucket of 8 with 3 valid
        state = ref_random(seed=5, num_brokers=77, num_racks=7,
                           num_partitions=3001, dead_brokers=3)
        futures = [ref.FutureSpec(name="b10", events=(ref.broker_loss(10),)),
                   ref.FutureSpec(name="r2", events=(ref.rack_loss(2),)),
                   ref.FutureSpec(name="x1.5",
                                  events=(ref.traffic_scale(1.5),))]
    elif name == "artifact_50b_1k":
        state = ref_random(seed=42, num_brokers=50, num_racks=10,
                           num_partitions=1000)
        futures = ref_artifact.artifact_futures(state, 64)
    elif name == "all_dead":
        state = ref_random(seed=7, num_brokers=12, num_racks=4,
                           num_partitions=60)
        futures = [ref.FutureSpec(name="all", events=tuple(
                       ref.rack_loss(r) for r in range(4))),
                   ref.FutureSpec(name="b3", events=(ref.broker_loss(3),))]
    elif name == "no_offline":
        state = ref_random(seed=9, num_brokers=20, num_racks=5,
                           num_partitions=200)
        futures = [ref.FutureSpec(name="x2", events=(ref.traffic_scale(2.0),)),
                   ref.FutureSpec(name="t1",
                                  events=(ref.topic_growth(1, 3.0),))]
    else:
        assert name == "tied_prio"
        # partitions 0-39 carry one copied load row, the heaviest, for
        # leader and followers alike: their offline slots tie on priority
        # above every other slot, and the top actions go to the lowest
        # flat indices
        state = ref_random(seed=11, num_brokers=12, num_racks=4,
                           num_partitions=120)
        ll = np.asarray(state.leader_load).copy()
        fl = np.asarray(state.follower_load).copy()
        ll[:40] = fl[:40] = 2 * ll.max(axis=0)
        state = state.replace(leader_load=jnp.asarray(ll),
                              follower_load=jnp.asarray(fl))
        futures = [ref.FutureSpec(name=f"b{b}", events=(ref.broker_loss(b),))
                   for b in range(3)]
    batch = ref.compile_futures(state, futures)
    return _inputs(state, batch), len(futures)


CASES = ["ragged", "artifact_50b_1k", "all_dead", "no_offline", "tied_prio"]


def _tie_free(a, ls, ll, fl, cap, rack, alive0, dead, scale):
    """Why the case is not tie-free (empty when it is), in f64."""
    P, S = a.shape
    B, R = cap.shape
    exists = a >= 0
    bid = np.clip(a, 0, None)
    lscale = np.float32(1.0) + (scale[:, :, None] - np.float32(1.0)) \
        * np.asarray(_RATE_MASK, np.float32)
    is_lead = np.arange(S)[None, :] == ls[:, None]
    slot = np.where(is_lead[None, :, :, None], (ll[None] * lscale)[:, :, None],
                    (fl[None] * lscale)[:, :, None]) * exists[None, :, :, None]
    slot = slot.astype(np.float64)
    cap64 = cap.astype(np.float64)
    why = []
    for n in range(dead.shape[0]):
        alive = alive0 & ~dead[n]
        sa = exists & alive[bid]
        hosted = np.zeros((B, R))
        np.add.at(hosted, bid[sa], slot[n][sa])
        gap = np.abs(hosted - cap64)[alive]
        if (gap <= TIE_MARGIN * cap64[alive]).any():
            why.append(f"future {n}: hosted load at a capacity")
        total = slot[n].sum(axis=(0, 1))
        cap_alive = (cap64 * alive[:, None]).sum(axis=0)
        if (np.abs(total - cap_alive) <= TIE_MARGIN * cap_alive).any():
            why.append(f"future {n}: total at the surviving capacity")
        util = np.sort((hosted / np.maximum(cap64, 1e-9)).max(axis=1)[alive])
        if util.size > 1 and util[0] != 0.0 \
                and util[1] - util[0] <= TIE_MARGIN * util[1]:
            why.append(f"future {n}: smallest utilization tied")
    return why


def _plain(args):
    return VK.verdict_plain(*(torch.tensor(x) for x in args))


@pytest.mark.parametrize("case", CASES)
def test_plain_twin_matches_reference(case):
    args, n_valid = _case(case)
    why = _tie_free(*args)
    assert not why, f"{case} is not tie-free: {why}"
    want = {k: np.asarray(v) for k, v in _EVALUATE(
        *(jnp.asarray(x) for x in args)).items()}
    got = {k: v.numpy() for k, v in _plain(args).items()}
    assert sorted(got) == sorted(want) == sorted(VK.KEYS)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if w.dtype == np.float32:
            np.testing.assert_allclose(g, w, rtol=FLOAT_RTOL, err_msg=k)
        else:
            assert np.array_equal(g, w), (case, k, g, w)
    # the case covers what it is named for
    top = got["topActionPartition"][:n_valid]
    if case == "all_dead":
        assert got["unavailablePartitions"][0] == args[0].shape[0]
        assert got["topActionDestination"][0, 0] == 0        # argmin of inf
        assert got["capacityInfeasible"][0] and not got["survivable"][0]
    elif case == "no_offline":
        assert (got["movesRequired"][:n_valid] == 0).all()
        assert (top == -1).all()
    elif case == "tied_prio":
        # broker b's offline slots among partitions 0-39 tie; the top-4
        # holds the lowest partitions of the tie, ascending
        for n in range(n_valid):
            hit = np.nonzero((args[0][:40] == n).any(axis=1))[0]
            assert list(top[n]) == list(hit[:4]), (n, top[n], hit)
    elif case == "ragged":
        assert args[6].sum() == 74 and n_valid == 3
        assert (got["movesRequired"][n_valid:] > 0).all()    # padding rows
        assert (top[0] >= 0).all()


def test_partition_permutation_keeps_hosted_bits():
    args, _ = _case("ragged")
    a, ls, ll, fl, cap, rack, alive0, dead, scale = args
    perm = np.random.default_rng(3).permutation(a.shape[0])
    pargs = (a[perm], ls[perm], ll[perm], fl[perm], cap, rack, alive0, dead,
             scale[:, perm])
    t = lambda xs: [torch.tensor(x) for x in xs]  # noqa: E731
    got, want = VK._verdict_rows(*t(pargs)), VK._verdict_rows(*t(args))
    assert torch.equal(got["hosted"], want["hosted"])
    for k in VK.KEYS:
        if not k.startswith("topAction") or k == "topActionDestination":
            assert torch.equal(got[k], want[k]), k


def test_wrapper_runs_the_twin_on_cpu_tensors():
    args, _ = _case("tied_prio")
    before = VK.whatif_verdict.launches
    got = VK.whatif_verdict(*(torch.tensor(x) for x in args))
    assert VK.whatif_verdict.launches == before        # CPU: the plain twin
    want = _plain(args)
    for k, dt in VK.KEYS.items():
        assert got[k].dtype == dt and torch.equal(got[k], want[k]), k


def test_chunked_twin_is_bit_identical(monkeypatch):
    args, _ = _case("artifact_50b_1k")
    whole = _plain(args)
    # at most three futures' slot loads a chunk
    monkeypatch.setattr(VK, "_PLAIN_CHUNK", 3 * args[0].size * 4)
    chunked = _plain(args)
    for k in VK.KEYS:
        assert torch.equal(chunked[k], whole[k]), k
