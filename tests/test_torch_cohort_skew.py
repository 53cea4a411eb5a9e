"""K4's and K7's wrappers on the CPU, against the JAX reference, on the
inputs their sorts find hardest: every cohort row on one destination or
one source, one row, 777 rows (no power of two), 10 000 brokers; and
tie-rich compaction keys with -0.0, +0.0 and a tie across the C-th key.

On CPU tensors the wrappers run their plain twins (``budget_accept_plain``
and ``_compact_rows``), the versions the card's kernels are held to bit
for bit in ``chip_smoke.py``.  The cohort's move vectors are dyadic (a few
bits of mantissa), so every prefix sum and draw-down is exact in f32 and
the reference's f32 sums decide as the port's exact ones do: the accept
masks match exactly, the starting budgets within RTOL and ATOL of
tests/test_torch_step_kernels.py.  Every compaction output matches
exactly (the two sides do the same f32 operations on the same values)."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import tpu_optimizer as T
from cruise_control_tpu_torch.analyzer import compact_kernel as K7
from cruise_control_tpu_torch.analyzer import step_kernels as SK
from cruise_control_tpu_torch.common.resources import NUM_RESOURCES
from test_torch_compact_kernel import compaction_inputs, ref_compaction
from test_torch_step_kernels import ATOL, RTOL, as_t, carried

NR = NUM_RESOURCES


def dyadic_vectors(rng, n, budgets):
    """[n, NR + 2] f32 move vectors: per resource a multiple of a power of
    two near an eighth of the mean budget, a replica count of one, and a
    potential NW-out in sixteenths."""
    unit = 2.0 ** np.floor(np.log2(np.maximum(budgets.mean(0), 1e-3) / 8))
    return np.concatenate([
        rng.integers(0, 9, (n, NR)) * unit, np.ones((n, 1)),
        rng.integers(0, 16, (n, 1)) / 16.0], 1).astype(np.float32)


def big_model(rng, B):
    """A broker table of B brokers (capacities, loads, counts, flags) for
    both sides, and its constraint arrays."""
    cap = rng.choice([100.0, 150.0, 300.0], (B, NR)).astype(np.float32)
    util = rng.uniform(0.1, 0.9, B)
    load = (cap * (util[:, None] + rng.uniform(-0.02, 0.02, (B, NR)))
            ).astype(np.float32)
    cols = dict(capacity=cap, broker_load=load,
                alive=rng.random(B) < 0.98,
                dest_ok=rng.random(B) < 0.95,
                rcount=np.round(10 + 30 * util).astype(np.float32),
                pot_nwout=(cap[:, 2] * util * 1.1).astype(np.float32))
    ca = dict(avg_rcount=np.float32(25.0),
              cap_threshold=np.array([0.8, 0.8, 0.8, 0.8], np.float32))
    ref = types.SimpleNamespace(broker_cload=None,
                                **{k: jnp.asarray(v) for k, v in cols.items()})
    port = types.SimpleNamespace(broker_cload=None,
                                 **{k: as_t(v) for k, v in cols.items()})
    return (ref, {k: jnp.asarray(v) for k, v in ca.items()}), (
        port, {k: torch.tensor(v) for k, v in ca.items()})


def cohort(case):
    """(reference model, constraints), (port model, constraints) and the
    cohort's (dst, src, vec, eligible) for ``case``."""
    rng = np.random.default_rng(
        {"one_dst": 31, "one_src": 32, "c1": 33, "c777": 34, "b10k": 35}[case])
    if case == "b10k":
        (m, ca_r), (pm, ca) = big_model(rng, 10_000)
        n = 1024
    else:
        (m, ca_r, _, _), (pm, ca, _) = carried(4, False)
        n = {"c1": 1, "c777": 777}.get(case, 1024)
    B = pm.capacity.shape[0]
    dst = rng.integers(0, B, n).astype(np.int32)
    src = rng.integers(0, B, n).astype(np.int64)
    if case == "one_dst":
        dst[:] = int(np.argmax(np.asarray(T._step_budgets(m, ca_r)[1])[:, 0]))
    if case == "one_src":
        src[:] = int(np.argmax(np.asarray(T._step_budgets(m, ca_r)[0])[:, 0]))
    budgets = np.asarray(T._step_budgets(m, ca_r)[1])[:, :NR]
    vec = dyadic_vectors(rng, n, budgets[np.isfinite(budgets).all(1)])
    elig = rng.random(n) < 0.85
    return (m, ca_r), (pm, ca), (dst, src, vec, elig)


@pytest.mark.parametrize("case,slack", [
    ("one_dst", 1.0), ("one_dst", 1.3), ("one_src", 1.0), ("c1", 1.0),
    ("c777", 1.0), ("b10k", 1.0),
])
def test_budget_accept_skewed_cohort_matches_reference(case, slack):
    """K4's wrapper (plain twin on the CPU) on one cohort: the budgets with
    the slack on the soft dims, two rounds of acceptance — against the
    reference's ``_step_budgets`` and ``_budget_accept``."""
    (m, ca_r), (pm, ca), (dst, src, vec, elig) = cohort(case)
    before = SK.budget_accept.launches
    acc, sbud, dbud = SK.budget_accept(pm, ca, as_t(dst), as_t(src),
                                       as_t(vec), as_t(elig), slack)
    assert SK.budget_accept.launches == before   # CPU tensors: plain twin
    sb_r, db_r = T._step_budgets(m, ca_r)
    if slack != 1.0:
        soft = NR + 2
        sb_r = sb_r.at[:, :soft].multiply(slack)
        db_r = db_r.at[:, :soft].multiply(slack)
    ref = np.asarray(T._budget_accept(
        jnp.asarray(dst), jnp.asarray(src), jnp.asarray(vec), db_r, sb_r,
        jnp.asarray(elig)))
    assert np.array_equal(ref, acc.numpy())
    for got, want in ((sbud, sb_r), (dbud, db_r)):
        want = np.asarray(want)
        assert np.array_equal(np.isinf(got.numpy()), np.isinf(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got.numpy()[fin], want[fin], rtol=RTOL,
                                   atol=ATOL)
    # the case is what it claims, and the filters decided something
    assert acc.shape == (len(dst),)
    if case == "one_dst":
        assert len(np.unique(dst)) == 1 and 0 < ref.sum() < elig.sum()
    if case == "one_src":
        assert len(np.unique(src)) == 1 and 0 < ref.sum() < elig.sum()
    if case in ("c777", "b10k"):
        assert 0 < ref.sum() < elig.sum()


def sorted_keys(x):
    """The compaction's NROW keys in order, -0.0 counted as +0.0."""
    key = np.concatenate([x["q_scores"].reshape(-1), x["bl"][0]])
    return np.sort(np.where(key == 0, np.float32(0), key))


def compaction_case(case):
    """Tie-rich compaction inputs and C for ``case``: C in the middle of
    the longest run of equal keys, one kept row, 777 of 1 000 keys (with
    percentile loads), 1 024 of 50 000 keys over 10 000 brokers."""
    if case == "b10k":
        return compaction_inputs(11, False, B=10_000, K=4096, P=20_000), 1024
    if case == "c777":
        return compaction_inputs(12, True, B=200, K=600, P=300), 777
    x = compaction_inputs(13, False, B=100, K=300, P=200)
    if case == "c1":
        return x, 1
    srt = sorted_keys(x)
    vals, start, count = np.unique(srt, return_index=True,
                                   return_counts=True)
    i = int(np.argmax(np.where(np.isfinite(vals), count, 0)))
    return x, int(start[i] + count[i] // 2)


@pytest.mark.parametrize("case", ["tie_at_c", "c1", "c777", "b10k"])
def test_compact_rows_tie_rich_matches_reference(case):
    """K7's wrapper (plain twin on the CPU) against the jnp transcript of
    the reference's step body: the kept rows, their order, ``rep`` and the
    one-row-per-partition filter, every output exactly."""
    x, C = compaction_case(case)
    cload = x["pload"].shape[1] > 2 * NR + 1
    lc = x["pload"][:, 2 * NR + 1:3 * NR + 1] if cload else None

    def model(conv):
        return types.SimpleNamespace(
            leader_slot=conv(x["leader_slot"]), pload=conv(x["pload"]),
            leader_cload=None if lc is None else conv(lc))

    keys = ("q_scores", "q_rows")
    tail = ("best_d", "dest_pool", "kp", "ks", "sb")
    st, vals = x["src_term"], x["vals"]
    row_scores = jnp.asarray(st)[:, None] + (jnp.asarray(vals)
                                             - jnp.asarray(st)[:, None])
    ref = ref_compaction(
        model(jnp.asarray), *(jnp.asarray(x[k]) for k in keys),
        tuple(jnp.asarray(b) for b in x["bl"]), row_scores,
        *(jnp.asarray(x[k]) for k in tail), C, -1e-4)
    before = K7.compact_rows.launches
    got = K7.compact_rows(
        model(as_t), *(as_t(x[k]) for k in keys),
        tuple(as_t(b) for b in x["bl"]), as_t(st), as_t(vals),
        *(as_t(x[k]) for k in tail), C, -1e-4)
    assert K7.compact_rows.launches == before     # CPU tensors: plain twin
    for name, a, b in zip(K7.Compacted._fields, got, ref):
        assert np.array_equal(a.numpy(), np.asarray(b)), name
    # the keys hold both zeros; in the tie case a run of equal keys
    # straddles the C-th (-0.0 and +0.0 count as one score)
    srt = sorted_keys(x)
    assert len(srt) > C
    if case == "tie_at_c":
        assert C > 1 and srt[C - 1] == srt[C]
    zeros = np.concatenate([x["q_scores"].reshape(-1), x["bl"][0]])
    zeros = zeros[zeros == 0]
    assert np.signbit(zeros).any() and (~np.signbit(zeros)).any()
