"""K2's wrapper on the CPU, against the JAX reference and its plain twin,
and the plumbing every step kernel shares.

On CPU tensors every wrapper runs its plain twin, so these tests pin (a)
K2's packed layout, column by column, against the reference's
``move_grid_terms`` and broker cost; (b) that ``grid_rescore`` on the CPU
is the plain K2-then-K1 chain; (c) the wrappers' input checks; (d) that
``chip_smoke.py`` builds, checks and lists every kernel source.  K3 is
tested in tests/test_torch_reduce_kernels.py, K4 in
tests/test_torch_cohort_kernels.py, K5 in tests/test_torch_auction_kernel.py.
The seeded inputs below are shared with those files.  Integers and masks
match exactly; floats within the tolerances of tests/test_torch_ops.py
(rtol 1e-5, atol 1e-4: f32 sums in another order, on scores carrying
1e6 / 1e4 bonuses)."""

import ast
import dataclasses
import functools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import tpu_optimizer as T
from cruise_control_tpu.analyzer.context import AnalyzerContext as RefContext
from cruise_control_tpu.models.generators import random_cluster as ref_random
from cruise_control_tpu.ops import cost as ref_cost
from cruise_control_tpu.ops import grid as ref_grid
from cruise_control_tpu_torch.analyzer import cuda_optimizer as C
from cruise_control_tpu_torch.common.resources import NUM_RESOURCES
from cruise_control_tpu_torch.models.convert import device_model_from_numpy
from cruise_control_tpu_torch.ops import grid as G
from cruise_control_tpu_torch.ops import kernels

RTOL, ATOL = 1e-5, 1e-4
REPO = Path(__file__).resolve().parents[1]
CFG = C.CudaSearchConfig()


def as_t(x):
    return torch.tensor(np.asarray(x))


@functools.lru_cache(maxsize=None)
def carried(seed: int, cload: bool):
    """(reference model, constraints, pools), (port model, constraints,
    pools) over one seeded placement with a dead broker; ``cload`` adds
    the same seeded percentile capacity loads to both."""
    state = ref_random(seed=seed, num_brokers=16, num_racks=4,
                       num_partitions=240, dead_brokers=1)
    ctx = RefContext(state)
    opt = T.TpuGoalOptimizer()
    m = opt._device_model(ctx)
    if cload:
        rng = np.random.default_rng(seed)
        scale = lambda x: (np.asarray(x) * rng.uniform(  # noqa: E731
            1.0, 1.4, np.shape(x))).astype(np.float32)
        lc, fc = scale(m.leader_load), scale(m.follower_load)
        bc = scale(m.broker_load)
        m = dataclasses.replace(
            m, leader_cload=jnp.asarray(lc), follower_cload=jnp.asarray(fc),
            broker_cload=jnp.asarray(bc), pload=ref_cost.pack_pload(
                m.leader_load, m.follower_load, m.excluded,
                jnp.asarray(lc), jnp.asarray(fc)))
    can = opt._constraint_arrays_np(ctx)
    ca_r = {k: jnp.asarray(v) for k, v in can.items()}
    K, D = opt._pool_sizes(ctx.num_partitions, ctx.max_rf, ctx.num_brokers)
    pools_r = T._build_pools(m, opt.config, ca_r, K, D)
    fields = {f.name: (None if getattr(m, f.name) is None
                       else np.asarray(getattr(m, f.name)))
              for f in dataclasses.fields(m)}
    pm = device_model_from_numpy(fields, device="cpu")
    ca = {k: torch.as_tensor(v) for k, v in can.items()}
    return (m, ca_r, pools_r, opt), (pm, ca, tuple(map(as_t, pools_r)))


# ---- K2's packed tables (B2 + K1's packing) ---------------------------------

@pytest.mark.parametrize("cload", [False, True], ids=["mean", "percentile"])
def test_grid_terms_packed_columns_match_reference(cload):
    """K2's plain tables hold ``move_grid_terms`` and the destination
    columns in the layout csrc/grid_top_r.cu reads, column by column,
    against the reference's terms."""
    (m, ca_r, (kp, ks, dp, _, _), opt), (pm, ca, pools) = carried(6, cload)
    pkp, pks, pdp = pools[:3]
    t_ref = ref_grid.move_grid_terms(m, opt.config, ca_r, kp, ks)
    before = G.grid_terms.launches
    pk = G.grid_terms(pm, CFG, ca, pkp, pks, pdp)
    assert G.grid_terms.launches == before       # CPU tensors: plain twin
    R, S = NUM_RESOURCES, pm.assignment.shape[1]
    src_f, src_i, dst_f, dst_i = (pk[k].numpy() for k in
                                  ("src_f", "src_i", "dst_f", "dst_i"))
    assert src_f.shape == (pkp.shape[0], G._SF)
    assert src_i.shape == (pkp.shape[0], 3 * S + 2)
    assert dst_f.shape == (pdp.shape[0], G._DF) and dst_i.shape[1] == G._DI
    ref = {k: np.asarray(v) for k, v in t_ref.items()}
    for cols, key in ((slice(0, R), "move_load"), (slice(R, 2 * R),
                      "cmove_load"), (2 * R, "l_delta"),
                      (2 * R + 1, "lnwin_delta"), (2 * R + 2, "pot_delta"),
                      (G.SRC_TERM_COL, "src_term")):
        np.testing.assert_allclose(src_f[:, cols], ref[key], rtol=RTOL,
                                   atol=ATOL, err_msg=key)
    for cols, key in ((slice(0, S), "row"), (slice(S, 2 * S), "origin_row"),
                      (slice(2 * S, 3 * S), "other_racks"), (3 * S, "src")):
        assert np.array_equal(src_i[:, cols], ref[key]), key
    flags = src_i[:, 3 * S + 1]
    assert np.array_equal(flags & 1, ref["leader_now"])
    assert np.array_equal(flags >> 1 & 1,
                          ref["slot_exists"] & ~ref["excluded"])
    d_c = np.maximum(np.asarray(dp), 0)
    assert np.array_equal(dst_i[:, 0], d_c)
    assert np.array_equal(dst_i[:, 1], np.asarray(m.rack)[d_c])
    assert np.array_equal(dst_i[:, 2] >> 1 & 1, np.asarray(m.lead_ok)[d_c])
    load = np.asarray(m.broker_load)[d_c]
    np.testing.assert_array_equal(dst_f[:, 2 * R:3 * R], load)
    cl = load if not cload else np.asarray(m.broker_cload)[d_c]
    np.testing.assert_array_equal(dst_f[:, 3 * R:4 * R], cl)
    # f_dst_old (last column) against the reference's broker cost
    f_old = ref_cost.broker_cost(
        opt.config, ca_r, m.capacity[d_c], m.broker_load[d_c],
        m.leader_nwin[d_c], m.pot_nwout[d_c], m.rcount[d_c], m.lcount[d_c],
        cload=m.broker_cload[d_c] if cload else None)
    np.testing.assert_allclose(dst_f[:, -1], np.asarray(f_old), rtol=RTOL,
                               atol=ATOL)
    # and K2's plain twin is move_grid_terms, then K1's packing
    plain = G.pack_grid_inputs(pm, CFG, ca, pdp, G.move_grid_terms(
        pm, CFG, ca, pkp, pks))
    for k in ("src_f", "src_i", "dst_f", "dst_i"):
        assert torch.equal(pk[k], plain[k]), k


def test_grid_rescore_cpu_is_the_plain_chain():
    (_, _, _, _), (pm, ca, pools) = carried(6, False)
    kp, ks, dp = pools[:3]
    R = min(C.DESTS_PER_SOURCE, dp.shape[0])
    counts = (G.grid_terms.launches, G.launch_grid_top_r.launches)
    src_term, vals, idx = G.grid_rescore(pm, CFG, ca, kp, ks, dp, R)
    assert (G.grid_terms.launches, G.launch_grid_top_r.launches) == counts
    terms = G.move_grid_terms(pm, CFG, ca, kp, ks)
    want = G.grid_top_r_plain(pm, CFG, ca, kp, ks, dp, terms, R)
    assert torch.equal(src_term, terms["src_term"])
    assert torch.equal(vals, want[0]) and torch.equal(idx, want[1])


def test_kernel_input_check_raises():
    x = torch.zeros((3, 2), dtype=torch.float32)
    kernels.check("k", "x", x, torch.float32, (3, 2), x.device)
    for bad in (x.double(), x.t(), x[:2]):
        with pytest.raises(ValueError, match="k: x must be"):
            kernels.check("k", "x", bad, torch.float32, (3, 2), x.device)
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        kernels.launched("k", 9)


# ---- chip_smoke.py covers every kernel --------------------------------------

def test_chip_smoke_builds_checks_and_lists_every_kernel():
    sources = {p.stem for p in
               (REPO / "cruise_control_tpu_torch" / "csrc").glob("*.cu")}
    text = (REPO / "chip_smoke.py").read_text()
    tree = ast.parse(text)
    kernels_dict = next(
        node.value for node in tree.body
        if isinstance(node, ast.Assign)
        and any(getattr(t, "id", None) == "KERNELS" for t in node.targets))
    listed = {k.value for k in kernels_dict.keys}
    assert listed == sources
    assert "kernels.build(list(KERNELS))" in text
    assert "for name, replaces in KERNELS.items():" in text
    counted = next(
        node for node in tree.body
        if isinstance(node, ast.FunctionDef) and node.name == "counters")
    ret = next(n for n in ast.walk(counted) if isinstance(n, ast.Return))
    assert {k.value for k in ret.value.keys} == sources
