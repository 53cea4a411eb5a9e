"""K15's plain twin (``_corrected_accept``, the corrected cohort) against
the reference's ``_corrected_accept`` (tpu_optimizer.py:2522) on skewed
cohorts, the cases ``chip_smoke.py`` holds the kernel to on the card:
every row on one destination, every row on one source, a row count that
is not a power of two, and a single row.

The rows are the compacted rows of the port's first step on the seeded
fixture of ``tests/test_torch_corrected_kernel.py`` (mean loads with no
stacking guard, percentile loads with ``cohort_stack_tol`` 0.25), their
ids then forced or their count cut.  The reference sums each row's
segment prefix in f32 in XLA's order, the port exactly, so as there every
compared quantity is recomputed in f64 and must sit clear of its boundary
by MARGIN before the accept masks are held equal."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from cruise_control_tpu.analyzer import tpu_optimizer as T
from cruise_control_tpu_torch.analyzer import corrected_kernel as K15
from cruise_control_tpu_torch.analyzer import cuda_optimizer as C
from test_torch_corrected_kernel import MARGIN, f64_margins, first_step_rows
from test_torch_step_kernels import carried


@dataclasses.dataclass
class Rows:
    cand_p: object
    cand_s: object
    cand_src: object
    d0: object
    move_vec: object
    qual: object
    cand_score: object


def _mode(x):
    v, n = np.unique(x.numpy(), return_counts=True)
    return int(v[np.argmax(n)])


def _skewed(c, case):
    """The first step's rows ``c`` made into ``case``."""
    r = Rows(c.cand_p, c.cand_s, c.cand_src, c.d0, c.move_vec, c.qual,
             c.cand_score)
    if case == "one_dst":
        r.d0 = r.d0.clone().fill_(_mode(r.d0))
    elif case == "one_src":
        r.cand_src = r.cand_src.clone().fill_(_mode(r.cand_src))
    else:
        n = 1 if case == "c1" else r.d0.shape[0] * 3 // 4 + 1
        for f in dataclasses.fields(r):
            setattr(r, f.name, getattr(r, f.name)[:n])
    return r


@pytest.mark.parametrize("case", ["one_dst", "one_src", "c_odd", "c1"])
@pytest.mark.parametrize("cload, stack_tol", [(False, 1.0), (True, 0.25)],
                         ids=["mean", "percentile_guard"])
def test_corrected_accept_on_skewed_cohorts(case, cload, stack_tol):
    (m, ca_r, _, _), (pm, ca, _) = carried(4, cload)
    cfg = C.CudaSearchConfig(cohort_mode="corrected",
                             cohort_stack_tol=stack_tol)
    c = _skewed(first_step_rows(pm, ca, cfg), case)
    n = c.d0.shape[0]
    if case == "c_odd":
        assert n & (n - 1) != 0
    can = {k: v.numpy() for k, v in ca.items()}
    stacked, least = f64_margins(pm, cfg, can, c)
    assert least > MARGIN, ("a compared quantity sits within MARGIN of its "
                            "boundary", least)
    got = K15._corrected_accept(
        pm, cfg, ca, c.cand_p, c.cand_s, c.cand_src, c.d0, c.move_vec,
        c.qual, cfg.improvement_tol, snap_score=c.cand_score[:, 0])
    j = lambda x: jnp.asarray(x.numpy())  # noqa: E731
    want = np.asarray(T._corrected_accept(
        m, T.TpuSearchConfig(cohort_mode="corrected",
                             cohort_stack_tol=stack_tol), ca_r,
        j(c.cand_p), j(c.cand_s), j(c.cand_src), j(c.d0), j(c.move_vec),
        j(c.qual), cfg.improvement_tol, snap_score=j(c.cand_score[:, 0])))
    np.testing.assert_array_equal(got.numpy(), want)
    if case in ("one_dst", "one_src"):
        # one broker stacks every qualified row on one side
        assert stacked.sum() >= 3 and want.any()
