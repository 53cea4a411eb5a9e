"""The step loop's carry on the device: one small int32 vector.

The reference runs up to T steps inside one ``lax.while_loop``
(``cruise_control_tpu/analyzer/tpu_optimizer.py:1409 run_capped``) whose
carry holds the done flag, the step index, the running commit count and
the repool bookkeeping; ``cond_fn`` (:1400) reads them on the device.  The
port keeps the same carry in :attr:`StepState.state` so that a captured
chunk of steps never reads the host: the commit (kernel K8) writes the
per-step counts and advances the carry, the repool (K10, K11) acts only
when the carry asks for it, and the host reads the vector once a chunk.
``csrc/step_common.cuh`` (namespace ``cc_state``) holds the same indices.
"""

from __future__ import annotations

import dataclasses

import torch

# indices into the state vector
DONE = 0          # a step on fresh pools committed nothing (converged)
STEP = 1          # steps run so far (the reference's ``t``)
COUNT = 2         # actions committed so far (the output's fill)
SINCE_POOL = 3    # steps since the last repool
PT_VALID = 4      # the stored pool row tables are valid
N_INCR = 5        # repools that refreshed only the touched rows
ACTIVE = 6        # the next step runs: !done && t < T && count <= limit
NEED_POOL = 7     # the next step repools: since_pool >= repool_steps
REPOOL = 8        # this step repools (set by K10, read by K11)
FULL = 9          # this step's repool rebuilds every row
N_REPOOL = 10     # repools run so far
NSTATE = 16


@dataclasses.dataclass
class StepState:
    """The device carry of one scan call and the per-step meta.

    ``counts`` is the reference's packed meta (``:1368-1378``): row 0 the
    commits of each step, rows 1-3 the improving rows, the cohort's and
    the auction's admissions.  ``steps``, ``repool`` and ``slot_limit``
    (the slot budget less one step's commits) are the loop's constants."""

    state: torch.Tensor       # int32 [NSTATE]
    counts: torch.Tensor      # int32 [4, steps]
    steps: int
    repool: int
    slot_limit: int

    @classmethod
    def empty(cls, steps: int, repool: int, slot_limit: int, device):
        return cls(torch.zeros(NSTATE, dtype=torch.int32, device=device),
                   torch.zeros((4, steps), dtype=torch.int32, device=device),
                   steps, repool, slot_limit)

    def initial(self, pt_valid: bool) -> torch.Tensor:
        """The carry a call starts from (a CPU tensor): the first step
        repools; the stored row tables are valid as the caller says."""
        v = torch.zeros(NSTATE, dtype=torch.int32)
        v[SINCE_POOL] = self.repool
        v[PT_VALID] = int(pt_valid)
        v[ACTIVE] = int(self.steps > 0 and self.slot_limit >= 0)
        v[NEED_POOL] = 1
        return v


def advance(st: StepState, c_step: int, improving: int, cohort: int,
            auction: int) -> None:
    """The carry update after a step that committed ``c_step`` actions:
    the reference's :1368-1378 meta and :1394-1395 done / since_pool, then
    the next step's ``cond_fn`` (:1400) and repool predicate.  The plain
    twin of K8's one-thread tail."""
    s = st.state
    t, since = int(s[STEP]), int(s[SINCE_POOL])
    st.counts[:, t] = torch.tensor([c_step, improving, cohort, auction],
                                   dtype=torch.int32)
    done = int(s[DONE]) | int(c_step == 0 and since == 0)
    since = st.repool if c_step == 0 else since + 1
    count = int(s[COUNT]) + c_step
    t += 1
    for i, v in ((DONE, done), (SINCE_POOL, since), (COUNT, count),
                 (STEP, t),
                 (ACTIVE, int(not done and t < st.steps
                              and count <= st.slot_limit)),
                 (NEED_POOL, int(since >= st.repool))):
        s[i] = v
