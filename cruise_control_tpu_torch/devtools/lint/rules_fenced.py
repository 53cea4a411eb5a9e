"""fenced-backend-discipline — mutating admin calls go through the fence.

ISSUE 15 made execution safe under concurrent controllers: every
mutating ``ClusterBackend`` call (``alter_partition_reassignments``,
``elect_leaders``, ``alter_replica_log_dirs``, ``cancel_reassignments``,
``set_throttles``, ``clear_throttles``, ``alter_config``) presents the
owner's controller epoch via
:class:`cruise_control_tpu_torch.executor.backend.FencedClusterBackend`, so a
zombie process is refused at the cluster seam instead of double-moving
replicas.  A mutating call issued anywhere else on a RAW backend
reference reopens the hole: the write skips the epoch check, and a
fenced-out process can still corrupt placements through that one path.

Findings: any call whose callee tail is a mutating admin method,
outside the backend implementations themselves
(``executor/backend.py`` — the wrapper and the simulated cluster;
``kafka/backend.py`` — the wire adapter; ``sim/backend.py`` — the
scripted cluster's fault machinery, which *plays* the foreign writer on
purpose), unless the receiver is one of the blessed fenced routes:

* ``self.backend`` — the executor's (and throttle helper's) handle,
  which IS the fenced wrapper at runtime;
* ``self.throttle_helper`` — the helper whose same-named lifecycle
  methods route through its fenced ``self.backend``.

Aliasing past the fence (``raw = self.backend.inner; raw.alter_...``,
``SimulatedClusterBackend.alter_...(b, ...)`` via a direct-name import,
a bare ``backend`` parameter) all land on a non-blessed receiver and
are flagged.  Evaluated over the phase-1 summaries (no re-parse).
"""

from __future__ import annotations

import pathlib
from typing import List

from cruise_control_tpu_torch.devtools.lint.findings import Finding

RULE_ID = "fenced-backend-discipline"

#: the mutating admin surface that must present the controller epoch
_MUTATING = frozenset((
    "alter_partition_reassignments",
    "elect_leaders",
    "alter_replica_log_dirs",
    "cancel_reassignments",
    "set_throttles",
    "clear_throttles",
    "alter_config",
))

#: modules allowed to touch the raw admin surface (the implementations)
_ALLOWED_SUFFIXES = (
    ("executor", "backend.py"),
    ("kafka", "backend.py"),
    ("sim", "backend.py"),
)

#: receivers that ARE the fenced route at runtime
_ALLOWED_RECEIVERS = frozenset(("self.backend", "self.throttle_helper"))


class FencedBackendDisciplineRule:
    id = RULE_ID
    summary = ("mutating ClusterBackend admin calls outside the backend "
               "implementations must go through the fenced wrapper "
               "(self.backend / self.throttle_helper) — raw-reference "
               "mutations skip the controller-epoch check")
    project_rule = True

    def check_project(self, project) -> List[Finding]:
        findings: List[Finding] = []
        for s in project.summaries:
            parts = pathlib.PurePath(s.path).parts
            if parts[-2:] in [tuple(sfx) for sfx in _ALLOWED_SUFFIXES]:
                continue
            for fn in s.functions.values():
                for call in fn.calls:
                    head, _, tail = call.callee.rpartition(".")
                    if tail not in _MUTATING or not head:
                        continue  # bare names are locals, not backends
                    if head in _ALLOWED_RECEIVERS:
                        continue
                    findings.append(Finding(
                        path=s.path, line=call.lineno, rule=self.id,
                        message=(
                            f"mutating backend call {call.callee}() in "
                            f"{fn.name or '<module>'} bypasses the "
                            "execution fence — route it through the "
                            "executor's fenced wrapper (self.backend, a "
                            "FencedClusterBackend) so the controller "
                            "epoch is presented; a raw-reference write "
                            "lets a fenced-out zombie double-move "
                            "replicas"
                        ),
                    ))
        return findings
