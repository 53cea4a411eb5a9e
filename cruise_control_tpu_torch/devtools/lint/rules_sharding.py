"""sharding-discipline — tensor factories in the device modules state
their placement.

The reference's rule keeps every upload in its mesh-enabled modules
explicit about its sharding: an unplaced ``device_put`` lands fully
replicated.  On one card the same bug class is a tensor factory with no
``device=``: ``torch.zeros(n)`` in a device module allocates on the
host, silently.  Then it either costs a host→device copy at its first
use beside a CUDA tensor, or raises a device mismatch inside a kernel
wrapper — on the card only, since the CPU tests put everything on the
host anyway.

Findings, inside the device modules (``ops/`` wholesale, plus
``analyzer/cuda_optimizer.py``, ``analyzer/step_graph.py``, the kernel
wrapper modules ``analyzer/*_kernel.py`` / ``analyzer/*_kernels.py`` and
``whatif/verdict_kernels.py``): a call of ``torch.empty``, ``zeros``,
``ones``, ``full``, ``arange``, ``tensor`` or ``as_tensor`` — through
``torch``, an alias of it, or a direct-name import — with no
``device=`` keyword (a literal ``device=None`` counts as none).  The
``*_like`` forms inherit their argument's device and are exempt.

Fix: pass ``device=`` (the model's tensors carry it), or suppress with a
reviewed ``# cclint: disable=sharding-discipline -- reason`` where a
host tensor is the point.  A11 (several cards) extends the rule to
process groups.  Evaluated over the phase-1 summaries (no re-parse).
"""

from __future__ import annotations

import pathlib
from typing import List, Set

from cruise_control_tpu_torch.devtools.lint.findings import Finding

RULE_ID = "sharding-discipline"

#: the factories that allocate a new tensor wherever they are told
FACTORIES = frozenset(("empty", "zeros", "ones", "full", "arange",
                       "tensor", "as_tensor"))

#: modules whose tensors live on the card: a factory here picks a device
_DEVICE_DIRS = ("ops",)
_DEVICE_FILES = (
    ("analyzer", "cuda_optimizer.py"),
    ("analyzer", "step_graph.py"),
    ("whatif", "verdict_kernels.py"),
)


def _device_scoped(path: str) -> bool:
    parts = pathlib.PurePath(path).parts
    if len(parts) >= 2 and parts[-2] in _DEVICE_DIRS:
        return True
    if len(parts) >= 2 and parts[-2] == "analyzer" \
            and parts[-1].endswith(("_kernel.py", "_kernels.py")):
        return True
    return parts[-2:] in _DEVICE_FILES


class ShardingDisciplineRule:
    id = RULE_ID
    summary = ("tensor factory (torch.empty/zeros/ones/full/arange/"
               "tensor/as_tensor) without device= in a device module "
               "(ops/, analyzer/cuda_optimizer.py, analyzer/step_graph."
               "py, the kernel wrapper modules) — a silent host "
               "allocation that costs a copy or a device mismatch on the "
               "card; pass device= or add a reviewed disable comment")
    project_rule = True

    def check_project(self, project) -> List[Finding]:
        findings: List[Finding] = []
        for s in project.summaries:
            if not _device_scoped(s.path):
                continue
            torch_modules: Set[str] = {"torch"}
            direct: Set[str] = set()
            for _level, from_mod, name, alias in s.imports:
                if from_mod is None and name == "torch":
                    torch_modules.add(alias)
                elif from_mod == "torch" and name in FACTORIES:
                    direct.add(alias)
            for fn in s.functions.values():
                for call in fn.calls:
                    head, _, tail = call.callee.rpartition(".")
                    if not ((tail in FACTORIES and head in torch_modules)
                            or call.callee in direct):
                        continue
                    placed = "device" in (set(call.kwargs)
                                          - set(call.none_kwargs))
                    if placed:
                        continue
                    findings.append(Finding(
                        path=s.path, line=call.lineno, rule=self.id,
                        message=(
                            f"{call.callee}() in "
                            f"{fn.name or '<module>'} allocates without "
                            "a device — in a device module that is a "
                            "silent host tensor (a copy at first use, or "
                            "a device mismatch on the card); pass "
                            "device= or add a reviewed "
                            "# cclint: disable=sharding-discipline"
                        ),
                    ))
        return findings
