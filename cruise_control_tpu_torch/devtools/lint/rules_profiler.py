"""profiler-discipline — ``torch.profiler`` has ONE entry point.

The kernel observatory (``telemetry/kernel_budget.py``) owns the
process's one ``torch.profiler`` session: ``profiler_session`` opens it
(a nested one raises), the ``CaptureManager`` claims it for armed
captures (one at a time, parsed off the request thread, journalled), and
``tools/profile_search.py`` goes through it.  CUPTI serves one session a
process: a second profiler started anywhere else fails whatever request
carries it or silently steals the capture's kernel records, and the
traced window stops meaning "N scan calls".

Findings: any call site whose callee resolves to a profiler session API
outside ``telemetry/kernel_budget.py`` —

* ``torch.profiler.profile(...)`` and ``torch.autograd.profiler.profile``
  / ``emit_nvtx``, through ``torch`` or any alias of it;
* ``torch.cuda.profiler.start()`` / ``stop()``;
* module aliases (``import torch.profiler as prof; prof.profile(...)``,
  ``from torch import profiler; profiler.profile(...)``) and direct-name
  imports (``from torch.profiler import profile; profile(...)``).

Non-session helpers (``record_function``, ``schedule``) are out of scope:
only a session can collide.  Evaluated over the phase-1 summaries (no
re-parse).
"""

from __future__ import annotations

import pathlib
from typing import Dict, List

from cruise_control_tpu_torch.devtools.lint.findings import Finding

RULE_ID = "profiler-discipline"

#: profiler module (absolute dotted) → its session functions
_SESSION_APIS: Dict[str, frozenset] = {
    "torch.profiler": frozenset(("profile",)),
    "torch.autograd.profiler": frozenset(("profile", "emit_nvtx")),
    "torch.cuda.profiler": frozenset(("start", "stop", "profile")),
}

#: the one module allowed to open a profiler session
_ALLOWED_SUFFIX = ("telemetry", "kernel_budget.py")


def _expand(callee: str, aliases: Dict[str, str]) -> str:
    """``callee`` as written → its absolute dotted name when its head is
    an import alias (``prof.profile`` → ``torch.profiler.profile``)."""
    head, dot, rest = callee.partition(".")
    target = aliases.get(head)
    if target is None:
        return callee
    return f"{target}{dot}{rest}" if rest else target


class ProfilerDisciplineRule:
    id = RULE_ID
    summary = ("torch.profiler / autograd / cuda profiler sessions "
               "outside telemetry/kernel_budget.py (the kernel "
               "observatory's profiler_session is the single entry "
               "point)")
    project_rule = True

    def check_project(self, project) -> List[Finding]:
        findings: List[Finding] = []
        for s in project.summaries:
            parts = pathlib.PurePath(s.path).parts
            if parts[-2:] == _ALLOWED_SUFFIX:
                continue
            aliases: Dict[str, str] = {}
            for level, from_mod, name, alias in s.imports:
                if level:
                    continue
                aliases[alias] = (name if from_mod is None
                                  else f"{from_mod}.{name}")
            for fn in s.functions.values():
                for call in fn.calls:
                    full = _expand(call.callee, aliases)
                    mod, _, tail = full.rpartition(".")
                    if tail not in _SESSION_APIS.get(mod, ()):
                        continue
                    findings.append(Finding(
                        path=s.path, line=call.lineno, rule=self.id,
                        message=(
                            f"direct profiler-session call "
                            f"{call.callee}() in {fn.name or '<module>'} "
                            "— route captures through telemetry/"
                            "kernel_budget.py (CaptureManager.arm / "
                            "profiler_session), the single "
                            "torch.profiler entry point"
                        ),
                    ))
        return findings
