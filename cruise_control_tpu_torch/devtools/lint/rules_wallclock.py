"""wall-clock-discipline — virtual-clock paths must not read the host
clock.

The fault-injection simulator, the detectors, and the SLO engine all run
on an *injected* clock: the scenario driver's virtual ``now_ms``, the
detector manager's per-cycle ``now_ms``, the SLO engine's ``clock``
callable.  A stray ``time.time()`` / ``time.monotonic()`` / argless
``datetime.now()`` in one of those paths silently mixes host time into
virtual-time math — the exact drift class ISSUE 12's soak surfaced in
ts-windowed SLO evaluation (a "last 30 minutes" window over a virtual
day read the host clock and evicted everything).

Two scopes, evaluated over the phase-1 summaries (no re-parse):

* **clock-param scope** (anywhere in the tree): a wall-clock call inside
  a function that already RECEIVES an injected clock — a parameter named
  ``now`` / ``now_ms`` / ``now_s`` / ``time_ms`` / ``clock`` /
  ``time_fn`` / ``wall_clock`` (including enclosing functions) — is
  always wrong: the injected time base exists, use it.
* **module scope**: every function in ``sim/`` modules and in ``slo.py``
  runs under the scenario/SLO clock, clock parameter or not.

Exemptions:

* the documented fallback idiom — a wall-clock call under an
  ``X is None`` guard (``now = time.time() if now is None else now``,
  or the equivalent ``if``): wall time as the *default* when no clock
  was injected is the correct production shape;
* ``simulator.py``'s real-server hold loops (``_slow_client_probe``,
  ``_apply_http_request``): they time REAL sockets against a REAL HTTP
  server, deliberately on the host clock (their measurements are
  volatile-keyed out of journal fingerprints);
* references that never call (``clock or time.time``,
  ``time_fn=time.time`` defaults) are structurally out of scope — only
  Call nodes are extracted.

The production boundary that CONVERTS wall time into the injected base
(``AnomalyDetectorManager.start``'s ``run_detection_cycle(int(time.time()
* 1000))``) lives outside both scopes by design: converting at the edge
is the pattern, reading inside is the bug.
"""

from __future__ import annotations

import pathlib
from typing import List

from cruise_control_tpu_torch.devtools.lint.findings import Finding

RULE_ID = "wall-clock-discipline"

#: simulator.py functions documented as wall-clock-by-design (real-server
#: hold loops; see the module docstring)
_SIMULATOR_ALLOWLIST = frozenset((
    "_slow_client_probe", "_apply_http_request",
))


class WallClockDisciplineRule:
    id = RULE_ID
    summary = ("virtual-clock paths (sim/, slo.py, and any function "
               "taking an injected clock/now parameter) must not read "
               "time.time()/time.monotonic()/datetime.now()")
    project_rule = True

    def check_project(self, project) -> List[Finding]:
        findings: List[Finding] = []
        for s in project.summaries:
            parts = pathlib.PurePath(s.path).parts
            filename = parts[-1] if parts else ""
            in_sim = "sim" in parts[:-1]
            in_scope_module = in_sim or filename == "slo.py"
            for site in s.wallclock_sites:
                if not (site.clock_param or in_scope_module):
                    continue
                if site.guarded:
                    continue  # the `X if X is None else X` fallback idiom
                if (in_sim and filename == "simulator.py"
                        and site.func in _SIMULATOR_ALLOWLIST):
                    continue
                why = ("an injected clock/now parameter is in scope"
                       if site.clock_param else
                       "this module runs on the scenario/SLO clock")
                findings.append(Finding(
                    s.path, site.lineno, self.id,
                    f"wall-clock read `{site.call}()` in "
                    f"`{site.func or '<module>'}` — {why}; use the "
                    "injected clock (wall time is only legal as the "
                    "`x if x is None else x` fallback)",
                ))
        return findings
