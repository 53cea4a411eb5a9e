"""lock-instrumentation-discipline — hot serving modules name their locks.

ISSUE 18 gave the host observatory per-named-lock contention telemetry:
``utils/locks.InstrumentedLock`` measures wait-vs-hold into the
``cc_lock_wait_ms{lock=}`` / ``cc_lock_hold_ms{lock=}`` families, and the
SLO maintenance tick journals ``contention.hot_lock`` when a lock stays
hot.  That telemetry is only as complete as its adoption: a raw
``threading.Lock()`` on a serving-path coordination point is a stall the
sampling profiler can see ("thread blocked in acquire") but nobody can
attribute — the exact regression the lock observatory exists to name.

Findings: ``threading.Lock(...)`` / ``threading.RLock(...)`` constructor
calls (dotted, module-aliased, or ``from threading import Lock`` direct
names) in the HOT serving modules — everything under ``server/``,
``analyzer/`` and ``executor/``, plus ``facade.py``.  Those modules sit
on the request/heal critical path; their locks must be
``InstrumentedLock("<name>")`` (or ``InstrumentedSemaphore``) so waits
land in the contention registry.  Cold modules (config, monitor
plumbing, devtools, telemetry internals — including the registry's own
per-metric sample locks, whose nanosecond holds would drown in wrapper
overhead) stay free to use the stdlib directly.

Evaluated over the phase-1 summaries (no re-parse).
"""

from __future__ import annotations

import pathlib
from typing import List, Set

from cruise_control_tpu_torch.devtools.lint.findings import Finding

RULE_ID = "lock-instrumentation-discipline"

#: the stdlib constructors that must not appear raw in hot modules
#: (Condition is exempt: Condition(InstrumentedLock(...)) is the blessed
#: idiom and the wrapped lock is what the ctor-arg carries)
_RAW_CTORS = frozenset(("Lock", "RLock"))

#: directories whose modules sit on the serving/heal critical path
_HOT_DIRS = frozenset(("server", "analyzer", "executor"))
#: single hot modules outside those directories
_HOT_FILES = frozenset(("facade.py",))


def _is_hot(path: str) -> bool:
    parts = pathlib.PurePath(path).parts
    try:
        rel = parts[parts.index("cruise_control_tpu") + 1:]
    except ValueError:
        # relocated/fixture trees (the lint test harness materializes
        # packages as pkg/…): classify by the parent dir + filename
        rel = parts[-2:]
    if not rel:
        return False
    if len(rel) == 1:
        return rel[0] in _HOT_FILES
    return rel[0] in _HOT_DIRS or rel[-1] in _HOT_FILES


class LockInstrumentationRule:
    id = RULE_ID
    summary = ("raw threading.Lock()/RLock() in hot serving modules "
               "(server/, analyzer/, executor/, facade.py) — use "
               "utils/locks.InstrumentedLock(\"<name>\") so waits land "
               "in the contention telemetry")
    project_rule = True

    def check_project(self, project) -> List[Finding]:
        findings: List[Finding] = []
        for s in project.summaries:
            if not _is_hot(s.path):
                continue
            threading_modules: Set[str] = set()
            direct_names: Set[str] = set()
            for _level, from_mod, name, alias in s.imports:
                if from_mod is None and name == "threading":
                    threading_modules.add(alias)
                elif from_mod == "threading" and name in _RAW_CTORS:
                    direct_names.add(alias)
            if not threading_modules and not direct_names:
                continue
            for fn in s.functions.values():
                for call in fn.calls:
                    callee = call.callee
                    head, _, tail = callee.rpartition(".")
                    hit = (
                        callee in direct_names
                        or (tail in _RAW_CTORS
                            and head in threading_modules)
                    )
                    if hit:
                        findings.append(Finding(
                            path=s.path, line=call.lineno, rule=self.id,
                            message=(
                                f"raw {callee}() in "
                                f"{fn.name or '<module>'} — this module "
                                "is on the serving critical path; use "
                                "utils/locks.InstrumentedLock(\"<name>\")"
                                " so its waits are attributable in "
                                "cc_lock_wait_ms and the contention."
                                "hot_lock journal"
                            ),
                        ))
        return findings
