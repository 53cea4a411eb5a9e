"""lock-release-safety — a manual ``acquire()`` must ``release()`` on
every path out of the function, exception paths included.

``with`` statements and ``try``/``finally`` are exempt by construction
(the CFG routes both the normal and the exception path through the
release).  The rule checks BARE statement-expression acquires —
``self._lock.acquire()`` on a line of its own — because that shape
asserts unconditional ownership: any statement between it and the
``release()`` can raise, and the CFG gives every such statement an
exception edge to the function exit, so a missing ``try``/``finally``
shows up as a path that exits while holding the lock.

Assigned acquires (``ok = lock.acquire(timeout=...)``) are exempt: the
result is consulted, and the release discipline typically lives on the
conditional path (the facade's single-flight timeout acquire, the
model generation lock's ``__enter__``/``__exit__`` split) — a
flow-insensitive rule cannot follow ownership through a boolean, so we
under-approximate rather than false-positive (documented blind spot,
with the ordering rules still covering those sites via their CFGs)."""

from __future__ import annotations

from typing import List

from cruise_control_tpu_torch.devtools.lint import cfg as cfg_mod
from cruise_control_tpu_torch.devtools.lint import dataflow
from cruise_control_tpu_torch.devtools.lint.findings import Finding

RULE_ID = "lock-release-safety"


class ReleaseSafetyRule:
    id = RULE_ID
    summary = ("a bare acquire() must be released on every CFG path — "
               "exception paths included; use with/try-finally")
    project_rule = True

    def check_file(self, ctx) -> List[Finding]:
        return []

    def check_project(self, project) -> List[Finding]:
        out: List[Finding] = []
        for _mod, s in sorted(project.graph.modules.items()):
            for _key, func in sorted(s.functions.items()):
                if func.cfg is None:
                    continue
                for b, blk in enumerate(func.cfg.blocks):
                    for i, event in enumerate(blk.events):
                        if event.kind != cfg_mod.ACQUIRE \
                                or event.via != "call" \
                                or event.assigned:
                            continue
                        obj = event.obj
                        safe = dataflow.releases_on_all_paths(
                            func.cfg, b, i,
                            lambda e, o=obj: (
                                e.kind == cfg_mod.RELEASE
                                and e.obj == o),
                        )
                        if not safe:
                            out.append(Finding(
                                s.path, event.lineno, self.id,
                                f"{obj}.acquire() is not released on "
                                "every path out of this function "
                                "(exception paths count) — use `with` "
                                "or try/finally",
                            ))
        out.sort(key=lambda f: (f.path, f.line))
        return out
