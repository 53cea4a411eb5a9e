"""blocking-under-lock — blocking operations reached while a named hot
lock is held.

A named lock is held for coordination, not for I/O: a journal
``flush()``/``fsync()``, socket I/O, a host sync (``torch.cuda.
synchronize()``, a tensor's ``.item()``, ``mesh_budget.fetch``), a
``time.sleep``, or an unbounded ``.wait()``/``.join()``/queue op
executed while holding one turns every other thread queuing on that
lock into a convoy.  The PR-18
``/metrics`` fix is the canonical shape: snapshot under the lock,
render (and write) OFF the lock.

Flow-sensitive and callgraph-projected via
:class:`~lockflow.LockFlow`:

* **intra** findings anchor at the blocking op itself, with the
  must-held named locks at that statement;
* **projected** findings anchor at the call site executed under a lock
  whose callee transitively reaches a blocking op (witness chain in
  the message) — one finding per call site, the first reachable op as
  representative.

Exemptions by construction: bounded waits/joins (timeout argument),
``Condition.wait`` on the held lock itself (wait releases it),
zero-arg ``.get()``/``.put()`` only when the receiver types to a
queue, and spawn edges (``Thread(target=...)``/``submit``) — handed-off
work does not run under the caller's locks.  The locks of
:data:`HELD_ACROSS_SYNCS` are held across device work by design, each
for the reason it gives, and are exempt here, in one place, rather than
suppressed at every sync they cover.

Blind spots (docs/STATIC_ANALYSIS.md): unnamed locks are not tracked;
blocking ops behind containers/getattr dispatch are invisible;
``print``/logging handlers are out of vocabulary."""

from __future__ import annotations

from typing import List

from cruise_control_tpu_torch.devtools.lint.findings import Finding

RULE_ID = "blocking-under-lock"

#: named locks held across blocking device work on purpose, with why
HELD_ACROSS_SYNCS = {
    "device": "utils/device.py: DEVICE_LOCK spans a whole plan search "
              "(CudaGoalOptimizer.optimize) and a whole what-if batch "
              "(whatif.engine.evaluate_batch), whose card reads wait "
              "under it: the process runs one device program at a time, "
              "and the lock keeps another thread's synchronizing call "
              "out of the step loop's CUDA-graph capture",
}


class BlockingUnderLockRule:
    id = RULE_ID
    summary = ("blocking I/O, host syncs, and unbounded waits must not "
               "run while a named hot lock is held — snapshot under "
               "the lock, block off it")
    project_rule = True

    def check_file(self, ctx) -> List[Finding]:
        return []

    def check_project(self, project) -> List[Finding]:
        lf = project.lockflow
        out: List[Finding] = []
        # intra: the op itself runs under a must-held named lock
        for f_id in sorted(lf.direct_blocking):
            for site, held in lf.direct_blocking[f_id]:
                eff = held - ({site.own} if site.own else set()) \
                    - set(HELD_ACROSS_SYNCS)
                if not eff:
                    continue
                out.append(Finding(
                    site.path, site.line, self.id,
                    f"{site.desc} while holding "
                    f"{', '.join(sorted(eff))}",
                ))
        # projected: a call under a lock reaches a blocking op
        reported = {(f.path, f.line) for f in out}
        for f_id in sorted(lf.calls_held):
            path = lf._caller_path(f_id)
            for callee, line, held in lf.calls_held[f_id]:
                sub = lf.trans_blocking.get(callee)
                if not sub:
                    continue
                site, chain = sub[min(sub)]
                eff = held - ({site.own} if site.own else set()) \
                    - set(HELD_ACROSS_SYNCS)
                if not eff or (path, line) in reported:
                    continue
                reported.add((path, line))
                hops = " ; ".join(
                    f"{p}:{ln} {note}" for p, ln, note in chain)
                via = f" via {hops}" if hops else ""
                out.append(Finding(
                    path, line, self.id,
                    f"call reaches {site.desc} "
                    f"({site.path}:{site.line}){via} while holding "
                    f"{', '.join(sorted(eff))}",
                ))
        out.sort(key=lambda f: (f.path, f.line))
        return out
