"""deadline-propagation — no unbounded blocking on request-serving paths.

PR 8's overload work hand-audited every wait on the HTTP path and
clipped it by the request deadline; this rule makes that audit a
standing check.  From every HTTP handler root (``do_GET``/``do_POST``/
… methods; work handed to ``UserTaskManager.submit`` or a thread pool
follows the call-graph spawn edges), the rule walks the project call
graph and flags blocking primitives that can park a request thread
forever:

* ``<event/cond>.wait()`` with no timeout argument;
* ``<lock/sem>.acquire()`` blocking with no timeout (a nonblocking
  ``acquire(False)`` is fine);
* ``<queue>.get(...)`` / ``<queue>.put(...)`` with neither a timeout
  nor ``block=False`` (``get_nowait`` is fine);
* ``<thread>.join()`` with no timeout;
* ``<sock>.recv/accept/connect`` on a socket the function never
  ``settimeout``\\ s.

A site is exempt when it is lexically inside a
``with deadline_scope(...):`` block whose machinery the call itself
consults (the repo idiom is a timeout computed from
``admission.remaining_s()`` — which already satisfies the timeout-
argument form).  ``time.sleep`` carries its bound as its argument and
is owned by ``retry-discipline``; it is deliberately not flagged here.

Receiver classification is name- and constructor-based (``_cond``,
``stop_event``, ``x = threading.Event()`` …); unknown receivers stay
silent — the rule under-approximates rather than guess
(docs/STATIC_ANALYSIS.md lists the blind spots)."""

from __future__ import annotations

import re
from typing import List, Optional, Set

from cruise_control_tpu_torch.devtools.lint.callgraph import render_path
from cruise_control_tpu_torch.devtools.lint.findings import Finding
from cruise_control_tpu_torch.devtools.lint.graph import CallSite, FuncSummary

RULE_ID = "deadline-propagation"

_WAITISH = re.compile(
    r"(event|cond|cv|done|ready|stop|wake|flag|barrier|notify)[a-z_]*$",
    re.IGNORECASE)
_LOCKISH = re.compile(r"(lock|sem|semaphore|cond|mutex)[a-z_]*$",
                      re.IGNORECASE)
_QUEUEISH = re.compile(r"(queue|_q)$", re.IGNORECASE)
_THREADISH = re.compile(r"(thread|worker|proc|_t)$", re.IGNORECASE)
_SOCKISH = re.compile(r"(sock|socket)$", re.IGNORECASE)

_WAIT_CTORS = {"Event", "Condition", "Barrier"}
_LOCK_CTORS = {"Lock", "RLock", "Semaphore", "BoundedSemaphore"}
_QUEUE_CTORS = {"Queue", "SimpleQueue", "LifoQueue", "PriorityQueue"}
_SOCK_OPS = {"recv", "recv_into", "recvfrom", "accept", "connect",
             "makefile"}

_HANDLER_RE = re.compile(r"\.do_[A-Z]+$")


def _recv_tail(callee: str) -> str:
    """last receiver component: 'self._cond.wait' → '_cond'."""
    parts = callee.split(".")
    return parts[-2] if len(parts) >= 2 else ""


def _ctor_tail(fn: FuncSummary, recv_expr: str) -> Optional[str]:
    """constructor class tail for a local receiver, if recorded."""
    ctor = fn.var_types.get(recv_expr)
    return ctor.rsplit(".", 1)[-1] if ctor else None


def _has_timeout_kw(site: CallSite) -> bool:
    return "timeout" in site.kwargs and "timeout" not in site.none_kwargs


def _in_deadline_scope(site: CallSite) -> bool:
    return any(w.rsplit(".", 1)[-1] == "deadline_scope"
               for w in site.with_ctxs)


def classify_blocking(fn: FuncSummary, site: CallSite) -> Optional[str]:
    """A human-readable description when ``site`` is an unbounded
    blocking primitive, else None."""
    callee = site.callee
    tail = callee.rsplit(".", 1)[-1]
    recv_expr = callee.rsplit(".", 1)[0] if "." in callee else ""
    recv = _recv_tail(callee)
    ctor = _ctor_tail(fn, recv_expr)
    if tail == "wait" and (_WAITISH.search(recv) or ctor in _WAIT_CTORS
                           or ctor == "Condition"):
        if site.nargs >= 1 or _has_timeout_kw(site):
            return None
        return f"{callee}() with no timeout"
    if tail == "acquire" and (_LOCKISH.search(recv)
                              or ctor in _LOCK_CTORS):
        if site.nargs >= 2 or _has_timeout_kw(site) \
                or site.first_arg_false:
            return None
        return f"{callee}() blocking with no timeout"
    if tail in ("get", "put") and (_QUEUEISH.search(recv)
                                   or ctor in _QUEUE_CTORS):
        if _has_timeout_kw(site) or site.first_arg_false \
                or "block" in site.kwargs:
            return None
        return f"{callee}() with no timeout"
    if tail == "join" and (_THREADISH.search(recv) or ctor == "Thread"):
        if site.nargs >= 1 or _has_timeout_kw(site):
            return None
        return f"{callee}() with no timeout"
    if tail in _SOCK_OPS and _SOCKISH.search(recv):
        if any(c.callee == f"{recv_expr}.settimeout" for c in fn.calls):
            return None
        return f"{callee} on a socket with no settimeout"
    return None


class DeadlinePropagationRule:
    id = RULE_ID
    summary = ("blocking primitives reachable from HTTP handlers / "
               "submitted tasks must carry a timeout (or sit inside "
               "deadline_scope machinery)")
    project_rule = True

    def check_file(self, ctx) -> List[Finding]:
        return []

    def check_project(self, project) -> List[Finding]:
        graph = project.graph
        cg = project.callgraph
        roots: Set[str] = {
            fid for fid, fn in cg.funcs.items()
            if _HANDLER_RE.search(fid) and fn.cls is not None
        }
        out: List[Finding] = []
        reach = cg.reachable_from(roots)
        seen = set()
        for fid, path in sorted(reach.items()):
            fn = cg.funcs[fid]
            mod = fid.split(":", 1)[0]
            s = graph.modules.get(mod)
            if s is None:
                continue
            for site in fn.calls:
                if _in_deadline_scope(site):
                    continue
                desc = classify_blocking(fn, site)
                if desc is None:
                    continue
                key = (s.path, site.lineno)
                if key in seen:
                    continue
                seen.add(key)
                out.append(Finding(
                    s.path, site.lineno, self.id,
                    f"{desc} on a request-serving path "
                    f"({render_path(path)}) — a dead client parks this "
                    "thread forever; pass a timeout (clip it with "
                    "admission.remaining_s()) and handle expiry",
                ))
        out.sort(key=lambda f: (f.path, f.line))
        return out
