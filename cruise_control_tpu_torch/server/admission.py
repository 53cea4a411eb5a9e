"""Admission control + request deadlines — the overload-safe front door
(upstream: the async servlet layer's bounded worker pools + qtp queue;
SURVEY.md §2.7, §3.5).

Two cooperating pieces:

* :class:`AdmissionController` — per-endpoint-class concurrency limits
  with ONE bounded wait queue in front of them.  A request either gets a
  slot immediately, waits in the queue (bounded both in length and in
  wait time), or is **shed** with :class:`RequestShedError` → the server
  answers ``429`` + ``Retry-After`` instead of piling threads onto the
  analyzer until everything times out.  ``drain()`` flips the controller
  into shutdown mode: queued waiters are shed instantly and the caller
  can join the in-flight count with a bounded timeout (graceful server
  drain).

* **Request deadlines** — a ``deadline-ms`` request header becomes a
  thread-local absolute deadline (:func:`deadline_scope`).  Everything
  downstream reads :func:`remaining_s` without signature plumbing: the
  facade refuses to start work for an already-dead request
  (:class:`DeadlineExceededError` → ``503``), clips the TPU engine's
  anytime budget to the remaining time, and bounds the model-generation
  semaphore wait.  :class:`UserTaskManager` re-enters the scope on its
  worker thread, so the deadline survives the async 202 handoff.

Both are deliberately stdlib-only and lock-cheap: the admission fast
path is one lock acquire + two counter updates.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, Optional

from cruise_control_tpu_torch.utils.locks import InstrumentedLock

#: admission classes — every endpoint maps onto one of these two:
#: cheap reads ("get") vs analyzer-bound work ("compute")
CLASS_GET = "get"
CLASS_COMPUTE = "compute"
CLASSES = (CLASS_GET, CLASS_COMPUTE)


class RequestShedError(RuntimeError):
    """The request was load-shed (queue full / queue timeout / draining).
    Carries the Retry-After guidance the HTTP layer must emit."""

    def __init__(self, message: str, retry_after_s: int = 2):
        super().__init__(message)
        self.retry_after_s = int(retry_after_s)


class DeadlineExceededError(RuntimeError):
    """The request's deadline expired before (or while) serving it."""


# ---- request deadline (thread-local) --------------------------------------------
_LOCAL = threading.local()


@contextlib.contextmanager
def deadline_scope(deadline_monotonic: Optional[float]):
    """Events on this thread inside the scope see ``deadline_monotonic``
    (absolute ``time.monotonic()`` seconds; None = no deadline).  Nested
    scopes keep the TIGHTER deadline."""
    prev = getattr(_LOCAL, "deadline", None)
    if deadline_monotonic is None:
        eff = prev
    elif prev is None:
        eff = deadline_monotonic
    else:
        eff = min(prev, deadline_monotonic)
    _LOCAL.deadline = eff
    try:
        yield
    finally:
        _LOCAL.deadline = prev


def current_deadline() -> Optional[float]:
    """The absolute monotonic deadline bound to this thread, or None."""
    return getattr(_LOCAL, "deadline", None)


def remaining_s() -> Optional[float]:
    """Seconds until this thread's deadline (may be <= 0); None = none."""
    d = current_deadline()
    return None if d is None else d - time.monotonic()


def expired() -> bool:
    r = remaining_s()
    return r is not None and r <= 0


def check_deadline(what: str = "request") -> None:
    """Raise DeadlineExceededError when this thread's deadline passed."""
    r = remaining_s()
    if r is not None and r <= 0:
        raise DeadlineExceededError(
            f"{what} abandoned: deadline exceeded by {-r:.3f}s"
        )


# ---- admission ------------------------------------------------------------------
class AdmissionController:
    """Per-class concurrency limits + one bounded admission queue.

    ``admit(cls)`` returns a context manager holding the slot.  When the
    class is at its limit the caller waits in the shared queue — but only
    if the queue has room and only up to ``queue_timeout_s`` (clipped by
    the caller's request deadline): past either bound the request is shed
    with :class:`RequestShedError`, which is the load-shedding contract
    (upstream: jetty's bounded QTP queue + 503s).
    """

    def __init__(
        self,
        max_concurrent: Optional[Dict[str, int]] = None,
        queue_size: int = 16,
        queue_timeout_s: float = 2.0,
        retry_after_s: int = 2,
        on_shed: Optional[Callable[[str, str], None]] = None,
        max_inflight: int = 0,
    ):
        self.max_concurrent = {
            CLASS_GET: 16, CLASS_COMPUTE: 4, **(max_concurrent or {})
        }
        self.queue_size = max(0, int(queue_size))
        self.queue_timeout_s = max(0.0, float(queue_timeout_s))
        self.retry_after_s = int(retry_after_s)
        #: global in-flight ceiling (jetty's bounded-pool equivalent): a
        #: request storm must become explicit sheds at the door, not
        #: invisible scheduler/GIL queueing smeared across half-parsed
        #: requests.  0 = auto: every class slot + the queue + headroom.
        self.max_inflight = int(max_inflight) or (
            sum(self.max_concurrent.values()) + self.queue_size + 4
        )
        #: observability hook: (admission class, reason) per shed
        self.on_shed = on_shed
        # the queue lock is instrumented (ISSUE 18): every admit/track/
        # drain serializes here, so its wait series IS the front door's
        # contention telemetry.  InstrumentedLock implements _is_owned,
        # so Condition never probe-acquires it.
        self._cond = threading.Condition(InstrumentedLock("admission.queue"))
        self._active: Dict[str, int] = {c: 0 for c in CLASSES}
        self._queued = 0
        self._inflight = 0  # every tracked request, queued or running
        self._draining = False
        self.shed_total = 0
        self.admitted_total = 0

    # ---- introspection (gauges / GET /state) ------------------------------------
    def active(self, cls: str) -> int:
        with self._cond:
            return self._active.get(cls, 0)

    def queued(self) -> int:
        with self._cond:
            return self._queued

    def inflight(self) -> int:
        with self._cond:
            return self._inflight

    @property
    def draining(self) -> bool:
        return self._draining

    def state_summary(self) -> dict:
        with self._cond:
            return {
                "active": dict(self._active),
                "queued": self._queued,
                "queueSize": self.queue_size,
                "limits": dict(self.max_concurrent),
                "shedTotal": self.shed_total,
                "admittedTotal": self.admitted_total,
                "draining": self._draining,
            }

    # ---- the admission decision --------------------------------------------------
    def _shed(self, cls: str, reason: str) -> RequestShedError:
        self.shed_total += 1
        if self.on_shed is not None:
            try:
                self.on_shed(cls, reason)
            except Exception:  # pragma: no cover - observability must not shed
                pass
        return RequestShedError(
            f"server overloaded ({reason}); retry after "
            f"{self.retry_after_s}s", retry_after_s=self.retry_after_s,
        )

    def check_global(self) -> None:
        """Shed when total in-flight requests exceed the global ceiling
        (called at dispatch entry for every sheddable endpoint — /health
        and the UI stay exempt)."""
        with self._cond:
            if self._draining:
                raise self._shed("any", "draining")
            if self._inflight > self.max_inflight:
                raise self._shed("any", "server overloaded")

    @contextlib.contextmanager
    def admit(self, cls: str):
        """Hold a concurrency slot of ``cls`` for the with-block, queueing
        (bounded) when the class is saturated.  Raises RequestShedError
        instead of entering the block when the request must be shed."""
        limit = self.max_concurrent.get(cls, 0)
        with self._cond:
            if self._draining:
                raise self._shed(cls, "draining")
            if self._active[cls] >= limit:
                if self._queued >= self.queue_size:
                    raise self._shed(cls, "queue full")
                # bounded wait: the queue timeout, clipped by the caller's
                # own deadline — waiting past either only burns a thread
                timeout = self.queue_timeout_s
                rem = remaining_s()
                if rem is not None:
                    timeout = min(timeout, max(0.0, rem))
                deadline = time.monotonic() + timeout
                self._queued += 1
                try:
                    while self._active[cls] >= limit:
                        if self._draining:
                            raise self._shed(cls, "draining")
                        left = deadline - time.monotonic()
                        if left <= 0:
                            raise self._shed(cls, "queue timeout")
                        self._cond.wait(left)
                finally:
                    self._queued -= 1
            self._active[cls] += 1
            self.admitted_total += 1
        try:
            yield
        finally:
            with self._cond:
                self._active[cls] -= 1
                self._cond.notify_all()

    # ---- in-flight tracking (graceful drain) ------------------------------------
    @contextlib.contextmanager
    def track(self):
        """Count a request as in-flight for drain accounting (wraps the
        WHOLE dispatch, admission-exempt endpoints included)."""
        with self._cond:
            self._inflight += 1
        try:
            yield
        finally:
            with self._cond:
                self._inflight -= 1
                self._cond.notify_all()

    def drain(self, timeout_s: float = 5.0) -> bool:
        """Enter drain mode: queued waiters shed immediately, new admits
        shed, then wait (bounded) for in-flight requests to finish.
        Returns True when the server drained clean within the timeout."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()
        deadline = time.monotonic() + max(0.0, timeout_s)
        with self._cond:
            while self._inflight > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cond.wait(left)
        return True
