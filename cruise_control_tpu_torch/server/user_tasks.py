"""UserTaskManager — the async operation protocol (upstream
``servlet/UserTaskManager.java`` + ``OperationFuture``; SURVEY.md §2.7).

POST on an async endpoint creates a task and immediately returns ``202`` with
a ``User-Task-ID`` header; the client polls (same endpoint or
``/user_tasks``) with that id until the result is ready.  Completed tasks are
cached with a TTL so late polls still see the result.
"""

from __future__ import annotations

import threading
import time
import uuid
from concurrent.futures import CancelledError, Future, ThreadPoolExecutor
from typing import Callable, Dict, List, Optional

from cruise_control_tpu_torch.server import admission
from cruise_control_tpu_torch.server.progress import OperationProgress
from cruise_control_tpu_torch.telemetry import events, trace
from cruise_control_tpu_torch.utils.locks import InstrumentedLock


class UserTaskState:
    ACTIVE = "Active"
    COMPLETED = "Completed"
    COMPLETED_WITH_ERROR = "CompletedWithError"


class UserTask:
    def __init__(self, task_id: str, endpoint: str):
        self.task_id = task_id
        self.endpoint = endpoint
        self.future: Future = Future()
        self.progress = OperationProgress(endpoint)
        self.created_s = time.time()
        self.completed_s: Optional[float] = None
        #: the pool's wrapper future (shutdown cancels queued ones)
        self.pool_future: Optional[Future] = None

    @property
    def state(self) -> str:
        if not self.future.done():
            return UserTaskState.ACTIVE
        if self.future.exception() is not None:
            return UserTaskState.COMPLETED_WITH_ERROR
        return UserTaskState.COMPLETED

    def to_json(self) -> dict:
        out = {
            "UserTaskId": self.task_id,
            "RequestURL": self.endpoint,
            "Status": self.state,
            "StartMs": int(self.created_s * 1000),
        }
        if self.completed_s is not None:
            out["DurationMs"] = int((self.completed_s - self.created_s) * 1000)
        out.update(self.progress.to_json())
        return out


class UserTaskManager:
    def __init__(self, max_active_tasks: int = 25,
                 completed_task_ttl_s: float = 3600.0,
                 max_workers: int = 4,
                 max_cached_completed: int = 100,
                 id_factory: Optional[Callable[[], str]] = None):
        self.max_active_tasks = max_active_tasks
        self.completed_task_ttl_s = completed_task_ttl_s
        #: completed tasks kept at most, oldest evicted first (on top of TTL)
        self.max_cached_completed = max_cached_completed
        #: task-id source (the scenario simulator injects a deterministic
        #: counter so journal fingerprints are reproducible)
        self.id_factory = id_factory
        self._tasks: Dict[str, UserTask] = {}
        self._lock = InstrumentedLock("user_tasks.table")
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="user-task"
        )

    # ---- lifecycle --------------------------------------------------------------
    def submit(self, endpoint: str, fn: Callable[[OperationProgress], object],
               task_id: Optional[str] = None,
               deadline_monotonic: Optional[float] = None,
               trace_id: Optional[str] = None) -> UserTask:
        """Run ``fn(progress)`` on the pool under a new (or supplied) task
        id.  ``deadline_monotonic`` re-enters the request's deadline scope
        on the worker thread — an abandoned request stops burning analyzer
        time at its deadline even though the 202 handoff changed threads.
        ``trace_id`` re-enters the request's correlation scope the same
        way, so the operation's spans and journal events keep the id."""
        self._expire()
        with self._lock:
            active = sum(
                1 for t in self._tasks.values()
                if t.state == UserTaskState.ACTIVE
            )
            if active >= self.max_active_tasks:
                raise TooManyTasksError(
                    f"{active} active tasks >= cap {self.max_active_tasks}"
                )
            tid = task_id or (
                self.id_factory() if self.id_factory is not None
                else str(uuid.uuid4())
            )
            if tid in self._tasks:
                return self._tasks[tid]  # idempotent resubmit: same task
            task = UserTask(tid, endpoint)
            self._tasks[tid] = task

        def run() -> None:
            try:
                # every journal event emitted on this worker thread carries
                # the async protocol's User-Task-ID (events.task_scope is a
                # thread-local; correlation without signature plumbing) and
                # the request's trace id (trace.trace_scope: no-op on None)
                with trace.trace_scope(trace_id), \
                        events.task_scope(tid, endpoint.upper()), \
                        admission.deadline_scope(deadline_monotonic):
                    # a task whose deadline passed while queued behind the
                    # worker pool must not run at all
                    admission.check_deadline(endpoint)
                    task.future.set_result(fn(task.progress))
            except BaseException as e:  # surfaced via the future
                task.future.set_exception(e)
            finally:
                task.completed_s = time.time()

        task.pool_future = self._pool.submit(run)
        return task

    def get(self, task_id: str) -> Optional[UserTask]:
        self._expire()
        with self._lock:
            return self._tasks.get(task_id)

    def tasks(self) -> List[UserTask]:
        self._expire()
        with self._lock:
            return sorted(self._tasks.values(), key=lambda t: t.created_s)

    def _expire(self) -> None:
        now = time.time()
        with self._lock:
            for tid, t in list(self._tasks.items()):
                if (
                    t.completed_s is not None
                    and now - t.completed_s > self.completed_task_ttl_s
                ):
                    del self._tasks[tid]
            done = sorted(
                (
                    (t.completed_s, tid) for tid, t in self._tasks.items()
                    if t.completed_s is not None
                ),
            )
            for _, tid in done[: max(0, len(done) - self.max_cached_completed)]:
                del self._tasks[tid]

    def shutdown(self, timeout_s: float = 5.0) -> None:
        """Stop the pool without leaking threads or wedging server stop:
        queued (not-yet-started) work is cancelled — its tasks complete
        with CancelledError so late polls see a terminal state instead of
        an eternal ACTIVE — and the worker threads are joined with a
        bounded timeout (an operation stuck mid-execution must not hang
        shutdown forever; daemonized HTTP threads die with the process)."""
        self._pool.shutdown(wait=False, cancel_futures=True)
        now = time.time()
        with self._lock:
            tasks = list(self._tasks.values())
        for t in tasks:
            if (t.pool_future is not None and t.pool_future.cancelled()
                    and not t.future.done()):
                t.future.set_exception(
                    CancelledError("server shut down before the task ran")
                )
                t.completed_s = now
        deadline = now + max(0.0, timeout_s)
        # ThreadPoolExecutor keeps no public thread handle; `_threads` is
        # the stable stdlib attribute (the bounded join is the whole point)
        for thread in list(getattr(self._pool, "_threads", ())):
            thread.join(timeout=max(0.0, deadline - time.time()))


class TooManyTasksError(RuntimeError):
    pass
