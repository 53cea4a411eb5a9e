"""OperationProgress — live step-by-step progress of a long-running operation
(upstream ``servlet/handler/async/progress/OperationProgress.java``;
SURVEY.md §5.1).

Each long operation appends human-readable steps with timings; the server
layer surfaces the list through ``GET /user_tasks`` and embeds it in async
responses.  Steps are immutable once finished; the object is thread-safe
because a detector thread and an HTTP poll can observe it concurrently.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

from cruise_control_tpu_torch.utils.locks import InstrumentedLock


class OperationStep:
    def __init__(self, description: str, start_s: float):
        self.description = description
        self.start_s = start_s
        self.end_s: Optional[float] = None

    @property
    def duration_s(self) -> float:
        end = self.end_s if self.end_s is not None else time.time()
        return end - self.start_s

    def to_json(self) -> dict:
        return {
            "step": self.description,
            "timeInMs": round(self.duration_s * 1000.0, 3),
            "completed": self.end_s is not None,
        }


class OperationProgress:
    """Append-only step log; ``step(...)`` is a context manager."""

    def __init__(self, operation: str = ""):
        self.operation = operation
        self._steps: List[OperationStep] = []
        self._lock = InstrumentedLock("operation.progress")

    def add_step(self, description: str) -> OperationStep:
        step = OperationStep(description, time.time())
        with self._lock:
            # finish any still-open step: steps are sequential by contract
            if self._steps and self._steps[-1].end_s is None:
                self._steps[-1].end_s = step.start_s
            self._steps.append(step)
        return step

    def finish(self) -> None:
        with self._lock:
            if self._steps and self._steps[-1].end_s is None:
                self._steps[-1].end_s = time.time()

    def step(self, description: str) -> "_StepContext":
        return _StepContext(self, description)

    def to_json(self) -> dict:
        with self._lock:
            return {
                "operation": self.operation,
                "operationProgress": [s.to_json() for s in self._steps],
            }


class _StepContext:
    def __init__(self, progress: OperationProgress, description: str):
        self._progress = progress
        self._description = description

    def __enter__(self) -> OperationStep:
        self._step = self._progress.add_step(self._description)
        return self._step

    def __exit__(self, *exc) -> bool:
        if self._step.end_s is None:
            self._step.end_s = time.time()
        return False
