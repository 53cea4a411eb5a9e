"""Purgatory — optional two-step (submit → review → execute) verification for
mutating endpoints (upstream ``servlet/purgatory/Purgatory.java`` +
``ReviewStatus``; SURVEY.md §2.7).

When two-step verification is enabled, a mutating POST lands here as
PENDING_REVIEW and returns its review id instead of executing.  An admin
approves or discards via the REVIEW endpoint; the original caller then
re-submits with ``review_id=`` to execute the approved request once.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional

from cruise_control_tpu_torch.utils.locks import InstrumentedLock


class ReviewStatus:
    PENDING_REVIEW = "PENDING_REVIEW"
    APPROVED = "APPROVED"
    SUBMITTED = "SUBMITTED"
    DISCARDED = "DISCARDED"


class RequestInfo:
    def __init__(self, review_id: int, endpoint: str, params: dict):
        self.review_id = review_id
        self.endpoint = endpoint
        self.params = dict(params)
        self.status = ReviewStatus.PENDING_REVIEW
        self.submitted_ms = int(time.time() * 1000)
        self.reason: Optional[str] = None

    def to_json(self) -> dict:
        return {
            "Id": self.review_id,
            "EndPoint": self.endpoint,
            "Status": self.status,
            "SubmissionTimeMs": self.submitted_ms,
            "Reason": self.reason,
        }


class Purgatory:
    def __init__(self, retention_s: float = 86_400.0):
        self._requests: Dict[int, RequestInfo] = {}
        self._ids = itertools.count(1)
        self._lock = InstrumentedLock("review.purgatory")
        self.retention_s = retention_s

    def add(self, endpoint: str, params: dict) -> RequestInfo:
        with self._lock:
            info = RequestInfo(next(self._ids), endpoint, params)
            self._requests[info.review_id] = info
            return info

    def approve(self, review_id: int, reason: Optional[str] = None) -> RequestInfo:
        return self._transition(
            review_id, ReviewStatus.PENDING_REVIEW, ReviewStatus.APPROVED, reason
        )

    def discard(self, review_id: int, reason: Optional[str] = None) -> RequestInfo:
        return self._transition(
            review_id, ReviewStatus.PENDING_REVIEW, ReviewStatus.DISCARDED, reason
        )

    def take_approved(self, review_id: int, endpoint: str) -> RequestInfo:
        """Claim an APPROVED request for execution (one-shot)."""
        with self._lock:
            info = self._requests.get(review_id)
            if info is None:
                raise KeyError(f"unknown review id {review_id}")
            if info.endpoint != endpoint:
                raise ValueError(
                    f"review {review_id} is for {info.endpoint}, not {endpoint}"
                )
            if info.status != ReviewStatus.APPROVED:
                raise ValueError(
                    f"review {review_id} is {info.status}, not APPROVED"
                )
            info.status = ReviewStatus.SUBMITTED
            return info

    def requeue(self, review_id: int) -> RequestInfo:
        """Return a claimed (SUBMITTED) request to APPROVED — used when
        execution could not start and the approval must not be consumed."""
        return self._transition(
            review_id, ReviewStatus.SUBMITTED, ReviewStatus.APPROVED, None
        )

    def _transition(self, review_id: int, expect: str, to: str,
                    reason: Optional[str]) -> RequestInfo:
        with self._lock:
            info = self._requests.get(review_id)
            if info is None:
                raise KeyError(f"unknown review id {review_id}")
            if info.status != expect:
                raise ValueError(
                    f"review {review_id} is {info.status}, not {expect}"
                )
            info.status = to
            info.reason = reason
            return info

    def review_board(self) -> List[dict]:
        now = time.time()
        with self._lock:
            for rid, info in list(self._requests.items()):
                if now - info.submitted_ms / 1000 > self.retention_s:
                    del self._requests[rid]
            return [info.to_json() for info in self._requests.values()]
