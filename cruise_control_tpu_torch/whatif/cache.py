"""Per-future verdict cache, keyed ``model_generation × fingerprint``.

The key IS the staleness story: a verdict computed against generation
``w3.e1000`` can never answer for ``w4.e1000`` — :meth:`get` misses on a
generation bump without any TTL bookkeeping.  Invalidation (anomaly,
execution, explicit) additionally *drops* entries: unlike the warm plan
— which degrades to a marked-stale answer — a stale counterfactual has
no degraded-serving value, it is simply wrong.

``fresh_for(generation)`` is the precompute daemon's probe: True only while the warm set was filled at exactly the
probed generation and nothing invalidated it since — so a
model-generation bump wakes the daemon to re-evaluate the top-k futures
alongside the warm plan.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional, Tuple


class WhatifCache:
    """Bounded, thread-safe verdict store (FIFO eviction)."""

    def __init__(self, max_entries: int = 256):
        self.max_entries = max(1, int(max_entries))
        self._entries: "OrderedDict[Tuple[str, str], dict]" = OrderedDict()
        self._lock = threading.Lock()
        #: generation the warm (precomputed) set was filled at; None =
        #: never filled or invalidated since
        self._warm_generation: Optional[str] = None
        self._last_invalidated: Optional[str] = None
        self.hits = 0
        self.misses = 0

    def get(self, generation: str, fingerprint: str) -> Optional[dict]:
        with self._lock:
            verdict = self._entries.get((generation, fingerprint))
            if verdict is None:
                self.misses += 1
                return None
            self.hits += 1
            return dict(verdict)

    def put(self, generation: str, fingerprint: str, verdict: dict) -> None:
        with self._lock:
            self._entries[(generation, fingerprint)] = dict(verdict)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)

    def mark_warm(self, generation: str) -> None:
        """The precompute daemon filled its top-k set at ``generation``."""
        with self._lock:
            self._warm_generation = generation

    def fresh_for(self, generation: str) -> bool:
        with self._lock:
            return (self._warm_generation is not None
                    and self._warm_generation == generation)

    def invalidate(self, reason: str = "invalidated") -> None:
        """Drop everything: a stale counterfactual must never serve."""
        with self._lock:
            self._entries.clear()
            self._warm_generation = None
            self._last_invalidated = reason

    def state_summary(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "warmGeneration": self._warm_generation,
                "lastInvalidated": self._last_invalidated,
                "hits": self.hits,
                "misses": self.misses,
            }
