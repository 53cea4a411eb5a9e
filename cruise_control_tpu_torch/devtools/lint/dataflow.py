"""Worklist dataflow over the lint CFGs.

``forward`` is the generic engine: states are arbitrary values,
``transfer`` folds a block's events into a state, ``join`` merges at
confluence points, unreached blocks stay ``None``.  On top of it sit
the two concrete analyses the concurrency rules need:

* :func:`must_locksets` — held-lockset BEFORE every event, a forward
  *must* analysis (intersection join): a lock is reported held at a
  point only when it is held on EVERY path reaching it.  Optimistic
  ``None`` initialization makes the worklist converge to the greatest
  fixpoint; the polarity under-approximates held sets, so the
  lock-order and blocking-under-lock rules miss edges rather than
  invent them — the right direction for a zero-findings gate.
* :func:`releases_on_all_paths` — does every path from just after an
  acquire event to the function exit pass a matching release?  A
  backward *must* analysis run as a decreasing fixpoint from
  all-``True``; infinite loops that never reach the exit are vacuously
  safe.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from cruise_control_tpu_torch.devtools.lint.cfg import ACQUIRE, CFG, CFGEvent


def forward(cfg: CFG, transfer: Callable[[int, object], object],
            init: object, join: Callable[[object, object], object]) -> List:
    """Generic forward worklist.  Returns the IN state per block
    (``None`` for unreached blocks)."""
    states: List[Optional[object]] = [None] * len(cfg.blocks)
    states[cfg.entry] = init
    work = [cfg.entry]
    while work:
        b = work.pop()
        out = transfer(b, states[b])
        for s in cfg.blocks[b].succs:
            new = out if states[s] is None else join(states[s], out)
            if states[s] is None or new != states[s]:
                states[s] = new
                work.append(s)
    return states


def must_locksets(
    cfg: CFG, resolve: Callable[[CFGEvent], Optional[str]],
) -> Dict[Tuple[int, int], frozenset]:
    """``(block, event index) → frozenset of lock ids held BEFORE the
    event``, for every event in every reached block.  ``resolve`` maps
    an acquire/release event to a lock id (``None`` = not a lock)."""
    ids: List[List[Optional[str]]] = []
    for blk in cfg.blocks:
        ids.append([
            resolve(e) if e.kind != "call" else None for e in blk.events
        ])

    def transfer(b: int, state: frozenset) -> frozenset:
        for e, lid in zip(cfg.blocks[b].events, ids[b]):
            if lid is None:
                continue
            state = state | {lid} if e.kind == ACQUIRE else state - {lid}
        return state

    inn = forward(cfg, transfer, frozenset(),
                  lambda a, b: a & b)
    out: Dict[Tuple[int, int], frozenset] = {}
    for b, blk in enumerate(cfg.blocks):
        state = inn[b]
        if state is None:
            continue
        for i, e in enumerate(blk.events):
            out[(b, i)] = state
            lid = ids[b][i]
            if lid is not None:
                state = (state | {lid} if e.kind == ACQUIRE
                         else state - {lid})
    return out


def releases_on_all_paths(cfg: CFG, block: int, event_idx: int,
                          match: Callable[[CFGEvent], bool]) -> bool:
    """True iff every path from just after ``(block, event_idx)`` to
    the exit passes an event satisfying ``match``."""
    n = len(cfg.blocks)
    contains = [any(match(e) for e in blk.events) for blk in cfg.blocks]
    rel = [True] * n
    changed = True
    while changed:
        changed = False
        for b in range(n):
            if contains[b]:
                continue
            v = bool(cfg.blocks[b].succs) \
                and all(rel[s] for s in cfg.blocks[b].succs)
            if v != rel[b]:
                rel[b] = v
                changed = True
    blk = cfg.blocks[block]
    if any(match(e) for e in blk.events[event_idx + 1:]):
        return True
    return bool(blk.succs) and all(rel[s] for s in blk.succs)
