"""Captured step chunks: the search's step loop as CUDA graphs.

The reference runs a scan call's steps inside one ``lax.while_loop``
(``cruise_control_tpu/analyzer/tpu_optimizer.py:1409 run_capped``) and
never returns to the host within a call.  The port records N consecutive
steps, once per optimizer and shape, into a CUDA graph
(``torch.cuda.graph``) and replays it until the device carry
(:mod:`analyzer.step_state`) says the loop has ended: one host read of a
few ints a chunk.  The step is masked on the
device — a step past the end commits nothing and leaves the carry as it
is — so a chunk may run past convergence, a repool or the slot budget and
give the same result as stepping one at a time.  On the CPU the same
masked step runs eagerly, N a chunk.

A graph bakes in every address it touches, so the step must read and
write only buffers that outlive the graph (the step loop's static model,
pool buffers, carry and output) and scratch allocated during capture; the
kernel wrappers launch on the current stream, which is the capture
stream, and read nothing back.  A capture or replay failure raises: there
is no fall back to stepping eagerly.

Launch counts: the wrappers count their launches when the step calls
them, so during capture they would count launches that have not run.  The
chunk takes those counts back after capture and adds them again at every
replay, when the kernels do run.  The launches' work (bytes and
operations, ``ops/kernels.py: WORK``) goes the same way: noted into the
chunk's own table at capture, and added to the open recorders (the kernel
observatory's capture) at every replay.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from cruise_control_tpu_torch.ops import kernels

#: steps a chunk: a scan call of s steps reads the device carry
#: ceil(s / STEP_CHUNK) times
STEP_CHUNK = 16


class StepChunk:
    """``n`` calls of ``step(checked)`` run eagerly or as one captured
    graph.  ``counted`` are the kernel wrappers whose ``.launches`` a
    replay adds to."""

    def __init__(self, step: Callable[[bool], None], n: int,
                 counted: List[Callable]):
        self.step = step
        self.n = n
        self.counted = counted
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.captured: List[int] = []
        #: the captured launches' work: stem → [launches, bytes, operations]
        self.work: Dict[str, List[float]] = {}
        self.replays = 0

    def run_eager(self, checked: bool) -> None:
        """One chunk, step by step; the first step checks the wrappers'
        inputs unless ``checked``."""
        for i in range(self.n):
            self.step(checked or i > 0)

    def capture(self) -> None:
        """Record the chunk into a CUDA graph (nothing runs); the steps'
        inputs were checked by an eager step before."""
        before = [f.launches for f in self.counted]
        graph = torch.cuda.CUDAGraph()
        with kernels.WORK.recording(exclusive=True) as work, \
                torch.cuda.graph(graph):
            for _ in range(self.n):
                self.step(True)
        self.work = work
        self.captured = [f.launches - b for f, b in zip(self.counted, before)]
        for f, b in zip(self.counted, before):
            f.launches = b
        self.graph = graph

    def replay(self) -> None:
        """Run the captured chunk once on the current stream."""
        self.graph.replay()
        self.replays += 1
        for f, n in zip(self.counted, self.captured):
            f.launches += n
        if kernels.WORK.active:
            kernels.WORK.add(self.work)
