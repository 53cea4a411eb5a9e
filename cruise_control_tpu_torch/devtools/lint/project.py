"""ProjectContext — what phase 2 (interprocedural) rules receive.

Bundles the assembled :class:`SymbolGraph`, the :class:`CallGraph`,
and run metadata (which files this run actually linted, the repo
root).  Project rules implement ``check_project(project)`` and read
everything through this object; they never re-parse files."""

from __future__ import annotations

import dataclasses
import pathlib
from typing import List, Optional, Set

from cruise_control_tpu_torch.devtools.lint.callgraph import CallGraph
from cruise_control_tpu_torch.devtools.lint.graph import ModuleSummary, SymbolGraph


@dataclasses.dataclass
class ProjectContext:
    graph: SymbolGraph
    summaries: List[ModuleSummary]
    #: resolved absolute paths of every file in this run's lint set
    linted_abs: Set[pathlib.Path]
    repo_root: pathlib.Path
    _callgraph: Optional[CallGraph] = None
    _lockflow: Optional[object] = None

    @property
    def callgraph(self) -> CallGraph:
        """Built lazily: journal-schema and config-key-drift never need
        call edges, so a run selecting only those skips the build."""
        if self._callgraph is None:
            self._callgraph = CallGraph(self.graph)
        return self._callgraph

    @property
    def lockflow(self):
        """The flow-sensitive lock analysis (lockflow.LockFlow), built
        once and shared by lock-order / blocking-under-lock — the CFG
        dataflow and callgraph fixpoints run a single time per lint."""
        if self._lockflow is None:
            from cruise_control_tpu_torch.devtools.lint.lockflow import LockFlow

            self._lockflow = LockFlow(self)
        return self._lockflow
