"""Per-file parse context: one ``ast.parse`` per file, shared by every
rule (the driver's single-parse contract — the wall-clock budget in
``tests/test_cclint.py`` holds the pass to < 5 s over the package).

Besides the tree itself the context memoizes the two traversal products
every rule wants — the flat node list and the child → parent map — so
the N rules of the pass pay for ONE full walk instead of N (profiling
showed repeated ``ast.walk`` dominating the per-file cost once the rule
pack grew past a handful of rules)."""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass
class FileContext:
    path: str                 # as reported in findings
    text: str
    lines: List[str]
    tree: ast.Module
    _parents: Optional[Dict[ast.AST, ast.AST]] = None
    _all_nodes: Optional[List[ast.AST]] = None

    @classmethod
    def parse(cls, path: str, text: str) -> "FileContext":
        return cls(path=path, text=text, lines=text.splitlines(),
                   tree=ast.parse(text, filename=path))

    @property
    def all_nodes(self) -> List[ast.AST]:
        """Every node of the tree in ``ast.walk`` (BFS) order, computed
        once per file.  Rules iterate this instead of re-walking."""
        if self._all_nodes is None:
            self._all_nodes = list(ast.walk(self.tree))
        return self._all_nodes

    @property
    def parents(self) -> Dict[ast.AST, ast.AST]:
        """child → parent map, built lazily once per file."""
        if self._parents is None:
            parents: Dict[ast.AST, ast.AST] = {}
            for node in self.all_nodes:
                for child in ast.iter_child_nodes(node):
                    parents[child] = node
            self._parents = parents
        return self._parents

    def ancestors(self, node: ast.AST) -> List[ast.AST]:
        """Path from ``node`` up to the module, nearest parent first."""
        out = []
        cur = node
        parents = self.parents
        while cur in parents:
            cur = parents[cur]
            out.append(cur)
        return out
