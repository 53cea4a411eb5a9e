"""lock-order — global lock-acquisition-order deadlock detection.

The Eraser-lineage rules (``lock-discipline``, ``cross-module-lock``)
prove *lockset consistency*; they say nothing about *ordering*.  Two
threads acquiring the same two named locks in opposite orders deadlock
production without any lockset violation, and no runtime test catches
it until it hangs.  This rule builds the one global lock-order graph
from the flow-sensitive :class:`~lockflow.LockFlow` products — an edge
``A → B`` means "somewhere, ``B`` is acquired while ``A`` is held",
either directly or through a callgraph-projected call chain — and
reports every cycle as a deadlock finding with the full file:line
witness chain per edge.

The graph itself is reviewable: ``cclint --lock-graph out.json`` emits
it as a ``cc-tpu-lock-graph/1`` artifact, the repo commits the current
graph as ``LOCK_GRAPH_r19.json``, and a tier-1 test reconciles it
against the runtime acquisition orders the ``CONTENTION`` witness
recorder observes (every dynamic edge must be a static edge).

Known blind spots (docs/STATIC_ANALYSIS.md): only NAMED instrumented
locks participate (raw ``threading.Lock`` nesting is invisible);
same-name self-edges are dropped (distinct instances sharing a name
are indistinguishable); calls through containers/getattr and lock
handoffs across threads are not modeled."""

from __future__ import annotations

from typing import List

from cruise_control_tpu_torch.devtools.lint.findings import Finding

RULE_ID = "lock-order"

SCHEMA = "cc-tpu-lock-graph/1"


def _render_chain(chain) -> str:
    return " ; ".join(f"{p}:{ln} {note}" for p, ln, note in chain)


class LockOrderRule:
    id = RULE_ID
    summary = ("lock acquisition order must be globally acyclic — a "
               "cycle between named locks is a deadlock waiting for "
               "the right interleaving")
    project_rule = True

    def check_file(self, ctx) -> List[Finding]:
        return []

    def check_project(self, project) -> List[Finding]:
        lf = project.lockflow
        out: List[Finding] = []
        for cycle in lf.cycles():
            edges = list(zip(cycle, cycle[1:] + cycle[:1]))
            first = lf.witness_chain(*edges[0])
            anchor_path, anchor_line = first[0][0], first[0][1]
            legs = []
            for a, b in edges:
                chain = lf.witness_chain(a, b)
                legs.append(f"{a} → {b} [{_render_chain(chain)}]")
            out.append(Finding(
                anchor_path, anchor_line, self.id,
                "lock-order cycle (potential deadlock): "
                + " | ".join(legs),
            ))
        return out


def build_lock_graph(project) -> dict:
    """The committed/reviewable artifact: every named lock, every
    acquisition-order edge with its first witness chain, every cycle.
    Deterministic for a given tree (sorted, first-witness-wins)."""
    lf = project.lockflow
    edges = []
    for (a, b) in sorted(lf.edge_witness):
        chain = lf.edge_witness[(a, b)]
        edges.append({
            "from": a,
            "to": b,
            "count": lf.edge_count[(a, b)],
            "witness": [
                {"path": p, "line": ln, "note": note}
                for p, ln, note in chain
            ],
        })
    return {
        "schema": SCHEMA,
        "locks": sorted(lf.lock_vocab),
        "edges": edges,
        "cycles": lf.cycles(),
    }
