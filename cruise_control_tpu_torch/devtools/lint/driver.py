"""cclint driver — the two-phase whole-program pass, over the port.

Phase 1 (per file, cached): parse once, run every per-file rule on the
shared :class:`FileContext`, extract the picklable
:class:`~graph.ModuleSummary`.  Both products are cached under
``.cclint_torch_cache/`` keyed by content hash and salted with the lint
package's own sources, so a warm run re-parses nothing.  The port's
cache is its own directory: the reference's pass (``.cclint_cache/``)
and this one run side by side in the test workers and must never share
a store.

Phase 2 (whole program): assemble the summaries into the
:class:`~graph.SymbolGraph` (+ lazy :class:`~callgraph.CallGraph`) and
run the project rules — the interprocedural lockset, the captured
step's transitive host syncs, deadline propagation, journal-schema
closure, and the config-surface closure against the port's registry.

The contract the pytest wrappers (``tests/test_torch_cclint_*.py``)
enforce:

* single parse per file — every rule reads the shared context (or the
  cache of its products);
* the merged tree yields ZERO findings — true positives get fixed,
  deliberate exceptions get an inline suppression with a reason;
* ``--changed-only`` re-lints reverse-dependents of changed modules
  via the import graph, and always runs the project rules over the
  full graph, so interprocedural findings cannot be dodged by a
  partial diff.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import subprocess
import time
from typing import Dict, Iterable, List, Optional, Sequence, Set

from cruise_control_tpu_torch.devtools.lint import graph as graph_mod
from cruise_control_tpu_torch.devtools.lint import sarif as sarif_mod
from cruise_control_tpu_torch.devtools.lint.cache import CacheEntry, CacheStore
from cruise_control_tpu_torch.devtools.lint.context import FileContext
from cruise_control_tpu_torch.devtools.lint.findings import (
    BAD_SUPPRESSION,
    Finding,
    Suppressions,
    parse_suppressions,
)
from cruise_control_tpu_torch.devtools.lint.project import ProjectContext
from cruise_control_tpu_torch.devtools.lint.rules_bounded import (
    BoundedResourceRule,
)
from cruise_control_tpu_torch.devtools.lint.rules_cache import (
    CacheKeyDisciplineRule,
)
from cruise_control_tpu_torch.devtools.lint.rules_config import ConfigKeyDriftRule
from cruise_control_tpu_torch.devtools.lint.rules_deadline import (
    DeadlinePropagationRule,
)
from cruise_control_tpu_torch.devtools.lint.rules_except import (
    SwallowedExceptionRule,
)
from cruise_control_tpu_torch.devtools.lint.rules_fenced import (
    FencedBackendDisciplineRule,
)
from cruise_control_tpu_torch.devtools.lint.rules_blocking import (
    BlockingUnderLockRule,
)
from cruise_control_tpu_torch.devtools.lint.rules_jax import JaxHotPathRule
from cruise_control_tpu_torch.devtools.lint.rules_lock import LockDisciplineRule
from cruise_control_tpu_torch.devtools.lint.rules_lockinst import (
    LockInstrumentationRule,
)
from cruise_control_tpu_torch.devtools.lint.rules_lockorder import LockOrderRule
from cruise_control_tpu_torch.devtools.lint.rules_obs import ObsDynamicNameRule
from cruise_control_tpu_torch.devtools.lint.rules_profiler import (
    ProfilerDisciplineRule,
)
from cruise_control_tpu_torch.devtools.lint.rules_release import ReleaseSafetyRule
from cruise_control_tpu_torch.devtools.lint.rules_retry import RetryDisciplineRule
from cruise_control_tpu_torch.devtools.lint.rules_schema import JournalSchemaRule
from cruise_control_tpu_torch.devtools.lint.rules_sharding import (
    ShardingDisciplineRule,
)
from cruise_control_tpu_torch.devtools.lint.rules_transfer import (
    TransferDisciplineRule,
)
from cruise_control_tpu_torch.devtools.lint.rules_wallclock import (
    WallClockDisciplineRule,
)
from cruise_control_tpu_torch.devtools.lint.rules_xjax import JaxTransitiveRule
from cruise_control_tpu_torch.devtools.lint.rules_xlock import CrossModuleLockRule

SCHEMA = "cc-tpu-lint/1"

#: rule registry — ordered for stable output; ids are the suppression
#: vocabulary (plus the reserved meta id ``bad-suppression``)
RULES = {
    rule.id: rule
    for rule in (
        LockDisciplineRule(),
        JaxHotPathRule(),
        ConfigKeyDriftRule(),
        ObsDynamicNameRule(),
        SwallowedExceptionRule(),
        RetryDisciplineRule(),
        BoundedResourceRule(),
        CacheKeyDisciplineRule(),
        CrossModuleLockRule(),
        JaxTransitiveRule(),
        DeadlinePropagationRule(),
        JournalSchemaRule(),
        WallClockDisciplineRule(),
        ProfilerDisciplineRule(),
        FencedBackendDisciplineRule(),
        TransferDisciplineRule(),
        ShardingDisciplineRule(),
        LockInstrumentationRule(),
        LockOrderRule(),
        BlockingUnderLockRule(),
        ReleaseSafetyRule(),
    )
}


def default_target() -> pathlib.Path:
    """The package this linter ships in — ``cclint`` with no arguments
    lints it, from any CWD."""
    return pathlib.Path(__file__).resolve().parents[2]


def _repo_root() -> pathlib.Path:
    return default_target().parent


#: the port's store, apart from the reference's ``.cclint_cache/``
CACHE_NAME = ".cclint_torch_cache"


def cache_dir() -> Optional[pathlib.Path]:
    """``.cclint_torch_cache/`` under the repo root (override with
    CCLINT_CACHE_DIR; CCLINT_CACHE=0 disables).  Safe to delete."""
    if os.environ.get("CCLINT_CACHE", "1") == "0":
        return None
    override = os.environ.get("CCLINT_CACHE_DIR")
    if override:
        return pathlib.Path(override)
    return _repo_root() / CACHE_NAME


def collect_files(paths: Sequence[str],
                  changed_only: bool = False) -> List[pathlib.Path]:
    files: List[pathlib.Path] = []
    for p in paths:
        path = pathlib.Path(p)
        if path.is_dir():
            files.extend(sorted(path.rglob("*.py")))
        elif path.suffix == ".py":
            files.append(path)
    files = sorted({f.resolve() for f in files})
    if changed_only:
        changed = changed_files()
        if changed is not None:
            files = [f for f in files if f in changed]
    return files


def changed_files() -> Optional[set]:
    """Files touched vs HEAD plus untracked, absolute; None when git is
    unavailable (callers fall back to the full list)."""
    root = _repo_root()
    try:
        diff = subprocess.run(
            ["git", "diff", "--name-only", "HEAD", "--diff-filter=d"],
            cwd=root, capture_output=True, text=True, timeout=10,
        )
        untracked = subprocess.run(
            ["git", "ls-files", "--others", "--exclude-standard"],
            cwd=root, capture_output=True, text=True, timeout=10,
        )
        if diff.returncode != 0:
            return None
    except (OSError, subprocess.SubprocessError):
        return None
    names = diff.stdout.splitlines() + untracked.stdout.splitlines()
    return {(root / n).resolve() for n in names if n.endswith(".py")}


def _rel(path: str) -> str:
    p = pathlib.Path(path)
    if not p.is_absolute():
        # already repo-relative (project-rule findings carry the
        # summaries' phase-1 rel paths) — resolving against the CWD
        # would mangle it whenever the process runs outside the root
        return path
    try:
        return str(p.resolve().relative_to(_repo_root()))
    except ValueError:
        return path


@dataclasses.dataclass
class LintResult:
    findings: List[Finding]
    files_scanned: int
    duration_s: float
    suppressions_used: int
    unused_suppressions: List[tuple]  # (path, line, rule)
    #: phase/budget accounting (the --stats surface): filesParsed is
    #: cache misses, cacheHits warm reuses, graphBuildMs phase 2,
    #: lockflowMs the flow-sensitive lock analysis inside phase 2
    stats: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: the phase-2 context, for post-run artifact emission
    #: (``--lock-graph``); never serialized
    project: object = None

    @property
    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return dict(sorted(out.items()))

    def to_json(self) -> dict:
        return {
            "schema": SCHEMA,
            "findings": [f.to_json() for f in self.findings],
            "counts": self.counts,
            "filesScanned": self.files_scanned,
            "suppressionsUsed": self.suppressions_used,
            "durationS": round(self.duration_s, 3),
            "stats": {
                "filesParsed": int(self.stats.get("filesParsed", 0)),
                "cacheHits": int(self.stats.get("cacheHits", 0)),
                "graphBuildMs": round(
                    float(self.stats.get("graphBuildMs", 0.0)), 3),
                "lockflowMs": round(
                    float(self.stats.get("lockflowMs", 0.0)), 3),
            },
        }

    def render_text(self, show_stats: bool = False) -> str:
        lines = [f.render() for f in self.findings]
        for path, line, rule in self.unused_suppressions:
            lines.append(
                f"{path}:{line} · note · unused suppression for "
                f"'{rule}' — remove it"
            )
        lines.append(
            f"cclint: {len(self.findings)} finding(s) in "
            f"{self.files_scanned} file(s) "
            f"({self.suppressions_used} suppression(s) honored, "
            f"{self.duration_s:.2f}s)"
        )
        if show_stats:
            lines.append(
                f"cclint stats: {int(self.stats.get('filesParsed', 0))} "
                f"parsed, {int(self.stats.get('cacheHits', 0))} cache "
                f"hit(s), graph build "
                f"{self.stats.get('graphBuildMs', 0.0):.1f} ms, "
                f"lockflow {self.stats.get('lockflowMs', 0.0):.1f} ms"
            )
        return "\n".join(lines)


def _per_file_rules(selected) -> list:
    return [r for r in selected if not getattr(r, "project_rule", False)]


def _project_rules(selected) -> list:
    return [r for r in selected if getattr(r, "project_rule", False)]


def run_lint(paths: Optional[Sequence[str]] = None,
             rules: Optional[Iterable[str]] = None,
             changed_only: bool = False,
             changed_paths: Optional[Set[pathlib.Path]] = None) -> LintResult:
    """``changed_paths`` overrides the git-derived changed set (tests
    inject it; the CLI always derives it from git)."""
    t0 = time.perf_counter()
    targets = [str(p) for p in (paths or [default_target()])]
    selected = [RULES[r] for r in (rules or RULES)]
    selected_ids = {r.id for r in selected}
    files = collect_files(targets)
    known_ids = set(RULES) | {BAD_SUPPRESSION}

    store = CacheStore(cache_dir(), graph_mod.lint_sources_salt())
    all_per_file = [r for r in RULES.values()
                    if not getattr(r, "project_rule", False)]

    findings: List[Finding] = []
    supp_by_path: Dict[str, Suppressions] = {}
    summaries: List[graph_mod.ModuleSummary] = []
    abs_by_rel: Dict[str, pathlib.Path] = {}
    per_file_findings: Dict[str, List[Finding]] = {}
    parsed = 0

    # ---- phase 1: per-file (cached) ---------------------------------------------
    for path in files:
        rel = _rel(str(path))
        abs_by_rel[rel] = path
        try:
            text = path.read_text()
        except OSError as e:
            findings.append(Finding(rel, 1, "parse-error",
                                    f"cannot lint: {e}"))
            continue
        supp_by_path[rel] = parse_suppressions(rel, text, known_ids)
        h = graph_mod.file_hash(text)
        entry = store.get(h)
        if entry is None:
            try:
                ctx = FileContext.parse(rel, text)
            except (SyntaxError, ValueError) as e:
                findings.append(
                    Finding(rel, getattr(e, "lineno", 1) or 1,
                            "parse-error", f"cannot lint: {e}"))
                continue
            parsed += 1
            raw: List[Finding] = []
            for rule in all_per_file:
                raw.extend(rule.check_file(ctx))
            summary = graph_mod.extract_summary(ctx.tree, ctx.all_nodes)
            entry = CacheEntry(
                summary=summary,
                findings=[(f.rule, f.line, f.col, f.message)
                          for f in raw],
            )
            store.put(h, entry)
        mod, _root = graph_mod.module_name_for(path)
        summary = dataclasses.replace(entry.summary, path=rel,
                                      module=mod)
        summaries.append(summary)
        per_file_findings[rel] = [
            Finding(rel, line, rule, message, col)
            for rule, line, col, message in entry.findings
            if rule in selected_ids
        ]
    store.save()

    # ---- phase 2: the whole-program graph ---------------------------------------
    t_graph = time.perf_counter()
    graph = graph_mod.build_graph(summaries)

    lint_set: Set[str] = set(per_file_findings)
    if changed_only:
        changed = (changed_paths if changed_paths is not None
                   else changed_files())
        if changed is not None:
            changed_rels = {_rel(str(p)) for p in changed}
            seeds = {
                s.module for s in summaries
                if s.path in changed_rels and s.module is not None
            }
            closure = graph.dependents_closure(seeds)
            lint_set = {
                s.path for s in summaries
                if s.path in changed_rels or s.module in closure
            }

    for rel in sorted(lint_set):
        findings.extend(per_file_findings.get(rel, ()))

    project = ProjectContext(
        graph=graph,
        summaries=summaries,
        linted_abs={p.resolve() for p in files},
        repo_root=_repo_root(),
    )
    # Under --changed-only the project rules still run over the FULL
    # graph (an interprocedural finding cannot be dodged by a partial
    # diff) — unless nothing changed at all, the pre-commit no-op.
    if not (changed_only and not lint_set):
        for rule in _project_rules(selected):
            raw = rule.check_project(project)
            findings.extend(
                dataclasses.replace(f, path=_rel(f.path)) for f in raw
            )
    graph_ms = (time.perf_counter() - t_graph) * 1000.0

    # ---- suppression filter ------------------------------------------------------
    kept: List[Finding] = []
    for f in findings:
        supp = supp_by_path.get(f.path)
        if supp is not None and supp.suppresses(f):
            continue
        kept.append(f)
    used = 0
    unused: List[tuple] = []
    for rel, supp in supp_by_path.items():
        used += len(supp.used)
        if rel not in lint_set:
            # outside the (possibly --changed-only-restricted) lint set
            # this file's per-file findings were dropped, so neither its
            # malformed-suppression findings nor unused-suppression
            # notes are meaningful this run
            continue
        kept.extend(supp.malformed)
        for line, ids in sorted(supp.by_line.items()):
            for rule_id in sorted(ids):
                if (line, rule_id) not in supp.used:
                    unused.append((rel, line, rule_id))
    kept.sort(key=lambda f: (f.path, f.line, f.rule))
    lockflow_ms = (project._lockflow.build_ms
                   if project._lockflow is not None else 0.0)
    return LintResult(
        findings=kept,
        files_scanned=len(lint_set),
        duration_s=time.perf_counter() - t0,
        suppressions_used=used,
        unused_suppressions=unused,
        stats={
            "filesParsed": parsed,
            "cacheHits": store.hits,
            "graphBuildMs": graph_ms,
            "lockflowMs": lockflow_ms,
        },
        project=project,
    )


def render(result: LintResult, fmt: str = "text",
           show_stats: bool = False) -> str:
    if fmt == "json":
        return json.dumps(result.to_json(), indent=1)
    if fmt == "sarif":
        return json.dumps(sarif_mod.to_sarif(result, RULES), indent=1)
    return result.render_text(show_stats=show_stats)
