"""cclint for the PyTorch port — the repo-native static-analysis pass.

A copy of the reference's two-phase, whole-program rule pack
(``cruise_control_tpu/devtools/lint``), run over
``cruise_control_tpu_torch/``.  Phase 1 (per file, content-hash cached
under ``.cclint_torch_cache/``): lock discipline in the threaded daemons,
host syncs inside the captured step, static observability names, loud
daemon loops, bounded resources, retry and cache-key discipline.  Phase
2 (project symbol graph + call graph): cross-module locksets, host syncs
reachable from the captured step, deadline propagation from the HTTP
handlers, journal-schema closure, and the config-surface closure against
the port's registry.  The rule ids are the reference's (the suppression
vocabulary); the five device rules check their torch analogs.
``docs/STATIC_ANALYSIS.md`` describes the architecture and
``docs/STATIC_ANALYSIS_TORCH.md`` what the port's rules check;
``tests/test_torch_cclint_package.py`` runs the pass over the package
with a zero-findings contract.

Usage::

    python -m cruise_control_tpu_torch.devtools.lint [paths] \
        [--format=text|json|sarif] [--rule=id[,id]] [--changed-only] \
        [--stats] [--lock-graph PATH]
"""

from cruise_control_tpu_torch.devtools.lint.context import FileContext
from cruise_control_tpu_torch.devtools.lint.driver import (
    RULES,
    SCHEMA,
    LintResult,
    collect_files,
    default_target,
    render,
    run_lint,
)
from cruise_control_tpu_torch.devtools.lint.findings import (
    BAD_SUPPRESSION,
    Finding,
    Suppressions,
    parse_suppressions,
)

__all__ = [
    "BAD_SUPPRESSION",
    "FileContext",
    "Finding",
    "LintResult",
    "RULES",
    "SCHEMA",
    "Suppressions",
    "collect_files",
    "default_target",
    "parse_suppressions",
    "render",
    "run_lint",
]
