"""``python -m cruise_control_tpu_torch.devtools.lint`` — the port's
cclint.  With no path it lints ``cruise_control_tpu_torch/``.  Exit
status: 0 = clean, 1 = findings, 2 = usage."""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from cruise_control_tpu_torch.devtools.lint.driver import (
    RULES,
    default_target,
    render,
    run_lint,
)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="cclint",
        description="repo-native static analysis of the PyTorch port: "
                    "lock discipline, host syncs in the captured step, "
                    "config/doc/metric drift "
                    "(docs/STATIC_ANALYSIS_TORCH.md)",
    )
    parser.add_argument(
        "paths", nargs="*",
        help=f"files or directories to lint (default: {default_target()})",
    )
    parser.add_argument(
        "--format", choices=("text", "json", "sarif"), default="text",
        help="output format (json follows tests/schemas/lint.schema.json; "
             "sarif is the 2.1.0 profile in tests/schemas/"
             "sarif.schema.json for editor/CI annotation)",
    )
    parser.add_argument(
        "--stats", action="store_true",
        help="print phase accounting (files parsed, cache hits, graph "
             "build ms) — the budget test asserts on these",
    )
    parser.add_argument(
        "--rule", action="append", default=None, metavar="ID[,ID]",
        help="run only these rule ids (repeatable or comma-separated)",
    )
    parser.add_argument(
        "--changed-only", action="store_true",
        help="lint only files changed vs git HEAD (plus untracked) — "
             "the fast pre-commit mode",
    )
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule ids and summaries, then exit",
    )
    parser.add_argument(
        "--lock-graph", metavar="PATH", default=None,
        help="write the global lock-order graph (cc-tpu-lock-graph/1) "
             "to PATH after linting — the committed "
             "PORT_LOCK_GRAPH_r*.json artifacts are generated this way",
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule_id, rule in sorted(RULES.items()):
            print(f"{rule_id}: {rule.summary}")
        return 0

    rules = None
    if args.rule:
        rules = [r.strip() for spec in args.rule for r in spec.split(",")
                 if r.strip()]
        unknown = sorted(set(rules) - set(RULES))
        if unknown:
            print(f"cclint: unknown rule(s) {unknown}; known: "
                  f"{sorted(RULES)}", file=sys.stderr)
            return 2

    result = run_lint(paths=args.paths or None, rules=rules,
                      changed_only=args.changed_only)
    if args.lock_graph:
        import json
        import pathlib

        from cruise_control_tpu_torch.devtools.lint.rules_lockorder import (
            build_lock_graph,
        )

        artifact = build_lock_graph(result.project)
        pathlib.Path(args.lock_graph).write_text(
            json.dumps(artifact, indent=1, sort_keys=True) + "\n")
    print(render(result, args.format, show_stats=args.stats))
    return 1 if result.findings else 0


if __name__ == "__main__":
    sys.exit(main())
