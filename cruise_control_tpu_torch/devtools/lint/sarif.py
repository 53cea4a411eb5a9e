"""SARIF 2.1.0 output (``cclint --format sarif``).

The minimal static-analysis interchange profile editors and CI
annotators consume: one run, the rule table from the registry, one
result per finding with a physical location.  The shape is contracted
by ``tests/schemas/sarif.schema.json`` (checked in, validated against
live output by ``tests/test_cclint.py``) so a consumer can rely on
exactly these fields."""

from __future__ import annotations

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA_URI = (
    "https://docs.oasis-open.org/sarif/sarif/v2.1.0/errata01/os/schemas/"
    "sarif-schema-2.1.0.json"
)


def to_sarif(result, rules) -> dict:
    """LintResult + rule registry → a SARIF 2.1.0 log dict."""
    rule_ids = sorted({f.rule for f in result.findings} | set(rules))
    rule_index = {rid: i for i, rid in enumerate(rule_ids)}
    return {
        "$schema": SARIF_SCHEMA_URI,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {
                "driver": {
                    "name": "cclint",
                    "informationUri":
                        "docs/STATIC_ANALYSIS.md",
                    "rules": [
                        {
                            "id": rid,
                            "shortDescription": {
                                "text": getattr(rules.get(rid), "summary",
                                                rid)
                                if hasattr(rules, "get") else rid,
                            },
                        }
                        for rid in rule_ids
                    ],
                }
            },
            "results": [
                {
                    "ruleId": f.rule,
                    "ruleIndex": rule_index[f.rule],
                    "level": "warning",
                    "message": {"text": f.message},
                    "locations": [{
                        "physicalLocation": {
                            "artifactLocation": {"uri": f.path},
                            "region": {
                                "startLine": max(1, f.line),
                                "startColumn": max(1, f.col + 1),
                            },
                        }
                    }],
                }
                for f in result.findings
            ],
        }],
    }
