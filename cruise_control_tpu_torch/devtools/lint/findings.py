"""Finding and suppression primitives for the cclint pass.

A finding renders as ``file:line · rule-id · message`` (the same
clickable anchor format the span-hygiene check used).  Suppressions are
inline comments on the flagged line::

    x = risky()  # cclint: disable=rule-id -- reason the rule is wrong here

The reason (everything after ``--``) is MANDATORY: a suppression is a
reviewed exception, and the review lives in the source next to the code
it excuses.  A reasonless or unknown-rule suppression is itself a
finding (rule id ``bad-suppression``) and cannot be suppressed.
"""

from __future__ import annotations

import dataclasses
import io
import re
import tokenize
from typing import Dict, List, Set

#: the meta rule id emitted for malformed suppressions; not suppressible
BAD_SUPPRESSION = "bad-suppression"

_SUPPRESS_RE = re.compile(
    r"#\s*cclint:\s*disable=([A-Za-z0-9_,\- ]+?)\s*(?:--\s*(.*))?$"
)


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str          # repo-relative where possible (driver normalizes)
    line: int
    rule: str
    message: str
    col: int = 0

    def render(self) -> str:
        return f"{self.path}:{self.line} · {self.rule} · {self.message}"

    def to_json(self) -> dict:
        return {
            "file": self.path,
            "line": self.line,
            "col": self.col,
            "rule": self.rule,
            "message": self.message,
        }


@dataclasses.dataclass
class Suppressions:
    """Per-file map of line → suppressed rule ids, plus the malformed
    suppressions found while parsing (surfaced as findings)."""

    by_line: Dict[int, Set[str]]
    malformed: List[Finding]
    #: (line, rule) pairs actually consumed — the CLI reports unused
    #: suppressions so stale excuses rot visibly, not silently
    used: Set[tuple] = dataclasses.field(default_factory=set)

    def suppresses(self, finding: Finding) -> bool:
        if finding.rule == BAD_SUPPRESSION:
            return False
        rules = self.by_line.get(finding.line, ())
        if finding.rule in rules:
            self.used.add((finding.line, finding.rule))
            return True
        return False


def _comment_lines(text: str, lines: List[str]):
    """(lineno, comment_text) for every real COMMENT token mentioning
    cclint — tokenizing (cheap, and only attempted when the file mentions
    cclint at all) keeps doc examples in string literals from registering
    as suppressions."""
    if "cclint:" not in text:
        return
    try:
        for tok in tokenize.generate_tokens(io.StringIO(text).readline):
            if tok.type == tokenize.COMMENT and "cclint:" in tok.string:
                yield tok.start[0], tok.string
    except (tokenize.TokenError, IndentationError):
        # un-tokenizable file (the parse already failed louder) — fall
        # back to raw lines so suppressions are not silently dropped
        for lineno, line in enumerate(lines, start=1):
            if "cclint:" in line:
                yield lineno, line


def parse_suppressions(path: str, text: str,
                       known_rules: Set[str]) -> Suppressions:
    """Scan real comments for ``# cclint: disable=...`` directives."""
    by_line: Dict[int, Set[str]] = {}
    malformed: List[Finding] = []
    for lineno, comment in _comment_lines(text, text.splitlines()):
        m = _SUPPRESS_RE.search(comment)
        if m is None:
            malformed.append(Finding(
                path, lineno, BAD_SUPPRESSION,
                "unparseable cclint comment — use "
                "'# cclint: disable=rule-id -- reason'",
            ))
            continue
        ids = {r.strip() for r in m.group(1).split(",") if r.strip()}
        reason = (m.group(2) or "").strip()
        if not reason:
            malformed.append(Finding(
                path, lineno, BAD_SUPPRESSION,
                "suppression without a reason — append ' -- <why this "
                "rule is wrong here>'",
            ))
            continue
        unknown = sorted(ids - known_rules)
        if unknown:
            malformed.append(Finding(
                path, lineno, BAD_SUPPRESSION,
                f"suppression names unknown rule(s) {unknown} — known: "
                f"{sorted(known_rules)}",
            ))
            ids &= known_rules
        if ids:
            by_line.setdefault(lineno, set()).update(ids)
    return Suppressions(by_line=by_line, malformed=malformed)
