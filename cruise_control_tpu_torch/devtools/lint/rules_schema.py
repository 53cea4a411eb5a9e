"""journal-schema — emit sites and the events contract stay closed.

``tests/schemas/artifacts.schema.json`` holds the closed
``cc-tpu-events/1`` record plus an ``x-kinds`` registry: every event
kind the journal may carry, with its payload field vocabulary.  The
schema test validates *live* records — whichever few a test run
happens to produce.  This rule checks the closure STATICALLY, both
directions, over every ``events.emit(...)`` site in the project:

code → schema:

* a literal kind not in ``x-kinds`` is drift (a dashboard reading the
  journal has never heard of it);
* a payload keyword not in the kind's field vocabulary is drift;
* a literal ``severity`` outside the record's enum is drift.

schema → code (only when the whole package was linted — partial runs
cannot prove absence):

* a registered kind no emit site produces is a dead registry entry;
* a registered field no emit site of that kind ever passes is dead
  vocabulary (sites spreading ``**payload`` mark the kind open and
  exempt it).

Dynamic kinds (f-strings) are ``obs-dynamic-name``'s finding, not
ours; non-literal kind arguments are skipped here.  Fixture packages
carry their own ``tests/schemas/artifacts.schema.json`` next to the
package root — the rule resolves the registry by package, so the real
tree and test fixtures check against their own contracts."""

from __future__ import annotations

import json
import pathlib
from typing import Dict, List, Set

from cruise_control_tpu_torch.devtools.lint.findings import Finding
from cruise_control_tpu_torch.devtools.lint.graph import EmitSite

RULE_ID = "journal-schema"

#: emit receivers that mean the event journal (module convenience,
#: journal objects, the process-wide singleton)
_JOURNAL_RECV = {"events", "journal", "JOURNAL"}
#: keyword/positional names that are record envelope, not payload
#: (trace_id rides the common traceId field, like task_id → taskId)
ENVELOPE = {"severity", "operation", "task_id", "trace_id", "kind"}

SCHEMA_RELPATH = pathlib.Path("tests") / "schemas" / "artifacts.schema.json"
EVENTS_SCHEMA = "cc-tpu-events/1"


def is_journal_emit(site: EmitSite) -> bool:
    callee = site.callee
    if callee == "emit":
        return True
    if "." not in callee:
        return False
    recv_tail = callee.split(".")[-2]
    return recv_tail in _JOURNAL_RECV or recv_tail.endswith("_journal")


def load_registry(root: pathlib.Path):
    """(kinds dict, severity enum, schema path, schema text) for a
    package root, or None when the root carries no events contract."""
    path = root / SCHEMA_RELPATH
    if not path.exists():
        return None
    try:
        doc = json.loads(path.read_text())
        events = doc.get(EVENTS_SCHEMA)
        if events is None:
            return None
        kinds = events.get("x-kinds")
        if kinds is None:
            return None
        enum = events.get("properties", {}).get("severity", {}) \
                     .get("enum", [])
        return kinds, set(enum), path, path.read_text()
    except (OSError, ValueError):
        return None


def _anchor_line(text: str, needle: str) -> int:
    q = f'"{needle}"'
    for lineno, line in enumerate(text.splitlines(), start=1):
        if q in line:
            return lineno
    return 1


class JournalSchemaRule:
    id = RULE_ID
    summary = ("events.emit kinds/fields/severities must match the "
               "closed x-kinds registry in artifacts.schema.json — both "
               "directions")
    project_rule = True

    def check_file(self, ctx) -> List[Finding]:
        return []

    def check_project(self, project) -> List[Finding]:
        graph = project.graph
        out: List[Finding] = []
        # group modules by package root so fixture packages resolve
        # their own registry
        by_root: Dict[pathlib.Path, List[str]] = {}
        for mod in graph.modules:
            root = graph.package_roots.get(mod)
            if root is not None:
                by_root.setdefault(root, []).append(mod)
        for root, mods in sorted(by_root.items()):
            reg = load_registry(root)
            if reg is None:
                continue
            kinds, severities, schema_path, schema_text = reg
            emitted: Dict[str, Set[str]] = {}
            open_kinds: Set[str] = set()
            for mod in mods:
                s = graph.modules[mod]
                for site in s.emits:
                    if not is_journal_emit(site) or site.kind is None:
                        continue
                    fields = set(site.fields) - ENVELOPE
                    emitted.setdefault(site.kind, set()).update(fields)
                    if site.star:
                        open_kinds.add(site.kind)
                    if site.kind not in kinds:
                        out.append(Finding(
                            s.path, site.lineno, self.id,
                            f"event kind '{site.kind}' is not registered "
                            "in the x-kinds table of "
                            f"{SCHEMA_RELPATH} — register it (with its "
                            "payload fields) before emitting it",
                        ))
                        continue
                    declared = set(kinds[site.kind].get("fields", ()))
                    extra = sorted(fields - declared)
                    if extra:
                        out.append(Finding(
                            s.path, site.lineno, self.id,
                            f"event '{site.kind}' emits undeclared "
                            f"payload field(s) {extra} — the x-kinds "
                            f"entry in {SCHEMA_RELPATH} lists "
                            f"{sorted(declared)}; extend the registry or "
                            "drop the field",
                        ))
                    if site.severity is not None \
                            and site.severity not in severities:
                        out.append(Finding(
                            s.path, site.lineno, self.id,
                            f"severity {site.severity!r} is outside the "
                            f"schema enum {sorted(severities)}",
                        ))
            # reverse direction: only when the package is fully covered
            if not self._fully_covered(project, root, mods):
                continue
            spath = str(schema_path)
            try:
                spath = str(schema_path.resolve()
                            .relative_to(project.repo_root))
            except ValueError:
                pass
            for kind in sorted(set(kinds) - set(emitted)):
                out.append(Finding(
                    spath, _anchor_line(schema_text, kind), self.id,
                    f"registered event kind '{kind}' is emitted nowhere "
                    "in the package — remove the dead registry entry (or "
                    "the emit site was lost in a refactor)",
                ))
            for kind, spec in sorted(kinds.items()):
                if kind not in emitted or kind in open_kinds:
                    continue
                dead = sorted(set(spec.get("fields", ())) - emitted[kind])
                if dead:
                    out.append(Finding(
                        spath, _anchor_line(schema_text, kind), self.id,
                        f"event '{kind}' declares payload field(s) "
                        f"{dead} no emit site passes — prune the "
                        "registry or restore the field",
                    ))
        return out

    @staticmethod
    def _fully_covered(project, root: pathlib.Path,
                       mods: List[str]) -> bool:
        """True when every .py under the top-level package dir(s) of
        ``mods`` is in this run's linted set."""
        linted = project.linted_abs
        tops = {m.split(".")[0] for m in mods}
        for top in tops:
            pkg_dir = root / top
            if not pkg_dir.is_dir():
                return False
            for p in pkg_dir.rglob("*.py"):
                if p.resolve() not in linted:
                    return False
        return True
