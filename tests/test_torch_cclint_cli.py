"""The port's cclint: its CLI, its output formats (validated against the
reference's checked-in schemas, read as they are), its own cache
directory, the suppression contract, and the suppressions checked into
the port, each of which must still be load-bearing."""

import json
import pathlib
import re

from cruise_control_tpu.devtools.lint import driver as ref_driver
from cruise_control_tpu_torch.devtools.lint import (
    BAD_SUPPRESSION,
    RULES,
    parse_suppressions,
    render,
    run_lint,
)
from cruise_control_tpu_torch.devtools.lint import driver
from cruise_control_tpu_torch.devtools.lint.__main__ import main as cclint
from cruise_control_tpu_torch.devtools.lint.rules_lockorder import SCHEMA
from test_artifact_schemas import SCHEMAS, validate
from torch_cclint_cases import (  # noqa: F401  (the module cache fixture)
    PORT,
    SWALLOW,
    _module_cache,
    copy_port,
    materialize_package,
)

_SCHEMAS = pathlib.Path(__file__).parent / "schemas"
LINT_SCHEMAS = json.loads((_SCHEMAS / "lint.schema.json").read_text())
SARIF_SCHEMAS = json.loads((_SCHEMAS / "sarif.schema.json").read_text())


def _bad_file(tmp_path, comment=""):
    tmp_path.mkdir(parents=True, exist_ok=True)
    bad = tmp_path / "bad.py"
    bad.write_text(SWALLOW.format(comment=comment))
    return bad


def test_json_and_sarif_validate_against_the_checked_in_schemas(tmp_path):
    res = run_lint(paths=[str(_bad_file(tmp_path))])
    assert [f.rule for f in res.findings] == ["swallowed-exception"]
    payload = json.loads(render(res, "json"))
    assert payload["schema"] == "cc-tpu-lint/1"
    validate(payload, LINT_SCHEMAS["cc-tpu-lint/1"])
    sarif = json.loads(render(res, "sarif"))
    validate(sarif, SARIF_SCHEMAS["sarif-2.1.0-min"])
    assert {r["id"] for r in sarif["runs"][0]["tool"]["driver"]["rules"]} \
        >= set(RULES)


def test_cli_exit_codes_and_default_target(tmp_path, capsys):
    bad = _bad_file(tmp_path)
    assert cclint([str(bad)]) == 1
    assert cclint([str(bad), "--rule=lock-discipline"]) == 0
    assert cclint([str(bad), "--rule=not-a-rule"]) == 2
    assert cclint(["--list-rules"]) == 0
    capsys.readouterr()
    # no path: the port's package (linted whole by the package test)
    assert driver.default_target() == PORT


def test_cli_writes_the_lock_graph(tmp_path, capsys):
    target = materialize_package(tmp_path / "src", {"pkg/a.py": "x = 1\n"})
    out = tmp_path / "graph.json"
    assert cclint([str(target), "--lock-graph", str(out)]) == 0
    capsys.readouterr()
    graph = json.loads(out.read_text())
    validate(graph, SCHEMAS[SCHEMA], out.name)
    assert graph["edges"] == [] and graph["cycles"] == []


def test_the_cache_directory_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("CCLINT_CACHE_DIR", raising=False)
    monkeypatch.delenv("CCLINT_CACHE", raising=False)
    repo = PORT.parent
    assert driver.cache_dir() == repo / ".cclint_torch_cache"
    assert ref_driver.cache_dir() == repo / ".cclint_cache"
    assert ".cclint_torch_cache/" in (repo / ".gitignore").read_text() \
        .splitlines()
    monkeypatch.setenv("CCLINT_CACHE_DIR", "/nowhere/store")
    assert driver.cache_dir() == pathlib.Path("/nowhere/store")
    monkeypatch.setenv("CCLINT_CACHE", "0")
    assert driver.cache_dir() is None


def test_suppressions_need_a_known_rule_and_a_reason(tmp_path):
    ok = run_lint(paths=[str(_bad_file(
        tmp_path / "a", "  # cclint: disable=swallowed-exception -- fixture"))])
    assert ok.findings == [] and ok.suppressions_used == 1
    for comment in ("  # cclint: disable=swallowed-exception",
                    "  # cclint: disable=swalowed-exception -- typo"):
        res = run_lint(paths=[str(_bad_file(tmp_path / "b", comment))])
        assert {f.rule for f in res.findings} == {"swallowed-exception",
                                                  BAD_SUPPRESSION}


def test_checked_in_suppressions_are_load_bearing(tmp_path):
    """Stripping every suppression in the port re-surfaces each finding
    at its file:line, the whole package linted as one program."""
    marker = re.compile(r"\s*# cclint: disable=[^\n]*")
    target = copy_port(tmp_path)
    expected = []
    for path in sorted(target.rglob("*.py")):
        text = path.read_text()
        supp = parse_suppressions(str(path), text, set(RULES))
        if not supp.by_line:
            continue
        lines = text.splitlines(keepends=True)
        for line_no, rule_ids in supp.by_line.items():
            lines[line_no - 1] = marker.sub("", lines[line_no - 1])
            expected += [(str(path.relative_to(target)), line_no, r)
                         for r in rule_ids]
        path.write_text("".join(lines))
    # the reference's copies' and this port's own reviewed exceptions
    assert len(expected) >= 18
    assert ("telemetry/kernel_budget.py", "lock-discipline") in {
        (rel, rule) for rel, _, rule in expected}
    res = run_lint(paths=[str(target)])
    surfaced = {(str(pathlib.Path(f.path).resolve().relative_to(
        target.resolve())), f.line, f.rule) for f in res.findings
        if pathlib.Path(f.path).is_absolute()}
    stale = [e for e in expected if e not in surfaced]
    assert stale == [], f"suppressions that no longer fire: {stale}"
