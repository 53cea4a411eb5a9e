"""The port's cclint: the copied rules that are not about locks give the
reference's findings on the reference's fixtures; config-key-drift holds
the port's code to the port's registry and its generated table
(``docs/CONFIGURATION_TORCH.md``); journal-schema closes the events
registry over the port in both directions."""

import contextlib
import io
import pathlib

import pytest

from cruise_control_tpu_torch.config import __main__ as config_main
from cruise_control_tpu_torch.config.cruise_control_config import (
    DEFAULT_CONFIG_DEF,
)
from cruise_control_tpu_torch.devtools.lint import run_lint
from cruise_control_tpu_torch.devtools.lint import rules_config as RC
from cruise_control_tpu_torch.devtools.lint.rules_schema import (
    is_journal_emit,
    load_registry,
)
from torch_cclint_cases import (  # noqa: F401  (the module cache fixture)
    COPIED_RULES,
    LOCK_RULES,
    REPO,
    _module_cache,
    assert_parity,
)

OTHER_COPIED = tuple(r for r in COPIED_RULES if r not in LOCK_RULES)


@pytest.mark.parametrize("rule_id", OTHER_COPIED)
def test_copied_rules_match_the_reference(rule_id, tmp_path):
    assert_parity(rule_id, tmp_path)


def test_config_rule_reads_the_ports_registry_and_table():
    defined = RC.defined_keys()
    assert defined == set(DEFAULT_CONFIG_DEF.keys())
    assert "cuda.search.cohort.mode" in defined
    assert not any(k.startswith("tpu.") for k in defined)
    assert RC.doc_path() == REPO / "docs" / "CONFIGURATION_TORCH.md"
    # the table is the generator's output, as committed
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        config_main.main()
    assert RC.doc_path().read_text() == out.getvalue()
    assert set(RC.doc_keys(out.getvalue())) == defined


def test_config_rule_flags_a_key_the_port_does_not_define(tmp_path):
    mod = tmp_path / "uses_keys.py"
    mod.write_text("def f(cfg):\n"
                   "    a = cfg.get_int('cuda.search.cohort.mode')\n"
                   "    return a, cfg.get_int('tpu.search.cohort.mode')\n")
    found = run_lint(paths=[str(mod)], rules=["config-key-drift"]).findings
    assert [(f.line, f.rule) for f in found] == [(3, "config-key-drift")]
    assert "'tpu.search.cohort.mode' is not defined" in found[0].message


def test_journal_schema_closes_over_the_port():
    """Every registered event kind is emitted somewhere in the port and
    every emitted kind is registered, so the schema→code direction has
    nothing to excuse."""
    res = run_lint(rules=["journal-schema"])
    assert res.findings == []
    kinds = load_registry(REPO)[0]
    emitted = {site.kind for s in res.project.graph.modules.values()
               for site in s.emits
               if is_journal_emit(site) and site.kind is not None}
    assert emitted == set(kinds)
    assert pathlib.Path(res.project.repo_root) == REPO
