"""The port's cclint in situ: each device rule catches a bug planted at a
real site of a copy of the port (the checkout is never edited).  Zero
findings on the clean tree means something only while the rules still
reach the step's call chain, its capture, the upload sites and the
device modules of the live code (the tree itself lints clean:
``tests/test_torch_cclint_package.py``)."""

import pathlib

import pytest

from cruise_control_tpu_torch.devtools.lint import run_lint
from torch_cclint_cases import (  # noqa: F401  (the module cache fixture)
    PLANTS,
    _module_cache,
    copy_port,
)


@pytest.mark.parametrize("case", sorted(PLANTS))
def test_device_rules_catch_planted_bugs_in_situ(case, tmp_path):
    rule_id, rel, anchor, replacement = PLANTS[case]
    target = copy_port(tmp_path, (rel, anchor, replacement))
    found = run_lint(paths=[str(target)], rules=[rule_id]).findings
    planted = (target / rel).read_text()
    line = planted[:planted.index(replacement)].count("\n") + 1
    span = range(line, line + replacement.count("\n") + 1)
    assert [f for f in found
            if pathlib.Path(f.path).resolve() == (target / rel).resolve()
            and f.line in span], (
        f"{rule_id} missed the bug planted in {rel}:\n"
        + "\n".join(f.render() for f in found))
