"""The port's cclint, the five device rules: each keeps the reference's
id and shape and checks its torch analog — each fires on its planted
positive and stays silent on its clean twin — and the captured step the
two hot-path rules start from is the one the search replays."""

import pytest

from cruise_control_tpu.devtools import lint as ref_lint
from cruise_control_tpu_torch.devtools import lint as port_lint
from cruise_control_tpu_torch.devtools.lint import FileContext, run_lint
from cruise_control_tpu_torch.devtools.lint.graph import extract_summary
from cruise_control_tpu_torch.devtools.lint.rules_jax import root_names
from cruise_control_tpu_torch.devtools.lint.rules_xjax import hot_roots
from torch_cclint_cases import (  # noqa: F401  (the module cache fixture)
    DEVICE_RULES,
    HOT_PATH,
    PACKAGE,
    PORT,
    _module_cache,
    lint_package,
)


def test_device_rules_keep_their_ids_and_shapes():
    for rule_id in DEVICE_RULES:
        ref, port = ref_lint.RULES[rule_id], port_lint.RULES[rule_id]
        assert getattr(port, "project_rule", False) \
            == getattr(ref, "project_rule", False), rule_id
    assert set(PACKAGE) | {"jax-hot-path"} == set(DEVICE_RULES)


def test_hot_path_fires_in_the_captured_step_only():
    rule = port_lint.RULES["jax-hot-path"]
    for code in HOT_PATH["positive"]:
        found = rule.check_file(FileContext.parse("fixture.py", code))
        assert found and all(f.rule == "jax-hot-path" for f in found), code
    for code in HOT_PATH["negative"]:
        assert rule.check_file(FileContext.parse("fixture.py", code)) == [], \
            code


@pytest.mark.parametrize("rule_id", sorted(PACKAGE))
def test_device_package_fixtures(rule_id, tmp_path):
    for pol in ("positive", "negative"):
        for i, files in enumerate(PACKAGE[rule_id][pol]):
            found = lint_package(files, tmp_path / f"{pol}{i}", rule_id)
            if pol == "positive":
                assert found and all(f.rule == rule_id for f in found), files
            else:
                assert found == [], [f.render() for f in found]


def test_the_step_is_the_root():
    """``CAPTURED_ROOTS`` names the function a step chunk records, and the
    call graph reaches the step's kernel wrappers from it."""
    path = PORT / "analyzer" / "cuda_optimizer.py"
    ctx = FileContext.parse(str(path), path.read_text())
    assert root_names(ctx.tree) == {"_step"}
    summary = extract_summary(ctx.tree, ctx.all_nodes)
    assert summary.functions["_step"].is_jit
    # the step's call chain lies in analyzer/ and ops/
    res = run_lint(paths=[str(PORT / "analyzer"), str(PORT / "ops")],
                   rules=["jax-transitive"])
    assert res.findings == []
    cg = res.project.callgraph
    mod = "cruise_control_tpu_torch."
    reach = cg.reachable_from(set(hot_roots(cg)))
    for fid in ("analyzer.commit_kernels:commit_batch",
                "analyzer.pool_kernels:pool_tables", "ops.grid:grid_rescore",
                "analyzer.step_kernels:match_batch"):
        assert mod + fid in reach, fid
    # the capture's with-block is a hot context of its own
    chunk = res.project.graph.modules[mod + "analyzer.step_graph"]
    assert chunk.functions["StepChunk.capture"].captured_spans


def test_the_sync_vocabulary():
    """The summaries record the port's host syncs for the transitive
    rule and its blocking ones for blocking-under-lock."""
    code = ("import torch\n"
            "from pkg.telemetry import mesh_budget\n"
            "def f(x, s):\n"
            "    torch.cuda.synchronize()\n"
            "    s.synchronize()\n"
            "    x.item(); x.cpu(); x.numpy(); x.tolist()\n"
            "    return mesh_budget.fetch(x, fn='f')\n")
    ctx = FileContext.parse("fixture.py", code)
    fn = extract_summary(ctx.tree, ctx.all_nodes).functions["f"]
    assert [line for line, _ in fn.sync_ops] == [4, 5, 6, 6, 6, 6, 7]
    assert [(op.lineno, op.desc) for op in fn.blocking_ops] == [
        (4, "torch.cuda.synchronize() host sync"),
        (5, "s.synchronize() host sync"),
        (6, ".item() host sync"),
        (7, "mesh_budget.fetch() host read")]
