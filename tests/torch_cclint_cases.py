"""Shared cases of the port's cclint tests (``tests/test_torch_cclint_*.py``).

The reference's fixtures (``tests/test_cclint.py``) run through both
linters for every rule the port keeps as a copy; the five device rules,
which check their torch analogs, have their own fixtures here, each a
planted positive beside a clean twin."""

import pathlib

import pytest

from cruise_control_tpu.devtools import lint as ref_lint
from cruise_control_tpu.devtools.lint import FileContext as RefFileContext
from cruise_control_tpu_torch.devtools import lint as port_lint
from cruise_control_tpu_torch.devtools.lint import FileContext
from test_cclint import (  # noqa: F401  (re-exported to the test files)
    PACKAGE_FIXTURES,
    RULE_FIXTURES,
    SWALLOW,
    _ILOCK_STUB,
    materialize_package,
)

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "cruise_control_tpu_torch"

#: the device rules, whose port checks torch in place of jax
DEVICE_RULES = ("jax-hot-path", "jax-transitive", "transfer-discipline",
                "profiler-discipline", "sharding-discipline")
#: rules whose port keeps the reference's logic: the same findings on the
#: same fixtures (config-key-drift reads the port's registry and has its
#: own tests)
COPIED_RULES = tuple(sorted(set(port_lint.RULES) - set(DEVICE_RULES)
                            - {"config-key-drift"}))
LOCK_RULES = ("lock-discipline", "cross-module-lock", "lock-order",
              "blocking-under-lock", "lock-release-safety",
              "lock-instrumentation-discipline")


@pytest.fixture(autouse=True, scope="module")
def _module_cache(tmp_path_factory):
    """One cache store a test module, in a temporary directory: the
    module's lints after its first run warm, and nothing lands in the
    checkout's ``.cclint_torch_cache/``."""
    mp = pytest.MonkeyPatch()
    mp.setenv("CCLINT_CACHE_DIR",
              str(tmp_path_factory.mktemp("cclint_torch_cache")))
    yield
    mp.undo()


def _rel(path, root):
    p = pathlib.Path(path)
    return str(p.relative_to(root)) if p.is_absolute() else path


def file_findings(rule_id, code):
    """(reference, port) findings of a per-file rule on one snippet."""
    ref = ref_lint.RULES[rule_id].check_file(
        RefFileContext.parse("fixture.py", code))
    port = port_lint.RULES[rule_id].check_file(
        FileContext.parse("fixture.py", code))
    return ([(f.rule, f.line, f.message) for f in ref],
            [(f.rule, f.line, f.message) for f in port])


def package_findings(rule_id, files, root):
    """(reference, port) findings of one rule on a fixture package
    written under ``root``: (rule, path relative to root, line,
    message)."""
    target = materialize_package(root, files)
    out = []
    for lint in (ref_lint, port_lint):
        res = lint.run_lint(paths=[str(target)], rules=[rule_id])
        out.append([(f.rule, _rel(f.path, root), f.line, f.message)
                    for f in res.findings])
    return tuple(out)


def assert_parity(rule_id, tmp_path):
    """Every reference fixture of ``rule_id`` (positive and negative)
    gives the port's linter the reference's findings."""
    cases = RULE_FIXTURES.get(rule_id) \
        if rule_id not in PACKAGE_FIXTURES else None
    fired = False
    if cases is not None:
        for pol in ("positive", "negative"):
            for code in cases[pol]:
                ref, port = file_findings(rule_id, code)
                assert port == ref, (rule_id, pol, code)
                fired |= bool(ref)
    else:
        for pol in ("positive", "negative"):
            for i, files in enumerate(PACKAGE_FIXTURES[rule_id][pol]):
                ref, port = package_findings(rule_id, files,
                                             tmp_path / f"{pol}{i}")
                assert port == ref, (rule_id, pol, i)
                fired |= bool(ref)
    assert fired, f"{rule_id}: no reference fixture fired"


def lint_package(files, root, rule_id):
    target = materialize_package(root, files)
    return port_lint.run_lint(paths=[str(target)], rules=[rule_id]).findings


# ---- the five device rules: a planted positive and its clean twin --------------
CAPTURE_SYNC = (
    "import torch\n"
    "def capture(graph, step, x: torch.Tensor):\n"
    "    with torch.cuda.graph(graph):\n"
    "        step()\n"
    "        n = x.sum().item()\n"
    "    return n\n"
)
CAPTURE_SYNC_TWIN = (
    "import torch\n"
    "def capture(graph, step, x: torch.Tensor):\n"
    "    with torch.cuda.graph(graph):\n"
    "        step()\n"
    "    return x.sum().item()\n"
)

#: per-file: jax-hot-path
HOT_PATH = {
    "positive": [
        CAPTURE_SYNC,
        # the capture through an alias, a wait for the card
        "from torch.cuda import graph as cuda_graph\n"
        "import torch\n"
        "def capture(g, step):\n"
        "    with cuda_graph(g):\n"
        "        step()\n"
        "        torch.cuda.synchronize()\n",
        # a root the module names branches on a tensor parameter
        "import torch\n"
        "CAPTURED_ROOTS = ('_step',)\n"
        "def _step(lp, flags: torch.Tensor):\n"
        "    if flags.any():\n"
        "        lp.go()\n",
        # ... or reads one on the host
        "import torch\n"
        "CAPTURED_ROOTS = ('_step',)\n"
        "def _step(lp, n: torch.Tensor):\n"
        "    return lp.go(int(n))\n",
    ],
    "negative": [
        CAPTURE_SYNC_TWIN,
        # host flags and None tests are no tensor data
        "import torch\n"
        "CAPTURED_ROOTS = ('_step',)\n"
        "def _step(lp, checked: bool, cap: torch.Tensor = None):\n"
        "    if checked and cap is None:\n"
        "        lp.go()\n",
        # the same function, not a root: the host loop
        "import torch\n"
        "def _step(lp, flags: torch.Tensor):\n"
        "    if flags.any():\n"
        "        lp.go(flags.item())\n",
    ],
}

_ENGINE_ROOT = (
    "from pkg.helpers import score\n"
    "CAPTURED_ROOTS = ('_step',)\n"
    "def _step(lp):\n"
    "    return score(lp.x)\n"
)
_ENGINE_HOST = (
    "from pkg.helpers import score\n"
    "CAPTURED_ROOTS = ('_step',)\n"
    "def _step(lp):\n"
    "    return lp.x + 1\n"
    "def drive(lp):\n"
    "    return score(_step(lp))\n"
)
_HELPER_SYNC = "def score(x):\n    return x.sum().item()\n"
_KEYED = (
    "import dataclasses\n"
    "CAPTURED_ROOTS = ('_step',)\n"
    "def _step(cfg, x):\n"
    "    return x * {read}\n"
    "def search(cfg, x):\n"
    "    key = (x.shape, dataclasses.replace(cfg, time_budget_s=0.0))\n"
    "    for _ in range(3):\n"
    "        _step(cfg, x)\n"
    "    return key, cfg.time_budget_s\n"
)

#: package rules: jax-transitive, profiler-, transfer- and
#: sharding-discipline
PACKAGE = {
    "jax-transitive": {
        "positive": [
            # a sync one call away from the step
            {"pkg/helpers.py": _HELPER_SYNC, "pkg/engine.py": _ENGINE_ROOT},
            # a field the loop's key normalizes out, read in the step
            {"pkg/engine.py": _KEYED.format(read="cfg.time_budget_s")},
            # a sync one call away from a torch.cuda.graph block
            {"pkg/helpers.py": _HELPER_SYNC,
             "pkg/capture.py": (
                 "import torch\n"
                 "from pkg.helpers import score\n"
                 "def capture(g, x):\n"
                 "    with torch.cuda.graph(g):\n"
                 "        score(x)\n")},
        ],
        "negative": [
            {"pkg/helpers.py": _HELPER_SYNC, "pkg/engine.py": _ENGINE_HOST},
            {"pkg/engine.py": _KEYED.format(read="cfg.improvement_tol")},
        ],
    },
    "profiler-discipline": {
        "positive": [
            {"pkg/analyzer/search.py": (
                "import torch\n"
                "def run(fn):\n"
                "    with torch.profiler.profile() as prof:\n"
                "        fn()\n"
                "    return prof\n")},
            {"pkg/tools/bench.py": (
                "from torch.profiler import profile\n"
                "import torch.cuda.profiler as cp\n"
                "def run(fn):\n"
                "    cp.start()\n"
                "    with profile():\n"
                "        fn()\n"
                "    cp.stop()\n")},
        ],
        "negative": [
            # the one entry point may open the session
            {"pkg/telemetry/kernel_budget.py": (
                "import torch\n"
                "def profiler_session():\n"
                "    return torch.profiler.profile()\n")},
            # helpers that open no session
            {"pkg/analyzer/search.py": (
                "import torch\n"
                "def run(fn):\n"
                "    with torch.profiler.record_function('search'):\n"
                "        fn()\n")},
        ],
    },
    "transfer-discipline": {
        "positive": [
            {"pkg/analyzer/read.py": (
                "import torch\n"
                "def pull(x: torch.Tensor):\n"
                "    return x.cpu()\n")},
            {"pkg/whatif/up.py": (
                "import torch\n"
                "def up(a, b, device):\n"
                "    return torch.as_tensor(a, device=device), b.to(device)\n")},
        ],
        "negative": [
            # the kernel layer moves bytes raw
            {"pkg/ops/read.py": (
                "import torch\n"
                "def pull(x: torch.Tensor):\n"
                "    return x.cpu()\n")},
            # through the ledger, dtype casts, host data
            {"pkg/telemetry/__init__.py": "",
             "pkg/telemetry/mesh_budget.py": (
                 "def fetch(x, fn=''):\n    return x\n"),
             "pkg/analyzer/read.py": (
                 "import torch\n"
                 "from pkg.telemetry import mesh_budget\n"
                 "def pull(x: torch.Tensor, rows):\n"
                 "    y = x.to(torch.float32)\n"
                 "    return mesh_budget.fetch(y, fn='read'), rows.tolist()\n"
             )},
        ],
    },
    "sharding-discipline": {
        "positive": [
            {"pkg/ops/pools.py": (
                "import torch\n"
                "def make(n):\n"
                "    return torch.zeros(n)\n")},
            {"pkg/analyzer/score_kernel.py": (
                "from torch import arange\n"
                "def make(n):\n"
                "    return arange(n, device=None)\n")},
        ],
        "negative": [
            {"pkg/ops/pools.py": (
                "import torch\n"
                "def make(n, x):\n"
                "    return torch.zeros(n, device=x.device), "
                "torch.zeros_like(x)\n")},
            # outside the device modules
            {"pkg/monitor/sampling.py": (
                "import torch\n"
                "def make(n):\n"
                "    return torch.zeros(n)\n")},
        ],
    },
}

#: in-situ plants into a copy of the port: rule → (path in the package,
#: anchor, replacement)
PLANTS = {
    "capture-sync": (
        "jax-hot-path", "analyzer/step_graph.py",
        "            for _ in range(self.n):\n"
        "                self.step(True)\n",
        "            for _ in range(self.n):\n"
        "                self.step(True)\n"
        "                torch.cuda.synchronize()\n",
    ),
    "sync-under-step": (
        "jax-transitive", "analyzer/cuda_optimizer.py",
        "    ws = pb.select_ws\n",
        "    ws = pb.select_ws\n"
        "    state.sum().item()\n",
    ),
    "budget-read-in-step": (
        "jax-transitive", "analyzer/cuda_optimizer.py",
        "    m, cfg, ca, pb = lp.m, lp.cfg, lp.ca, lp.pools\n",
        "    m, cfg, ca, pb = lp.m, lp.cfg, lp.ca, lp.pools\n"
        "    budget = cfg.time_budget_s\n",
    ),
    "raw-profiler": (
        "profiler-discipline", "analyzer/cuda_optimizer.py",
        "        with DEVICE_LOCK, kernel_budget.CAPTURE.search_scope(",
        "        torch.profiler.profile()\n"
        "        with DEVICE_LOCK, kernel_budget.CAPTURE.search_scope(",
    ),
    "raw-read-back": (
        "transfer-discipline", "analyzer/step_graph.py",
        "    def replay(self) -> None:\n",
        "    def read(self, x: torch.Tensor):\n"
        "        return x.cpu()\n\n"
        "    def replay(self) -> None:\n",
    ),
    "unplaced-factory": (
        "sharding-discipline", "ops/kernels.py",
        "def on_cpu(x: torch.Tensor) -> bool:\n",
        "def _scratch(n: int) -> torch.Tensor:\n"
        "    return torch.zeros(n)\n\n\n"
        "def on_cpu(x: torch.Tensor) -> bool:\n",
    ),
}


def copy_port(dst: pathlib.Path, plant=None) -> pathlib.Path:
    """The port's ``*.py`` files under ``dst/cruise_control_tpu_torch``
    (the package name kept, so absolute imports resolve), with one
    ``plant`` = (path, anchor, replacement) applied."""
    target = dst / "cruise_control_tpu_torch"
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT)
        out = target / rel
        out.parent.mkdir(parents=True, exist_ok=True)
        text = path.read_text()
        if plant is not None and str(rel) == plant[0]:
            assert plant[1] in text, f"anchor vanished from {rel}"
            text = text.replace(plant[1], plant[2], 1)
        out.write_text(text)
    return target
