"""The port's cclint, lock rules: the same findings as the reference's on
the reference's fixtures, and the two places the port's lock analysis
sees further — a module-level lock imported from another module (the
port's ``DEVICE_LOCK``) and a call into the caller's own nested def —
plus the one lock held across device syncs by design."""

import pytest

from cruise_control_tpu_torch.devtools.lint import run_lint
from cruise_control_tpu_torch.devtools.lint.rules_blocking import (
    HELD_ACROSS_SYNCS,
)
from cruise_control_tpu_torch.devtools.lint.rules_lockorder import (
    build_lock_graph,
)
from torch_cclint_cases import (  # noqa: F401  (the module cache fixture)
    LOCK_RULES,
    _ILOCK_STUB,
    _module_cache,
    assert_parity,
    lint_package,
    materialize_package,
)


@pytest.mark.parametrize("rule_id", LOCK_RULES)
def test_lock_rules_match_the_reference(rule_id, tmp_path):
    assert_parity(rule_id, tmp_path)


def _edges(files, root):
    target = materialize_package(root, files)
    res = run_lint(paths=[str(target)], rules=["lock-order"])
    return [(e["from"], e["to"]) for e in build_lock_graph(res.project)
            ["edges"]]


def test_a_lock_imported_from_another_module_orders(tmp_path):
    """``from pkg.device import LOCK; with LOCK:`` names the lock, as
    ``with m.LOCK:`` does through a module import."""
    for i, use in enumerate(("from pkg.device import LOCK\n", "")):
        held = "LOCK" if use else "device.LOCK"
        files = {
            "pkg/locks.py": _ILOCK_STUB,
            "pkg/device.py": ("from pkg.locks import InstrumentedLock\n"
                              "LOCK = InstrumentedLock('device')\n"),
            "pkg/engine.py": (
                use + "from pkg import device\n"
                "from pkg.locks import InstrumentedLock\n"
                "class Engine:\n"
                "    def __init__(self):\n"
                "        self._lock = InstrumentedLock('engine.state')\n"
                "    def run(self):\n"
                "        with self._lock:\n"
                f"            with {held}:\n"
                "                pass\n"),
        }
        assert _edges(files, tmp_path / str(i)) == [("engine.state",
                                                     "device")]


def test_a_call_into_a_nested_def_carries_the_held_locks(tmp_path):
    files = {
        "pkg/locks.py": _ILOCK_STUB,
        "pkg/svc.py": (
            "from pkg.locks import InstrumentedLock\n"
            "A = InstrumentedLock('svc.outer')\n"
            "B = InstrumentedLock('svc.inner')\n"
            "def serve():\n"
            "    def attempt():\n"
            "        with B:\n"
            "            pass\n"
            "    with A:\n"
            "        attempt()\n"),
    }
    assert _edges(files, tmp_path) == [("svc.outer", "svc.inner")]


_SYNC_UNDER = (
    "import torch\n"
    "from pkg.locks import InstrumentedLock\n"
    "LOCK = InstrumentedLock('{name}')\n"
    "def plan(x):\n"
    "    with LOCK:\n"
    "        torch.cuda.synchronize()\n"
    "        return x.item()\n"
)


def test_the_device_lock_is_held_across_syncs_by_design(tmp_path):
    """A card read under a named lock is a convoy — except under
    ``device``, which serializes whole device programs on purpose."""
    assert set(HELD_ACROSS_SYNCS) == {"device"}
    hot = lint_package({"pkg/locks.py": _ILOCK_STUB,
                        "pkg/svc.py": _SYNC_UNDER.format(name="svc.state")},
                       tmp_path / "hot", "blocking-under-lock")
    assert [(f.line, f.message.split(" while")[0]) for f in hot] == [
        (6, "torch.cuda.synchronize() host sync"),
        (7, ".item() host sync")]
    assert lint_package({"pkg/locks.py": _ILOCK_STUB,
                         "pkg/svc.py": _SYNC_UNDER.format(name="device")},
                        tmp_path / "device", "blocking-under-lock") == []
