"""The port's cclint over the port: zero findings, one parse a file and
nothing parsed when the cache is warm, and a wall-clock bound on a cold
pass.

The bound is not the reference's 5 s: that one fails under the test
suite's six workers (13.7 s there).  It is set from this test's cold
pass under the six-worker tier-1 command, measured three times on the
development host (8 CPU cores, no card): 23.3-28.5 s, against 4.8-5.6 s
alone.  60 s is about twice the slowest of the three."""

import pytest

from cruise_control_tpu_torch.devtools.lint import run_lint
from torch_cclint_cases import PORT, _module_cache  # noqa: F401

FILES = sorted(PORT.rglob("*.py"))
#: a file whose text another file already has (the empty ``__init__``s)
#: reuses that file's parse: the cache is keyed by content
DISTINCT = len({f.read_text() for f in FILES})

#: seconds a cold pass over the port may take under the six-worker run
COLD_BOUND_S = 60.0


@pytest.fixture(scope="module")
def cold(tmp_path_factory):
    """One cold pass over the port into a fresh cache store."""
    mp = pytest.MonkeyPatch()
    mp.setenv("CCLINT_CACHE_DIR", str(tmp_path_factory.mktemp("store")))
    try:
        yield run_lint(paths=[str(PORT)])
    finally:
        mp.undo()


def test_the_port_lints_clean(cold):
    assert cold.findings == [], (
        "cclint found new violations in the port — fix them or add a "
        "reviewed suppression with a reason (docs/STATIC_ANALYSIS_TORCH.md):"
        "\n" + "\n".join(f.render() for f in cold.findings))
    assert cold.files_scanned == len(FILES)
    # the whole-program phase and the flow-sensitive lock analysis ran
    assert cold.stats["graphBuildMs"] > 0.0
    assert cold.stats["lockflowMs"] > 0.0


def test_one_parse_a_file_and_none_when_warm(cold):
    assert cold.stats["filesParsed"] == DISTINCT
    assert cold.stats["filesParsed"] + cold.stats["cacheHits"] \
        == cold.files_scanned
    warm = run_lint(paths=[str(PORT)])  # the fixture's store, now warm
    assert warm.stats["filesParsed"] == 0
    assert warm.stats["cacheHits"] >= warm.files_scanned
    assert [f.to_json() for f in warm.findings] == \
        [f.to_json() for f in cold.findings]


def test_a_cold_pass_fits_its_bound(cold):
    assert cold.duration_s < COLD_BOUND_S, (
        f"a cold pass over the port took {cold.duration_s:.2f} s")
