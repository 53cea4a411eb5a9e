"""The port's facade what-if path and ``POST /whatif`` (mirror of
``tests/test_whatif.py``'s facade, precompute and endpoint tests), on the
CPU.  The verdicts the port's facade serves equal the reference facade's
on the same cluster and futures."""

import functools
import importlib
import json

import pytest

from cruise_control_tpu_torch.client.cccli import (
    CruiseControlClient,
    CruiseControlError,
)
from cruise_control_tpu_torch.server import (
    CruiseControlHttpServer,
    UserTaskManager,
)
from cruise_control_tpu_torch.server.progress import OperationProgress
from cruise_control_tpu_torch.tools.served_stack import WINDOW_MS, full_stack
from cruise_control_tpu_torch.whatif.compiler import MIN_BUCKET
from cruise_control_tpu_torch.whatif.futures import (
    FutureSpec,
    broker_loss,
    likely_futures,
)

from harness import full_stack as ref_full_stack

port_stack = functools.partial(full_stack, device="cpu", engine="greedy")


def _futures(pkg):
    F = importlib.import_module(f"{pkg}.whatif.futures")
    return [
        F.FutureSpec(name="b1", events=(F.broker_loss(1),)),
        F.FutureSpec(name="x1.8", events=(F.traffic_scale(1.8),)),
        F.FutureSpec(name="both", events=(F.broker_loss(0),
                                          F.traffic_scale(1.5))),
    ]


def test_verdicts_equal_the_reference_facades():
    cc, _, _ = port_stack()
    ref_cc, _, _ = ref_full_stack()
    got = cc.whatif(_futures("cruise_control_tpu_torch"))
    want = ref_cc.whatif(_futures("cruise_control_tpu"))
    assert got.verdicts == want.verdicts
    assert got.batch_size == want.batch_size
    # the likely-futures set the facade derives itself
    assert cc.whatif().verdicts == ref_cc.whatif().verdicts


def test_whatif_cache_hit_and_invalidate():
    cc, _, _ = port_stack()
    futures = [FutureSpec(name="b1", events=(broker_loss(1),))]
    first = cc.whatif(futures)
    assert not first.cached and first.batch_size == MIN_BUCKET
    again = cc.whatif(futures)
    assert again.cached and again.verdicts == first.verdicts
    cc.invalidate_proposal_cache("test")  # whatif rides the same hook
    third = cc.whatif(futures)
    assert not third.cached


def test_generation_bump_never_serves_stale_verdict():
    cc, _, reporter = port_stack()
    futures = [FutureSpec(name="b1", events=(broker_loss(1),))]
    assert not cc.whatif(futures).cached
    assert cc.whatif(futures).cached
    # a new completed window bumps model_generation: the cached verdict
    # is keyed to the old generation and must MISS, not serve stale
    gen = cc.load_monitor.model_generation()
    reporter.report(time_ms=3 * WINDOW_MS + 500)
    cc.load_monitor.run_sampling_iteration(4 * WINDOW_MS)
    assert cc.load_monitor.model_generation() != gen
    assert not cc.whatif(futures).cached


def test_use_cache_false_bypasses():
    cc, _, _ = port_stack()
    futures = [FutureSpec(name="b2", events=(broker_loss(2),))]
    cc.whatif(futures)
    assert not cc.whatif(futures, use_cache=False).cached


def test_whatif_max_futures_cap():
    cc, _, _ = port_stack()
    cc.whatif_max_futures = 2
    too_many = [
        FutureSpec(name=f"b{b}", events=(broker_loss(b),))
        for b in range(3)
    ]
    with pytest.raises(ValueError, match="whatif.max.futures"):
        cc.whatif(too_many)


def test_precompute_refreshes_stale_future_cache():
    from cruise_control_tpu_torch.analyzer.precompute import (
        ProposalPrecomputingExecutor,
    )

    cc, _, reporter = port_stack()
    cc.whatif_precompute_futures = 4
    daemon = ProposalPrecomputingExecutor(cc, interval_s=3600)
    assert daemon.refresh_once()  # cold: fills plan AND warm futures
    assert cc.proposal_cache_fresh() and cc.whatif_cache_fresh()
    assert cc.whatif_cache_state()["entries"] == 4
    # both fresh → the daemon skips (the steady-state probe)
    assert not daemon.refresh_once()
    # generation bump: BOTH probes go stale, one refresh re-warms both
    reporter.report(time_ms=3 * WINDOW_MS + 500)
    cc.load_monitor.run_sampling_iteration(4 * WINDOW_MS)
    assert not cc.whatif_cache_fresh()
    assert daemon.refresh_once()
    assert cc.whatif_cache_fresh()
    # plan still fresh, ONLY the future set stale: the probe refreshes it
    cc._whatif_cache.invalidate("test")
    assert cc.proposal_cache_fresh() and not cc.whatif_cache_fresh()
    assert daemon.refresh_once()
    assert cc.whatif_cache_fresh()
    # precomputed futures now answer whatif queries as cache hits
    state = cc._model(None, OperationProgress("TEST"))
    assert cc.whatif(likely_futures(state, 4)).cached


def test_precompute_disabled_keeps_old_semantics():
    from cruise_control_tpu_torch.analyzer.precompute import (
        ProposalPrecomputingExecutor,
    )

    cc, _, _ = port_stack()  # whatif_precompute_futures defaults to 0
    daemon = ProposalPrecomputingExecutor(cc, interval_s=3600)
    assert daemon.refresh_once()
    assert cc.whatif_cache_fresh()  # disabled == always fresh
    assert not daemon.refresh_once()
    assert cc.whatif_cache_state()["entries"] == 0


# ---- POST /whatif behind the front-door contract --------------------------------
@pytest.fixture
def server():
    cc, backend, _ = port_stack()
    srv = CruiseControlHttpServer(cc, port=0)
    srv.start()
    yield srv, cc, backend
    srv.stop()


def _client(srv, **kw):
    return CruiseControlClient(srv.url, **kw)


class TestWhatifEndpoint:
    def test_default_futures_long_poll(self, server):
        srv, _, _ = server
        body = _client(srv).post("whatif")
        assert body["numFutures"] >= 1
        assert body["generation"]
        assert not body["cached"]
        for v in body["verdicts"]:
            assert {"future", "survivable", "goalViolations"} <= set(v)

    def test_explicit_futures_and_cache_hit(self, server):
        srv, _, _ = server
        c = _client(srv)
        spec = json.dumps([{
            "name": "lose-b1",
            "events": [{"kind": "kill_broker", "broker": 1}],
        }])
        first = c.post("whatif", futures=spec)
        assert first["numFutures"] == 1 and not first["cached"]
        assert first["verdicts"][0]["future"] == "lose-b1"
        again = c.post("whatif", futures=spec)
        assert again["cached"]
        assert again["verdicts"] == first["verdicts"]

    def test_malformed_futures_is_400(self, server):
        srv, _, _ = server
        for bad in ("not json", "[]",
                    '[{"events": [{"kind": "meteor_strike"}]}]'):
            with pytest.raises(CruiseControlError) as e:
                _client(srv).post("whatif", futures=bad)
            assert e.value.code == 400

    def test_admission_control_429_with_retry_after(self):
        import urllib.error
        import urllib.request

        cc, _, _ = port_stack()
        srv = CruiseControlHttpServer(
            cc, port=0,
            user_task_manager=UserTaskManager(max_active_tasks=0),
        )
        srv.start()
        try:
            req = urllib.request.Request(f"{srv.url}/whatif", method="POST",
                                         data=b"")
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req)
            assert e.value.code == 429
            assert e.value.headers.get("Retry-After") == "2"
        finally:
            srv.stop()
