"""The port's REST server: the async ``202 + User-Task-ID`` operations,
backpressure headers and the user-task manager (mirror of
``tests/test_server.py``), over real loopback HTTP with the port's
``cccli`` client, on the CPU.  A greedy plan served over HTTP equals the
reference server's on the same cluster; a cuda plan over HTTP equals the
engine's own plan of the facade's model."""

import functools
import threading
import time

import pytest

from cruise_control_tpu_torch.client.cccli import (
    CruiseControlClient,
    CruiseControlError,
)
from cruise_control_tpu_torch.server import (
    CruiseControlHttpServer,
    UserTaskManager,
)
from cruise_control_tpu_torch.tools.served_stack import full_stack

from harness import full_stack as ref_full_stack

port_stack = functools.partial(full_stack, device="cpu", engine="greedy")


@pytest.fixture
def server():
    cc, backend, _ = port_stack()
    srv = CruiseControlHttpServer(cc, port=0)
    srv.start()
    yield srv, cc, backend
    srv.stop()


def client_for(srv, **kw) -> CruiseControlClient:
    return CruiseControlClient(srv.url, **kw)


def _raw_post(srv, endpoint, **params):
    import urllib.error
    import urllib.parse
    import urllib.request

    url = f"{srv.url}/{endpoint}"
    if params:
        url += "?" + urllib.parse.urlencode(params)
    req = urllib.request.Request(url, method="POST", data=b"")
    try:
        with urllib.request.urlopen(req) as resp:
            return resp.status, dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers)


def _plan_body(body):
    return {k: body[k] for k in ("numProposals", "numActions", "proposals",
                                 "violationsBefore", "violationsAfter",
                                 "engine")}


class TestAsyncProtocol:
    def test_rebalance_long_poll(self, server):
        srv, _, backend = server
        body = client_for(srv).post("rebalance", dryrun="false")
        assert body["numProposals"] > 0
        assert body["execution"]["succeeded"] is True
        assert "UserTaskId" in body
        leaders = [st.leader for st in backend.partitions.values()]
        assert leaders.count(0) < len(leaders)

    def test_dryrun_returns_the_reference_servers_plan(self, server):
        from cruise_control_tpu.server import (
            CruiseControlHttpServer as RefServer,
        )

        srv, _, _ = server
        body = client_for(srv).post("rebalance", dryrun="true",
                                    verbose="true")
        assert body["numProposals"] == len(body["proposals"])
        ref = RefServer(ref_full_stack()[0], port=0)
        ref.start()
        try:
            want = client_for(ref).post("rebalance", dryrun="true",
                                        verbose="true")
        finally:
            ref.stop()
        assert _plan_body(body) == _plan_body(want)

    def test_cuda_plan_over_http_is_the_engines_plan(self):
        from cruise_control_tpu_torch.analyzer.cuda_optimizer import (
            CudaGoalOptimizer,
        )

        cc, _, _ = port_stack(engine="cuda")
        direct = CudaGoalOptimizer(device="cpu").optimize(
            cc.load_monitor.cluster_model())
        srv = CruiseControlHttpServer(cc, port=0)
        srv.start()
        try:
            c = client_for(srv)
            body = c.post("rebalance", dryrun="true", verbose="true")
            cached = c.get("proposals", verbose="true")
        finally:
            srv.stop()
        assert body["engine"] == "cuda"
        assert body["numActions"] == len(direct.actions) > 0
        assert body["violationScoreAfter"] == direct.violation_score_after
        assert _plan_body(cached) == _plan_body(body)

    def test_user_tasks_listing(self, server):
        srv, _, _ = server
        c = client_for(srv)
        done = c.post("rebalance", dryrun="true")
        tasks = c.get("user_tasks")["userTasks"]
        assert any(
            t["UserTaskId"] == done["UserTaskId"]
            and t["Status"] == "Completed"
            for t in tasks
        )

    def test_unknown_task_404(self, server):
        srv, _, _ = server
        with pytest.raises(CruiseControlError) as e:
            client_for(srv).post("rebalance", user_task_id="nope")
        assert e.value.code == 404

    def test_task_id_bound_to_endpoint(self, server):
        srv, _, _ = server
        c = client_for(srv)
        done = c.post("rebalance", dryrun="true")
        with pytest.raises(CruiseControlError) as e:
            c.post("add_broker", user_task_id=done["UserTaskId"])
        assert e.value.code == 400
        assert "belongs to rebalance" in str(e.value)

    def test_broker_operations(self, server):
        srv, _, backend = server
        c = client_for(srv)
        c.post("remove_broker", brokerid="3", dryrun="false")
        assert all(3 not in st.replicas for st in backend.partitions.values())
        c.post("demote_broker", brokerid="0", dryrun="false")
        assert all(st.leader != 0 for st in backend.partitions.values())

    def test_missing_brokerid_400(self, server):
        srv, _, _ = server
        with pytest.raises(CruiseControlError) as e:
            client_for(srv).post("remove_broker", dryrun="true")
        assert e.value.code == 400

    def test_operation_error_reported_500(self, server):
        """An operation that fails reports 500, an unknown engine included:
        the port has no "tpu" engine (its device engine is "cuda")."""
        srv, _, _ = server
        with pytest.raises(CruiseControlError) as e:
            client_for(srv).post("add_broker", brokerid="99", dryrun="true")
        assert e.value.code == 500
        assert "unknown broker" in str(e.value)
        with pytest.raises(CruiseControlError) as e:
            client_for(srv).post("rebalance", dryrun="true", engine="tpu")
        assert e.value.code == 500
        assert "unknown analyzer engine 'tpu'" in str(e.value)


class TestBackpressureHeaders:
    """429/503 responses carry Retry-After so clients back off."""

    def test_429_carries_retry_after(self):
        cc, _, _ = port_stack()
        srv = CruiseControlHttpServer(
            cc, port=0, user_task_manager=UserTaskManager(max_active_tasks=0),
        )
        srv.start()
        try:
            code, headers = _raw_post(srv, "rebalance", dryrun="true")
            assert code == 429
            assert headers.get("Retry-After") == "2"
        finally:
            srv.stop()

    def test_monitor_not_ready_503_carries_retry_after(self):
        cc, _, _ = port_stack(windows=0)  # no valid metric windows yet
        srv = CruiseControlHttpServer(cc, port=0)
        srv.start()
        try:
            code, headers = _raw_post(
                srv, "rebalance", dryrun="true", get_response_timeout_s="10",
            )
            assert code == 503
            assert headers.get("Retry-After") == "30"
        finally:
            srv.stop()


class TestUserTaskManagerShutdown:
    def test_shutdown_cancels_queued_and_joins_bounded(self):
        mgr = UserTaskManager(max_workers=1)
        release = threading.Event()
        running = threading.Event()

        def block(progress):
            running.set()
            release.wait(timeout=30)
            return "done"

        first = mgr.submit("rebalance", block)
        assert running.wait(timeout=5)
        queued = mgr.submit("rebalance", lambda progress: "never runs")
        t0 = time.perf_counter()
        mgr.shutdown(timeout_s=0.5)
        elapsed = time.perf_counter() - t0
        # bounded: the blocked worker must not wedge shutdown
        assert elapsed < 5.0
        # the queued task is terminally cancelled, not eternally ACTIVE
        assert queued.state == "CompletedWithError"
        assert queued.completed_s is not None
        release.set()
        first.future.result(timeout=5)
