"""The port's REST server: basic auth, two-step verification and the
``cccli`` command line (mirror of ``tests/test_server.py``), over real
loopback HTTP, on the CPU."""

import functools
import json

import pytest

from cruise_control_tpu_torch.client.cccli import (
    CruiseControlClient,
    CruiseControlError,
    main as cccli_main,
)
from cruise_control_tpu_torch.server import (
    BasicSecurityProvider,
    CruiseControlHttpServer,
    UserTaskManager,
)
from cruise_control_tpu_torch.tools.served_stack import full_stack

port_stack = functools.partial(full_stack, device="cpu", engine="greedy")


@pytest.fixture
def server():
    cc, backend, _ = port_stack()
    srv = CruiseControlHttpServer(cc, port=0)
    srv.start()
    yield srv, cc, backend
    srv.stop()


@pytest.fixture
def two_step():
    cc, backend, _ = port_stack()
    srv = CruiseControlHttpServer(cc, port=0, two_step_verification=True)
    srv.start()
    yield srv, backend
    srv.stop()


def client_for(srv, **kw) -> CruiseControlClient:
    return CruiseControlClient(srv.url, **kw)


class TestSecurity:
    def test_basic_auth_rejects_and_accepts(self):
        cc, _, _ = port_stack()
        srv = CruiseControlHttpServer(
            cc, port=0,
            security_provider=BasicSecurityProvider({"ccop": "s3cret"}),
        )
        srv.start()
        try:
            with pytest.raises(Exception):
                client_for(srv).get("state")
            body = client_for(srv, user="ccop", password="s3cret").get("state")
            assert body["MonitorState"]
            with pytest.raises(Exception):
                client_for(srv, user="ccop", password="wrong").get("state")
        finally:
            srv.stop()


class TestTwoStepVerification:
    def test_purgatory_flow(self, two_step):
        srv, _ = two_step
        c = client_for(srv)
        body = c.post("rebalance", dryrun="false")
        rid = body["reviewId"]
        assert body["status"] == "PENDING_REVIEW"
        board = c.get("review_board")["requestInfo"]
        assert board and board[0]["EndPoint"] == "rebalance"
        c.post("review", approve=str(rid), reason="lgtm")
        done = c.post("rebalance", dryrun="false", review_id=str(rid))
        assert done["numProposals"] > 0
        # a second execution with the same review id is rejected
        with pytest.raises(CruiseControlError) as e:
            c.post("rebalance", dryrun="false", review_id=str(rid))
        assert e.value.code == 400

    def test_approved_params_cannot_be_smuggled(self, two_step):
        srv, backend = two_step
        c = client_for(srv)
        before = {p: list(st.replicas) for p, st in backend.partitions.items()}
        rid = c.post("rebalance", dryrun="true")["reviewId"]
        c.post("review", approve=str(rid))
        # resubmission tries to flip dryrun=false; the approved request
        # said dryrun=true and that is what must execute
        c.post("rebalance", dryrun="false", review_id=str(rid))
        after = {p: list(st.replicas) for p, st in backend.partitions.items()}
        assert before == after, "approval bypass: cluster was mutated"

    def test_capacity_rejection_preserves_approval(self):
        cc, _, _ = port_stack()
        srv = CruiseControlHttpServer(
            cc, port=0, two_step_verification=True,
            user_task_manager=UserTaskManager(max_active_tasks=0),
        )
        srv.start()
        try:
            c = client_for(srv)
            rid = c.post("rebalance", dryrun="true")["reviewId"]
            c.post("review", approve=str(rid))
            with pytest.raises(CruiseControlError) as e:
                c.post("rebalance", dryrun="true", review_id=str(rid))
            assert e.value.code == 429
            board = c.get("review_board")["requestInfo"]
            assert board[0]["Status"] == "APPROVED", \
                "429 must not consume the approval"
        finally:
            srv.stop()

    def test_discarded_request_cannot_run(self, two_step):
        srv, _ = two_step
        c = client_for(srv)
        rid = c.post("rebalance", dryrun="true")["reviewId"]
        c.post("review", discard=str(rid))
        with pytest.raises(CruiseControlError) as e:
            c.post("rebalance", dryrun="true", review_id=str(rid))
        assert e.value.code == 400


class TestCliMain:
    def test_main_state(self, server, capsys):
        srv, _, _ = server
        rc = cccli_main(["-a", f"http://127.0.0.1:{srv.port}", "state"])
        assert rc == 0
        out = json.loads(capsys.readouterr().out)
        assert out["MonitorState"]["state"] == "RUNNING"

    def test_main_rebalance_defaults_to_dryrun(self, server, capsys):
        srv, _, backend = server
        before = {p: list(st.replicas) for p, st in backend.partitions.items()}
        rc = cccli_main(
            ["-a", f"http://127.0.0.1:{srv.port}", "rebalance"]
        )
        assert rc == 0
        out = json.loads(capsys.readouterr().out)
        assert out["numProposals"] >= 0
        after = {p: list(st.replicas) for p, st in backend.partitions.items()}
        assert before == after, "bare rebalance must be a dry run"

    def test_main_no_dryrun_executes_on_the_cuda_engine(self, server, capsys):
        srv, _, backend = server
        rc = cccli_main(
            ["-a", f"http://127.0.0.1:{srv.port}", "rebalance", "--no-dryrun",
             "--engine", "cuda"]
        )
        assert rc == 0
        assert json.loads(capsys.readouterr().out)["engine"] == "cuda"
        leaders = [st.leader for st in backend.partitions.values()]
        assert leaders.count(0) < len(leaders)

    def test_main_connection_refused_clean_error(self, capsys):
        rc = cccli_main(["-a", "http://127.0.0.1:1", "state"])
        assert rc == 1
        assert "cannot reach" in capsys.readouterr().err

    def test_main_error_exit_code(self, server, capsys):
        srv, _, _ = server
        rc = cccli_main(
            ["-a", f"http://127.0.0.1:{srv.port}", "remove_broker", ""]
        )
        assert rc == 1
