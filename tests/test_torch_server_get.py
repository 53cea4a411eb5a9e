"""The port's REST server: GET and sync POST endpoints over real loopback
HTTP, driven by the port's ``cccli`` client (mirror of
``tests/test_server.py``), on the CPU.  Where the reference's server
answers the same request over the same cluster, the port's body is held
to it."""

import functools
import urllib.request

import pytest

from cruise_control_tpu_torch.client.cccli import (
    CruiseControlClient,
    CruiseControlError,
)
from cruise_control_tpu_torch.server import CruiseControlHttpServer
from cruise_control_tpu_torch.tools.served_stack import full_stack

from harness import full_stack as ref_full_stack

port_stack = functools.partial(full_stack, device="cpu")


@pytest.fixture
def server():
    cc, backend, _ = port_stack()
    srv = CruiseControlHttpServer(cc, port=0)
    srv.start()
    yield srv, cc, backend
    srv.stop()


@pytest.fixture
def ref_server():
    from cruise_control_tpu.server import (
        CruiseControlHttpServer as RefServer,
    )

    cc, _, _ = ref_full_stack()
    srv = RefServer(cc, port=0)
    srv.start()
    yield srv
    srv.stop()


def client_for(srv, **kw) -> CruiseControlClient:
    return CruiseControlClient(srv.url, **kw)


class TestGetEndpoints:
    def test_state(self, server):
        srv, _, _ = server
        body = client_for(srv).get("state")
        assert body["MonitorState"]["state"] == "RUNNING"
        assert body["ExecutorState"]["state"] == "NO_TASK_IN_PROGRESS"
        assert body["AnalyzerState"]["engine"] == "cuda"  # the default

    def test_load(self, server, ref_server):
        srv, _, _ = server
        body = client_for(srv).get("load")
        assert len(body["brokers"]) == 4
        assert all("DiskMB" in b for b in body["brokers"])
        # the port's broker loads are exact fixed-point sums, the
        # reference's f32 sums: equal to f32 rounding (ROADMAP §C)
        want = client_for(ref_server).get("load")["brokers"]
        for got, ref in zip(body["brokers"], want):
            assert got == pytest.approx(ref, rel=1e-6)

    def test_partition_load_sorted(self, server, ref_server):
        srv, _, _ = server
        body = client_for(srv).get("partition_load", resource="NW_IN",
                                   entries=5)
        recs = body["records"]
        assert len(recs) == 5
        vals = [r["networkInbound"] for r in recs]
        assert vals == sorted(vals, reverse=True)
        assert body == client_for(ref_server).get(
            "partition_load", resource="NW_IN", entries=5)

    def test_kafka_cluster_state(self, server):
        srv, _, backend = server
        body = client_for(srv).get("kafka_cluster_state")
        parts = body["KafkaPartitionState"]["partitions"]
        assert len(parts) == len(backend.partitions)

    def test_unknown_endpoint_404(self, server):
        srv, _, _ = server
        with pytest.raises(CruiseControlError) as e:
            client_for(srv).get("nonsense")
        assert e.value.code == 404

    def test_unported_observatories_answer_503(self, server):
        """The kernel and mesh observatories are ported (ROADMAP A10):
        before their first capture they answer 404 naming the arming
        request, and 503 while disabled, as the reference's do; so does
        the host observatory."""
        from cruise_control_tpu_torch.telemetry import kernel_budget as kb
        from cruise_control_tpu_torch.telemetry import mesh_budget as mb

        srv, _, _ = server
        # the observatories are process-wide: none of another test's
        kb.CAPTURE.reset()
        mb.MESH.reset()
        for endpoint in ("profile/kernels", "profile/mesh"):
            with pytest.raises(CruiseControlError) as e:
                client_for(srv).get(endpoint)
            assert e.value.code == 404
            assert f"GET /{endpoint}?arm=true" in str(e.value)
        kb.configure(enabled=False)
        try:
            for endpoint in ("profile/kernels", "profile/mesh"):
                with pytest.raises(CruiseControlError) as e:
                    client_for(srv).get(endpoint)
                assert e.value.code == 503
                assert "telemetry.kernel.enabled" in str(e.value)
        finally:
            kb.configure(enabled=True)
        with pytest.raises(CruiseControlError) as e:
            client_for(srv).get("profile/host")
        assert e.value.code == 404
        assert "GET /profile/host?arm=true" in str(e.value)
        # the registry still renders
        with urllib.request.urlopen(f"{srv.url}/metrics") as resp:
            assert resp.status == 200
            assert b"# TYPE cc_" in resp.read()


class TestSyncEndpoints:
    def test_pause_resume_sampling(self, server):
        srv, cc, _ = server
        c = client_for(srv)
        c.post("pause_sampling")
        assert cc.state()["MonitorState"]["state"] == "PAUSED"
        c.post("resume_sampling")
        assert cc.state()["MonitorState"]["state"] == "RUNNING"

    def test_stop_proposal_execution(self, server):
        srv, _, _ = server
        assert "stop" in client_for(srv).post(
            "stop_proposal_execution")["message"]

    def test_admin_concurrency(self, server):
        srv, cc, _ = server
        client_for(srv).post(
            "admin", concurrent_partition_movements_per_broker="9"
        )
        assert (cc.executor.config.
                num_concurrent_partition_movements_per_broker == 9)

    def test_train(self, server, ref_server):
        srv, _, _ = server
        body = client_for(srv).post("train")
        assert body["trained"] is True
        assert 0.0 <= body["cpuWeightBytesIn"] <= 1.0
        assert body == client_for(ref_server).post("train")

    def test_rightsize(self, server, ref_server):
        srv, _, _ = server
        body = client_for(srv).post("rightsize")
        assert body["status"] in (
            "RIGHT_SIZED", "UNDER_PROVISIONED", "OVER_PROVISIONED"
        )
        assert "UserTaskId" in body
        want = client_for(ref_server).post("rightsize")
        assert {k: v for k, v in body.items() if k != "UserTaskId"} == \
            {k: v for k, v in want.items() if k != "UserTaskId"}

    def test_topic_configuration(self):
        cc, backend, _ = port_stack(rf=1)
        srv = CruiseControlHttpServer(cc, port=0)
        srv.start()
        try:
            body = client_for(srv).post(
                "topic_configuration", replication_factor="2",
                dryrun="false",
            )
            assert body["numProposals"] > 0
            assert all(
                len(set(st.replicas)) >= 2
                for st in backend.partitions.values()
            )
        finally:
            srv.stop()
