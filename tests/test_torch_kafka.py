"""The port's Kafka stack (``kafka/*``, copies of the reference's) against
the reference's (``tests/test_kafka_adapter.py``, ``tests/test_envelope.py``),
over the scripted :class:`FakeKafkaWire` (no machine here has
``confluent_kafka``): the whole server boots on the wire and lands a REST
rebalance back on it, a facade on the cuda engine (its plain twins on the
CPU) plans from wire metrics and executes over the wire, several fetchers
each get their own reporter-topic consumer, and the metrics envelope
encodes to the reference's golden bytes."""

import json
import time
import urllib.request

import pytest

from cruise_control_tpu_torch.config.cruise_control_config import (
    ConfigException,
)
from cruise_control_tpu_torch.kafka import (
    FakeKafkaWire,
    KafkaClusterBackend,
    KafkaMetadataClient,
    KafkaMetricsReporter,
    KafkaMetricsReporterSampler,
)
from cruise_control_tpu_torch.kafka.envelope import (
    decode_record,
    encode_record,
)
from cruise_control_tpu_torch.monitor.sampling import (
    CruiseControlMetric,
    RawMetricType,
)

from test_envelope import GOLDEN
from torch_bootstrap_cases import PORT, booted
from cruise_control_tpu.kafka import envelope as ref_envelope

TOPIC = "t0"


def _capacity_file(tmp_path):
    f = tmp_path / "capacity.json"
    f.write_text(json.dumps({"brokerCapacities": [{
        "brokerId": "-1", "capacity": {
            "CPU": "1000", "DISK": "100000",
            "NW_IN": "100000", "NW_OUT": "100000"}}]}))
    return str(f)


def _moved(backend, P, B) -> int:
    return sum(1 for p in range(P)
               if sorted(backend.partition_state(p).replicas)
               != sorted([p % B, (p + 1) % B]))


def test_build_app_boots_on_kafka_stack(tmp_path):
    from cruise_control_tpu_torch.bootstrap import build_app
    from cruise_control_tpu_torch.config.cruise_control_config import (
        CruiseControlConfig,
    )

    P, B = 24, 4
    wire = FakeKafkaWire(
        assignment={(TOPIC, p): [p % B, (p + 1) % B] for p in range(P)},
        broker_racks={b: f"rack_{b % 2}" for b in range(B)},
    )
    # the capacity file is mandatory on Kafka
    with pytest.raises(ConfigException, match="capacity.config.file"):
        build_app(CruiseControlConfig({}), port=0, kafka_wire=wire,
                  device="cpu")
    with booted(PORT, {"capacity.config.file": _capacity_file(tmp_path)},
                kafka_wire=wire) as app:
        assert app.reporter is None
        assert isinstance(app.backend, KafkaClusterBackend)
        assert app.cruise_control.default_engine == "cuda"
        records = []
        for p in range(P):
            records += [
                CruiseControlMetric(RawMetricType.PARTITION_BYTES_IN, 500,
                                    p % B, 200.0 if p % B == 0 else 20.0,
                                    partition=p),
                CruiseControlMetric(RawMetricType.PARTITION_BYTES_OUT, 500,
                                    p % B, 50.0, partition=p),
                CruiseControlMetric(RawMetricType.PARTITION_SIZE, 500,
                                    p % B, 500.0, partition=p),
            ]
        KafkaMetricsReporter(wire).report(records)
        app.cruise_control.load_monitor.run_sampling_iteration(3_600_000)
        app.server.start()
        req = urllib.request.Request(
            app.server.url + "/rebalance?dryrun=false", method="POST")
        tid = urllib.request.urlopen(req).headers["User-Task-ID"]
        for _ in range(240):
            body = json.loads(urllib.request.urlopen(
                app.server.url + "/user_tasks").read())
            mine = [t for t in body["userTasks"] if t["UserTaskId"] == tid]
            if mine and mine[0]["Status"] != "Active":
                break
            time.sleep(0.25)
        assert mine and mine[0]["Status"] == "Completed", mine
        assert _moved(app.backend, P, B) > 0
        assert wire.logs.get("__KafkaCruiseControlPartitionMetricSamples")


def test_end_to_end_rebalance_over_fake_kafka():
    from cruise_control_tpu_torch.common.resources import Resource
    from cruise_control_tpu_torch.executor.executor import (
        Executor,
        ExecutorConfig,
    )
    from cruise_control_tpu_torch.facade import CruiseControl
    from cruise_control_tpu_torch.monitor.capacity import (
        StaticCapacityResolver,
    )
    from cruise_control_tpu_torch.monitor.load_monitor import LoadMonitor

    P, B = 40, 6
    wire = FakeKafkaWire(
        assignment={(TOPIC, p): [p % B, (p + 1) % B] for p in range(P)},
        broker_racks={b: f"rack_{b % 3}" for b in range(B)},
    )
    backend = KafkaClusterBackend(wire)
    reporter = KafkaMetricsReporter(wire)
    window = 3_600_000
    for w in range(3):
        t, records = w * window + 500, []
        for p in range(P):
            rate = 300.0 if p % B in (0, 1) else 20.0
            records += [
                CruiseControlMetric(RawMetricType.PARTITION_BYTES_IN, t,
                                    p % B, rate, partition=p),
                CruiseControlMetric(RawMetricType.PARTITION_BYTES_OUT, t,
                                    p % B, rate / 2, partition=p),
                CruiseControlMetric(RawMetricType.PARTITION_SIZE, t, p % B,
                                    rate * 3, partition=p),
            ]
        records += [CruiseControlMetric(RawMetricType.BROKER_CPU_UTIL, t, b,
                                        30.0) for b in range(B)]
        reporter.report(records)
    monitor = LoadMonitor(
        KafkaMetadataClient(backend), KafkaMetricsReporterSampler(wire),
        capacity_resolver=StaticCapacityResolver({
            Resource.CPU: 1e3, Resource.NW_IN: 1e4, Resource.NW_OUT: 1e4,
            Resource.DISK: 1e6}),
        window_ms=window, num_windows=5,
    )
    for w in range(3):
        monitor.run_sampling_iteration((w + 1) * window)
    cc = CruiseControl(monitor, Executor(backend, ExecutorConfig()),
                       engine="cuda", device="cpu")
    result = cc.rebalance(dryrun=False)
    assert result.engine == "cuda"
    assert result.execution is not None and result.execution.succeeded
    assert _moved(backend, P, B) > 0
    assert backend.ongoing_reassignments() == set()


def test_build_app_kafka_mode_multi_fetcher(tmp_path):
    P, B = 12, 3
    wire = FakeKafkaWire(
        assignment={(TOPIC, p): [p % B, (p + 1) % B] for p in range(P)})
    with booted(PORT, {"capacity.config.file": _capacity_file(tmp_path),
                       "num.metric.fetchers": "3"}, kafka_wire=wire) as app:
        samplers = [f.sampler for f in app.fetcher_manager.fetchers]
        assert len(samplers) == 3 and len({id(s) for s in samplers}) == 3
        assert all(isinstance(s, KafkaMetricsReporterSampler)
                   for s in samplers)
        KafkaMetricsReporter(wire).report([
            CruiseControlMetric(kind, 500, p % B, value, partition=p)
            for kind, value in ((RawMetricType.PARTITION_BYTES_IN, 10.0),
                                (RawMetricType.PARTITION_BYTES_OUT, 5.0),
                                (RawMetricType.PARTITION_SIZE, 50.0))
            for p in range(P)])
        assert app.fetcher_manager.fetch_once(3_600_000) > 0


@pytest.mark.parametrize("case", range(len(GOLDEN)))
def test_envelope_golden_bytes_equal_the_reference(case):
    """The envelope pins upstream's layout: the port encodes each golden
    record to the reference's bytes and decodes them back."""
    ref_record, hexbytes = GOLDEN[case]
    from cruise_control_tpu_torch.kafka.envelope import (
        EnvelopeRecord,
        MetricClassId,
    )

    fields = {f: getattr(ref_record, f)
              for f in ref_record.__dataclass_fields__}
    fields["metric_class"] = MetricClassId[fields["metric_class"].name]
    record = EnvelopeRecord(**fields)
    assert encode_record(record) == ref_envelope.encode_record(ref_record)
    assert encode_record(record).hex() == hexbytes
    decoded = decode_record(bytes.fromhex(hexbytes))
    assert decoded == record
    assert type(decoded.metric_class) is MetricClassId
