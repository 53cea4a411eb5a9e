"""The port's served telemetry and metric fetchers (copies of the
reference's ``telemetry/{recorder,slo,host_profile}.py`` and
``monitor/{fetcher,prometheus}.py``) against the reference's tests
(``tests/test_observability.py``, ``tests/test_host_profile.py``,
``tests/test_fetcher.py``): the flight recorder's gauge and rate sampling
equal the reference recorder's on the same registry activity; on a booted
app ``GET /diagnostics`` serves the recorder's artifact and ``GET /slo``
the SLO engine's table, ``GET /profile/host`` arms a capture (202) that
the sampler and the SLO tick turn into an artifact (200), and ``GET
/metrics`` renders the host profiler's ``cc_host_*`` families; the
fetchers' round-robin assignor and the Prometheus sampler give the
reference's results."""

import importlib
import time

import pytest

from cruise_control_tpu_torch.monitor.fetcher import (
    MetricFetcherManager,
    MetricSamplerPartitionAssignor,
)
from cruise_control_tpu_torch.monitor.sampling import MetricsReporterSampler
from cruise_control_tpu_torch.tools.served_stack import WINDOW_MS, full_stack

from test_fetcher import EXPO
from torch_bootstrap_cases import PKGS, PORT, SMALL, booted, feed, http


def _recorder_series(pkg: str, retention: int):
    """The reference test's recorder sampling on ``pkg``'s classes, plus
    a meter, then three more samples."""
    metrics = importlib.import_module(f"{pkg}.utils.metrics")
    recorder = importlib.import_module(f"{pkg}.telemetry.recorder")
    reg = metrics.MetricRegistry()
    reg.gauge("depth", lambda: 7.0)
    c = reg.counter("events")
    m = reg.meter("requests")
    rec = recorder.FlightRecorder(reg, interval_s=1.0, retention=retention)
    rec.sample_once(now=1000.0)
    c.inc(30)
    m.mark(5)
    rec.sample_once(now=1010.0)
    for k in range(3):
        rec.sample_once(now=1020.0 + k)
    return rec.series_snapshot()


@pytest.mark.parametrize("retention", [16, 3])
def test_recorder_samples_gauges_and_rates_as_the_reference(retention):
    ref, port = (_recorder_series(pkg, retention) for pkg in PKGS)
    assert port == ref
    rates = port["rate:events"]["points"]
    if retention == 16:
        assert rates[0] == [1010.0, 3.0] and len(rates) == 4
        assert port["rate:requests"]["points"][0] == [1010.0, 0.5]
    else:
        assert [len(s["points"]) for s in port.values()] == [3] * len(port)


@pytest.fixture(scope="module")
def app():
    """One booted app (the port's, on the CPU twins) with its metric
    windows fed and its server started; its recorder, SLO engine and host
    profiler at their defaults."""
    with booted(PORT, SMALL) as a:
        feed(a)
        a.server.start()
        yield a


def test_diagnostics_and_slo_on_a_booted_app(app):
    status, art = http(f"{app.server.url}/diagnostics")
    assert status == 200 and art["schema"] == "cc-tpu-flight-recorder/1"
    assert "hostProfile" in art and "lockContention" in art
    # the device observatories (ROADMAP A10) ride the dump
    assert {"deviceStats", "kernelBudget", "meshBudget"} <= set(art)
    assert "deviceCost" in art["deviceStats"]
    status, slo = http(f"{app.server.url}/slo")
    assert status == 200 and slo["schema"] == "cc-tpu-slo/1"
    assert slo["slos"] and app.slo_engine is not None
    # the observatory is process-wide: none of another test's captures
    from cruise_control_tpu_torch.telemetry import kernel_budget

    kernel_budget.CAPTURE.reset()
    status, body = http(f"{app.server.url}/profile/kernels")
    assert status == 404 and "arm=true" in body["errorMessage"]


def test_profile_host_arms_then_serves_an_artifact(app):
    from cruise_control_tpu_torch.telemetry import host_profile

    url = f"{app.server.url}/profile/host"
    status, body = http(f"{url}?arm=true&samples=3")
    assert status == 202 and body["capture"]["state"] == "ARMED"
    deadline = time.monotonic() + 60
    while True:
        status, art = http(url)
        if status == 200:
            break
        assert status == 202 and time.monotonic() < deadline, status
        # the SLO tick builds the artifact; pump it as the tick would
        host_profile.PROFILER.parse_pending()
        time.sleep(0.05)
    assert art["schema"] == "cc-tpu-host-profile/1"
    assert art["capture"]["reason"] == "http"
    assert art["capture"]["samplesCollected"] == 3 and art["totalSamples"]


def test_metrics_renders_the_host_profiler_families(app):
    import urllib.request

    deadline = time.monotonic() + 30
    while True:
        text = urllib.request.urlopen(
            f"{app.server.url}/metrics").read().decode()
        if "cc_host_samples_total{" in text or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    assert "# TYPE cc_host_samples_total counter" in text
    assert "# TYPE cc_host_stacks gauge" in text
    # the device families (ROADMAP A10) render beside them
    assert "cc_lock_" in text and 'cc_jit_compile_total{fn="all"}' in text


def test_assignor_round_robin_as_the_reference():
    from cruise_control_tpu.monitor.fetcher import (
        MetricSamplerPartitionAssignor as RefAssignor,
    )

    a, r = MetricSamplerPartitionAssignor(), RefAssignor()
    assert a.assign([5, 1, 3, 2, 4, 0], 3) == [{0, 3}, {1, 4}, {2, 5}]
    for universe, n in (([5, 1, 3, 2, 4, 0], 3), ([1, 2], 5),
                        (list(range(97, 0, -3)), 4)):
        assert a.assign(universe, n) == r.assign(universe, n)


def test_fetcher_manager_covers_universe_without_double_count():
    cc, _, reporter = full_stack(num_partitions=12, num_brokers=4,
                                 engine="greedy", device="cpu")
    monitor = cc.load_monitor
    topic = monitor.sampler.topic
    mgr = MetricFetcherManager(
        monitor, sampler_factory=lambda: MetricsReporterSampler(topic),
        num_fetchers=3, sampling_interval_ms=WINDOW_MS)
    reporter.report(time_ms=WINDOW_MS * 10 + 1)
    assert mgr.fetch_once(now_ms=WINDOW_MS * 10 + 2) == 12 + 4
    assert mgr.fetch_once(now_ms=WINDOW_MS * 11) == 0


def _prometheus(pkg: str):
    prom = importlib.import_module(f"{pkg}.monitor.prometheus")
    urls = []

    def fake_get(url):
        urls.append(url)
        return EXPO

    sampler = prom.PrometheusMetricSampler(fake_get,
                                           endpoint="http://x/metrics")
    psamples, bsamples = sampler.get_samples(0, 10_000)
    return urls, [(s.partition, s.time_ms, list(s.values))
                  for s in psamples], [(s.broker_id, s.time_ms, list(s.values))
                                       for s in bsamples]


def test_prometheus_sampler_end_to_end_as_the_reference():
    urls, parts, brokers = _prometheus(PORT)
    assert urls == ["http://x/metrics"]
    assert {p for p, _, _ in parts} == {7, 8} and len(brokers) == 1
    assert (urls, parts, brokers) == _prometheus(PKGS[0])
