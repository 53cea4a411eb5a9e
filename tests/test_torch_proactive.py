"""The port's proactive scheduler, held to the reference: the four
scheduler tests of ``tests/test_whatif.py`` on the port's
:class:`ProactiveScheduler`, the forecast fit against the workload
synthesizer, ``measure_proactive`` against the committed
``WHATIF_r16.json`` block, and the scheduler ``build_app`` wires driven on
a virtual clock to a pre-peak rebalance whose verdict is the what-if
engine's."""

import json
import pathlib

import numpy as np
import pytest

from cruise_control_tpu_torch.whatif.proactive import ProactiveScheduler
from test_whatif import _BREACH, _FINE, _FacadeStub
from torch_bootstrap_cases import PORT, SMALL, booted, feed

REPO = pathlib.Path(__file__).resolve().parent.parent
HOUR_MS = 3_600_000


def _fed_scheduler(cc, period_ms=4 * HOUR_MS, until_ms=30 * 60_000,
                   amplitude=0.5, **kw):
    """The reference test's scheduler: a clean sinusoid sampled every
    minute up to ``until_ms``, peak at period/4."""
    sched = ProactiveScheduler(
        cc, period_ms=period_ms, horizon_ms=2 * HOUR_MS,
        threshold=1.1, cooldown_ms=HOUR_MS, clock=lambda: until_ms, **kw,
    )
    for t in range(0, until_ms + 1, 60_000):
        mult = 1.0 + amplitude * np.sin(2 * np.pi * t / period_ms)
        sched.record(t, 1000.0 * mult)
    return sched


def test_proactive_triggers_before_projected_peak():
    cc = _FacadeStub(_BREACH)
    sched = _fed_scheduler(cc)
    now_ms = 30 * 60_000
    assert sched.maybe_trigger(now_ms)
    assert cc.rebalances == 1
    (future,) = cc.whatif_calls[0]
    assert future.events[0].arg("factor") > 1.1
    assert now_ms < HOUR_MS


def test_proactive_survivable_peak_does_not_trigger():
    cc = _FacadeStub(_FINE)
    sched = _fed_scheduler(cc)
    assert not sched.maybe_trigger(30 * 60_000)
    assert cc.rebalances == 0
    assert sched.state_summary()["lastSkipReason"] == "peak-survivable"


def test_proactive_skips_without_signal():
    cc = _FacadeStub(_BREACH)
    sched = ProactiveScheduler(cc, period_ms=4 * HOUR_MS,
                               clock=lambda: 0.0)
    assert not sched.maybe_trigger(0.0)
    assert sched.state_summary()["lastSkipReason"] == "insufficient-samples"
    flat = _fed_scheduler(cc, amplitude=0.0)
    assert not flat.maybe_trigger(30 * 60_000)
    assert cc.rebalances == 0


def test_proactive_cooldown_suppresses_retrigger():
    cc = _FacadeStub(_BREACH)
    sched = _fed_scheduler(cc)
    assert sched.maybe_trigger(30 * 60_000)
    assert not sched.maybe_trigger(31 * 60_000)
    assert sched.state_summary()["lastSkipReason"] == "cooldown"
    assert cc.rebalances == 1


def test_fit_diurnal_equals_the_reference():
    from cruise_control_tpu.sim.workload import fit_diurnal as ref_fit
    from cruise_control_tpu_torch.sim.workload import (
        diurnal_multiplier,
        fit_diurnal,
    )

    period = 4 * HOUR_MS
    samples = [(t, 100.0 * diurnal_multiplier(t, 0.35, period, 0.0))
               for t in range(0, 2 * HOUR_MS, 5 * 60_000)]
    port, ref = fit_diurnal(samples, period), ref_fit(samples, period)
    assert (port.mean, port.a, port.b, port.amplitude) == \
        (ref.mean, ref.a, ref.b, ref.amplitude)
    assert port.peak_within(0, period) == ref.peak_within(0, period)
    assert fit_diurnal([(0, 1.0)] * 3, 1000) is None


def test_measure_proactive_equals_the_committed_block():
    from cruise_control_tpu_torch.whatif.artifact import measure_proactive

    committed = json.loads((REPO / "WHATIF_r16.json").read_text())
    assert measure_proactive(device="cpu") == committed["proactive"]


def test_build_app_scheduler_triggers_a_pre_peak_rebalance():
    """The scheduler ``build_app`` wires, driven on a virtual clock: a
    diurnal series around the monitor's observed ingress (amplitude 0.6,
    a 2-hour period, sampled each minute up to its trough) projects a
    peak 4x the trough within the hour; the what-if verdict on that
    future equals the engine's on the app's model and breaks a goal, and
    the pre-peak rebalance runs on the cuda engine."""
    from cruise_control_tpu_torch.server.progress import OperationProgress
    from cruise_control_tpu_torch.telemetry import events
    from cruise_control_tpu_torch.whatif import (
        compile_futures,
        evaluate_batch,
        verdicts,
    )

    period, amp = 2 * HOUR_MS, 0.6
    props = {**SMALL, "whatif.proactive.enabled": "true",
             "whatif.proactive.period.ms": str(period),
             "whatif.proactive.horizon.ms": str(HOUR_MS),
             "whatif.proactive.interval.ms": str(24 * HOUR_MS)}
    with booted(PORT, props) as app:
        feed(app)
        cc, sched = app.cruise_control, app.proactive_scheduler
        assert isinstance(sched, ProactiveScheduler)
        assert sched.state_summary()["running"]
        base = cc.load_monitor.observed_total_ingress()
        assert base > 0
        now = 3 * period // 4          # the trough
        for t in range(period // 4, now + 1, 60_000):
            sched.record(t, base * (1.0 + amp * np.sin(2 * np.pi * t
                                                       / period)))
        asked = []
        whatif = cc.whatif

        def spy(futures):
            # the model the what-if sees, before the rebalance moves it
            state = cc._model(None, OperationProgress("WHATIF"))
            asked.append((futures, state, whatif(futures)))
            return asked[-1][2]

        cc.whatif = spy
        journal = events.EventJournal(enabled=True)
        prev, events.JOURNAL = events.JOURNAL, journal
        try:
            assert sched.maybe_trigger(now)
        finally:
            events.JOURNAL = prev
        recs = journal.recent()
        (fc,) = [e["payload"] for e in recs
                 if e["kind"] == "proactive.forecast"]
        (trig,) = [e["payload"] for e in recs
                   if e["kind"] == "proactive.trigger"]
        assert not [e for e in recs if e["kind"] == "proactive.skip"]
        assert fc["peakInMs"] == HOUR_MS
        (futures, state, result), = asked
        assert futures[0].events[0].arg("factor") == pytest.approx(
            (1 + amp) / (1 - amp), rel=1e-3)
        batch = compile_futures(state, futures)
        expect = verdicts(batch, evaluate_batch(
            state, batch, capacity_scale=cc._whatif_capacity_scale(),
            device="cpu"))
        assert result.verdicts == expect
        assert expect[0]["goalViolations"] >= 1
        assert trig["overloadedBrokers"] == expect[0]["overloadedBrokers"]
        ends = [e["payload"] for e in recs if e["kind"] == "optimize.end"]
        assert [e["engine"] for e in ends] == ["cuda"]
