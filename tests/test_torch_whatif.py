"""The port's what-if engine (``cruise_control_tpu_torch.whatif``) on the
CPU, held against the JAX reference (``cruise_control_tpu.whatif``): the
futures DSL, the compiler, the cache and the engine's JSON verdicts.

Mirrors ``tests/test_whatif.py``'s engine, compiler and cache tests (its
facade and endpoint tests wait for the port's serving stack).  Both
packages build the same seeded cluster; on the CPU the port's verdicts
come from the plain twin of hand kernel K12.  Integer and bool verdict
fields must equal the reference's; ``dataMoveMB`` and
``maxBrokerUtilization`` agree within ``FLOAT_RTOL`` (the reference sums
f32 in XLA's order, the port exactly — see
``tests/test_torch_whatif_kernel.py``)."""

import numpy as np
import pytest
import torch

from cruise_control_tpu import whatif as ref
from cruise_control_tpu.models.generators import random_cluster as ref_random
from cruise_control_tpu.whatif import artifact as ref_artifact
from cruise_control_tpu.whatif import engine as ref_engine
from cruise_control_tpu_torch import whatif as W
from cruise_control_tpu_torch.models.generators import random_cluster
from cruise_control_tpu_torch.whatif import artifact as A
from cruise_control_tpu_torch.whatif.compiler import MIN_BUCKET, bucket_size
from cruise_control_tpu_torch.whatif.engine import verdicts
from cruise_control_tpu_torch.whatif.futures import (
    parse_future,
    parse_futures_param,
)
from test_torch_whatif_kernel import FLOAT_RTOL

SMALL = dict(seed=7, num_brokers=12, num_racks=4, num_partitions=60)
BENCH = dict(seed=42, num_brokers=50, num_racks=10, num_partitions=1000)


def _mixed_futures(mod):
    """One of every DSL kind plus a composition — the equivalence matrix
    (``tests/test_whatif.py``), built with package ``mod``'s DSL."""
    F = mod.FutureSpec
    return [
        F(name="b3", events=(mod.broker_loss(3),)),
        F(name="rack2", events=(mod.rack_loss(2),)),
        F(name="x1.8", events=(mod.traffic_scale(1.8),)),
        F(name="maint", events=(mod.maintenance(4, 5),)),
        F(name="topic0", events=(mod.topic_growth(0, 2.5),)),
        F(name="hot", events=(mod.hot_partitions((0, 1, 2), 3.0),)),
        F(name="compound",
          events=(mod.broker_loss(0), mod.traffic_scale(1.5))),
    ]


def _evaluate(state, batch, **kw):
    return W.evaluate_batch(state, batch, device="cpu", **kw)


def _assert_raw_close(got, want):
    """The raw verdict dicts: same keys, dtypes and shapes; integer and
    bool arrays equal, floats within FLOAT_RTOL."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g, w = got[k], np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if w.dtype == np.float32:
            np.testing.assert_allclose(g, w, rtol=FLOAT_RTOL, err_msg=k)
        else:
            assert np.array_equal(g, w), k


def test_batched_matches_sequential_bit_for_bit():
    state = random_cluster(**SMALL)
    futures = _mixed_futures(W)
    batch = W.compile_futures(state, futures)
    raw = _evaluate(state, batch)
    for i, f in enumerate(futures):
        raw1 = _evaluate(state, W.compile_futures(state, [f]))
        for key in raw:
            assert np.array_equal(raw[key][i], raw1[key][0]), (
                f"future {f.name!r} key {key!r}: batched row differs "
                "from its single-future dispatch")


def test_verdict_semantics():
    state = random_cluster(**SMALL)
    batch = W.compile_futures(state, _mixed_futures(W))
    rows = verdicts(batch, _evaluate(state, batch))
    assert len(rows) == 7  # padding rows dropped
    by_name = {v["future"]: v for v in rows}
    b3 = by_name["b3"]
    assert b3["survivable"] and b3["unavailablePartitions"] == 0
    assert b3["underReplicated"] > 0 and b3["movesRequired"] > 0
    for v in rows:
        assert v["goalViolations"] == (
            v["overloadedBrokers"] + v["rackViolations"])
    assert b3["topActions"]
    assert all(a["from"] >= 0 and a["to"] >= 0 for a in b3["topActions"])
    assert by_name["x1.8"]["movesRequired"] == 0


def test_power_of_two_bucketing():
    assert [bucket_size(n) for n in (1, 8, 9, 16, 17, 64)] == \
        [MIN_BUCKET, 8, 16, 16, 32, 64]
    batch = W.compile_futures(random_cluster(**SMALL), _mixed_futures(W)[:3])
    assert batch.padded_size == MIN_BUCKET
    assert batch.num_futures == 3
    assert list(batch.valid) == [True] * 3 + [False] * (MIN_BUCKET - 3)
    with pytest.raises(ValueError):
        W.compile_futures(random_cluster(**SMALL), [])


def test_fingerprints_equal_the_reference():
    a = W.FutureSpec(name="a", events=(W.broker_loss(1),))
    b = W.FutureSpec(name="renamed", events=(W.broker_loss(1),))
    c = W.FutureSpec(name="a", events=(W.broker_loss(2),))
    assert a.fingerprint() == b.fingerprint()  # names are display-only
    assert a.fingerprint() != c.fingerprint()
    assert parse_future(a.to_json()).fingerprint() == a.fingerprint()
    port, want = _mixed_futures(W), _mixed_futures(ref)
    assert [f.fingerprint() for f in port] == [f.fingerprint() for f in want]
    assert [f.to_json() for f in port] == [f.to_json() for f in want]


def test_likely_futures_equal_the_reference_in_order():
    for kw in (SMALL, BENCH):
        state, rstate = random_cluster(**kw), ref_random(**kw)
        for k in (8, 64):
            ranked = W.likely_futures(state, k=k)
            assert ranked == W.likely_futures(state, k=k)
            assert [(f.name, f.fingerprint()) for f in ranked] == [
                (f.name, f.fingerprint())
                for f in ref.likely_futures(rstate, k=k)]
    assert all(f.events[0].kind == "rack_loss"
               for f in W.likely_futures(random_cluster(**SMALL), k=8)[:4])
    # the request parameter: absent → the likely set; a JSON list parsed
    assert parse_futures_param(None, state, top_k=8) == \
        W.likely_futures(state, 8)
    raw = '[{"name": "b1", "events": [{"kind": "kill_broker", "broker": 1}]}]'
    assert parse_futures_param(raw)[0].fingerprint() == \
        ref.FutureSpec(name="b1", events=(ref.broker_loss(1),)).fingerprint()
    with pytest.raises(ValueError, match="whatif.max.futures"):
        parse_futures_param(raw, max_futures=0)


def test_compile_futures_arrays_equal_the_reference():
    for kw, futures in ((SMALL, None), (BENCH, 64)):
        state, rstate = random_cluster(**kw), ref_random(**kw)
        if futures is None:
            port, want = _mixed_futures(W), _mixed_futures(ref)
        else:
            port = A.artifact_futures(state, futures)
            want = ref_artifact.artifact_futures(rstate, futures)
        pb = W.compile_futures(state, port)
        rb = ref.compile_futures(rstate, want)
        for f in ("dead", "scale", "valid"):
            g, w = getattr(pb, f), getattr(rb, f)
            assert g.dtype == w.dtype and np.array_equal(g, w), f
        assert pb.padded_size == rb.padded_size


def test_whatif_cache_hit_invalidate_and_generation_bump():
    cache = W.WhatifCache(max_entries=2)
    fp = W.FutureSpec(name="b1", events=(W.broker_loss(1),)).fingerprint()
    assert cache.get("g1", fp) is None
    cache.put("g1", fp, {"survivable": True})
    hit = cache.get("g1", fp)
    assert hit == {"survivable": True}
    hit["survivable"] = False                  # callers get copies
    assert cache.get("g1", fp) == {"survivable": True}
    # a generation bump misses: the verdict is keyed to the old one
    assert cache.get("g2", fp) is None
    cache.mark_warm("g1")
    assert cache.fresh_for("g1") and not cache.fresh_for("g2")
    cache.invalidate("test")
    assert cache.get("g1", fp) is None and not cache.fresh_for("g1")
    for i in range(3):                         # FIFO eviction
        cache.put("g1", str(i), {})
    assert cache.get("g1", "0") is None and cache.get("g1", "2") == {}
    summ = cache.state_summary()
    assert (summ["hits"], summ["entries"], summ["lastInvalidated"]) == \
        (3, 2, "test")


@pytest.mark.parametrize("fixture", ["mixed_12b_60p", "artifact_50b_1k"])
def test_verdicts_json_match_the_reference(fixture):
    if fixture == "mixed_12b_60p":
        state, rstate = random_cluster(**SMALL), ref_random(**SMALL)
        port, want = _mixed_futures(W), _mixed_futures(ref)
    else:
        state, rstate = random_cluster(**BENCH), ref_random(**BENCH)
        port = A.artifact_futures(state, 64)
        want = ref_artifact.artifact_futures(rstate, 64)
    pb, rb = W.compile_futures(state, port), ref.compile_futures(rstate, want)
    raw, rraw = _evaluate(state, pb), ref.evaluate_batch(rstate, rb)
    _assert_raw_close(raw, rraw)
    got, exp = verdicts(pb, raw), ref_engine.verdicts(rb, rraw)
    assert len(got) == len(exp) == len(port)
    for g, e in zip(got, exp):
        for k in ("dataMoveMB", "maxBrokerUtilization"):
            assert g.pop(k) == pytest.approx(e.pop(k), rel=FLOAT_RTOL), k
        assert g == e


def test_capacity_scale_matches_the_reference():
    state, rstate = random_cluster(**BENCH), ref_random(**BENCH)
    port = A.artifact_futures(state, 16)
    want = ref_artifact.artifact_futures(rstate, 16)
    cs = (0.4, 0.45, 0.45, 0.5)
    raw = _evaluate(state, W.compile_futures(state, port), capacity_scale=cs)
    rraw = ref.evaluate_batch(rstate, ref.compile_futures(rstate, want),
                              capacity_scale=cs)
    _assert_raw_close(raw, rraw)
    # the scaled bar overloads brokers the raw capacity does not
    assert raw["overloadedBrokers"].sum() > _evaluate(
        state, W.compile_futures(state, port))["overloadedBrokers"].sum()


def test_evaluate_batch_needs_a_card_unless_cpu_is_asked(monkeypatch):
    state = random_cluster(**SMALL)
    batch = W.compile_futures(state, _mixed_futures(W)[:1])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        W.evaluate_batch(state, batch)
    assert _evaluate(state, batch)["survivable"].shape == (MIN_BUCKET,)


def test_measure_batch_on_cpu_and_the_proactive_leg_waits():
    rec = A.measure_batch(num_futures=8, best_of=1, seed=7, num_brokers=12,
                          num_racks=4, num_partitions=60, device="cpu")
    assert (rec["numFutures"], rec["batchSize"], rec["numDispatches"]) == \
        (8, 8, 1)
    assert rec["verdicts"]["survivable"] + rec["verdicts"]["unsurvivable"] \
        == 8
    assert rec["ratio"] > 0 and rec["singlePlanWallS"] > 0
    # the proactive leg runs on the port's simulator (its equality with
    # the committed block: tests/test_torch_proactive.py)
    pro = A.measure_proactive(device="cpu")
    assert pro["scenario"] == "proactive_beats_reactive_peak"
    assert pro["proactive"]["anomalies"] == 0 and pro["leadVirtualMs"] > 0
    art = A.make_artifact(rec, pro, now=0.0)
    assert art["schema"] == "cc-tpu-whatif/1"
    assert art["gates"]["singleDispatch"] and not art["gates"][
        "atLeast64Futures"]
    assert art["gates"]["proactiveNoBreach"]
    assert art["gates"]["proactiveBeatsReactiveHealP99"]
