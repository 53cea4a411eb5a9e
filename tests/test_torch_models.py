"""The port's data model against the JAX reference: the seeded generator,
the broker roll-ups, cluster statistics and the pure mutators.

Inputs come from the shared seeded generator; the reference runs on the
CPU as tests/conftest.py forces.  Tolerances: generated arrays and integer
roll-ups must be bit-identical; float roll-ups and statistics agree within
1e-6 relative, since the port sums in another (exact fixed-point) order
than XLA's f32 segment sums."""

import dataclasses

import numpy as np
import pytest
import torch

from cruise_control_tpu.models import cluster_state as ref_cs
from cruise_control_tpu.models import generators as ref_gen
from cruise_control_tpu.models.stats import (
    cluster_stats as ref_cluster_stats,
    stats_summary as ref_stats_summary,
)
from cruise_control_tpu_torch.models import cluster_state as cs
from cruise_control_tpu_torch.models import generators as gen
from cruise_control_tpu_torch.models.convert import cluster_state_from_numpy
from cruise_control_tpu_torch.models.stats import cluster_stats, stats_summary

RTOL = 1e-6

ARRAY_FIELDS = (
    "assignment", "leader_slot", "leader_load", "follower_load",
    "partition_topic", "broker_capacity", "broker_rack", "broker_state",
    "replica_offline",
)

GEN_CASES = [
    (1, {}),
    (2, {"rack_aware": True, "num_racks": 5}),
    (3, {"dead_brokers": 2}),
    (4, {"new_brokers": 3}),
    (5, {"hot_partitions": 20, "hot_factor": 6.0}),
    (6, {"distribution": "EXPONENTIAL"}),
    (7, {"distribution": "LINEAR", "replication_factor": 2}),
    (8, {"dead_brokers": 1, "new_brokers": 1, "rack_aware": True,
         "num_racks": 4}),
]


def _pair(seed, knobs, num_brokers=16, num_partitions=240):
    ref_kw = dict(seed=seed, num_brokers=num_brokers,
                  num_partitions=num_partitions, **knobs)
    kw = dict(ref_kw)
    if "distribution" in knobs:
        ref_kw["distribution"] = ref_gen.Distribution[knobs["distribution"]]
        kw["distribution"] = gen.Distribution[knobs["distribution"]]
    return ref_gen.random_cluster(**ref_kw), gen.random_cluster(**kw)


@pytest.mark.parametrize("seed,knobs", GEN_CASES)
def test_random_cluster_bit_identical(seed, knobs):
    ref, port = _pair(seed, knobs)
    for f in ARRAY_FIELDS:
        a, b = np.asarray(getattr(ref, f)), getattr(port, f).numpy()
        assert a.dtype == b.dtype, f
        assert np.array_equal(a, b), f
    assert port.num_topics == ref.num_topics
    assert isinstance(port.assignment, torch.Tensor)


def test_deterministic_fixtures_identical():
    for name in ("small_deterministic_cluster", "rack_unaware_cluster"):
        ref, port = getattr(ref_gen, name)(), getattr(gen, name)()
        for f in ARRAY_FIELDS:
            assert np.array_equal(np.asarray(getattr(ref, f)),
                                  getattr(port, f).numpy()), (name, f)
        assert port.topic_names == ref.topic_names


ROLLUPS_F = ("broker_load", "broker_leader_load", "broker_potential_nw_out")
ROLLUPS_I = ("broker_replica_count", "broker_leader_count",
             "broker_topic_replica_count", "broker_topic_leader_count",
             "replica_rack")


@pytest.mark.parametrize("seed,knobs", GEN_CASES[:4])
def test_broker_rollups_match_reference(seed, knobs):
    ref, port = _pair(seed, knobs)
    for name in ROLLUPS_F:
        a = np.asarray(getattr(ref_cs, name)(ref))
        b = getattr(cs, name)(port).numpy()
        np.testing.assert_allclose(b, a, rtol=RTOL, err_msg=name)
    for name in ROLLUPS_I:
        a = np.asarray(getattr(ref_cs, name)(ref))
        b = getattr(cs, name)(port).numpy()
        assert np.array_equal(a, b), name
    np.testing.assert_array_equal(
        cs.replica_load(port).numpy(), np.asarray(ref_cs.replica_load(ref)))


def _flatten(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("seed,knobs", GEN_CASES[2:6])
def test_cluster_stats_match_reference(seed, knobs):
    ref, port = _pair(seed, knobs)
    a = _flatten(ref_stats_summary(ref_cluster_stats(ref)))
    b = _flatten(stats_summary(cluster_stats(port)))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=RTOL, atol=1e-6,
                                   err_msg=k)


def test_mutators_exact():
    ref, port = _pair(11, {"dead_brokers": 1})
    P, S = port.assignment.shape
    rng = np.random.default_rng(0)
    for _ in range(20):
        p, s = int(rng.integers(P)), int(rng.integers(S))
        b = int(rng.integers(port.num_brokers))
        ref = ref_cs.apply_move(ref, p, s, b)
        port = cs.apply_move(port, p, s, b)
        q = int(rng.integers(P))
        ref = ref_cs.apply_leadership(ref, q, 1)
        port = cs.apply_leadership(port, q, 1)
        p2 = int(rng.integers(P))
        ref = ref_cs.apply_swap(ref, p, s, p2, 0)
        port = cs.apply_swap(port, p, s, p2, 0)
    ref = ref_cs.set_broker_state(ref, 3, ref_gen.BrokerState.DEAD)
    port = cs.set_broker_state(port, 3, gen.BrokerState.DEAD)
    for f in ("assignment", "leader_slot", "replica_offline", "broker_state"):
        assert np.array_equal(np.asarray(getattr(ref, f)),
                              getattr(port, f).numpy()), f


def test_sanity_check_and_state_api():
    _, port = _pair(12, {"rack_aware": True, "num_racks": 4})
    cs.sanity_check(port)
    bad = port.replace(assignment=port.assignment.clone().fill_(0))
    with pytest.raises(AssertionError):
        cs.sanity_check(bad)
    assert port.to("cpu").assignment.device.type == "cpu"
    assert port.num_partitions == 240 and port.num_brokers == 16
    assert bool(port.broker_alive().all())
    assert torch.equal(port.leader_broker(), port.assignment[:, 0])


def test_cluster_state_from_numpy_round_trip():
    ref, port = _pair(13, {"dead_brokers": 1})
    fields = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
    fields = {k: (np.asarray(v) if hasattr(v, "shape") else v)
              for k, v in fields.items()}
    carried = cluster_state_from_numpy(fields, device="cpu")
    for f in ARRAY_FIELDS:
        assert torch.equal(getattr(carried, f), getattr(port, f)), f
    assert carried.num_topics == port.num_topics
