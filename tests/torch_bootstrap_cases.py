"""Shared set-up of the port's bootstrap mirrors (``tests/test_config.py``,
``tests/test_security_bootstrap.py``, ``tests/test_kafka_adapter.py``,
the telemetry tests): one properties dict in the reference's key names,
translated to the port's (:func:`port_props`); an app built on either
package's ``bootstrap.build_app`` — the port's on the CPU twins — and shut
down with the process-wide telemetry switches it turned on put back
(:func:`booted`); metric windows fed as the reference's bootstrap test
feeds them (:func:`feed`)."""

import contextlib
import importlib
import json
import urllib.error
import urllib.request

PKGS = ("cruise_control_tpu", "cruise_control_tpu_torch")
REF, PORT = PKGS

#: the reference's engine key names and the port's
ENGINE_KEYS = {"use.tpu.optimizer": "use.cuda.optimizer",
               "tpu.mesh.devices": "cuda.mesh.devices"}
#: the reference's keys the port drops: XLA's compilation cache, and the
#: TPU's approximate top-k (the port ranks the move grid exactly)
DROPPED = ("tpu.persistent.compilation.cache.dir", "tpu.search.topk.mode")

#: a small simulated cluster with 1 s metric windows
SMALL = {
    "simulation.num.brokers": 6,
    "simulation.num.partitions": 24,
    "metric.sampling.interval.ms": 1000,
    "partition.metrics.window.ms": 1000,
}


def port_key(key: str) -> str:
    """The port's name for a reference key."""
    if key.startswith("tpu.search."):
        return "cuda." + key[len("tpu."):]
    return ENGINE_KEYS.get(key, key)


def port_props(props: dict) -> dict:
    """Reference properties in the port's key names, class paths
    retargeted to the port's package."""
    return {port_key(k): (v.replace(f"{REF}.", f"{PORT}.")
                          if isinstance(v, str) else v)
            for k, v in props.items()}


def module(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def config(pkg: str, props: dict):
    cfg = module(pkg, "config.cruise_control_config").CruiseControlConfig
    return cfg(port_props(props) if pkg == PORT else props)


def _telemetry(pkg: str):
    tel = {n: module(pkg, f"telemetry.{n}")
           for n in ("tracing", "events", "trace", "host_profile")}
    return [(tel["tracing"].TELEMETRY, "enabled"),
            (tel["events"].JOURNAL, "enabled"),
            (tel["trace"].STORE, "enabled"),
            (tel["host_profile"].PROFILER, "enabled")], tel["host_profile"]


@contextlib.contextmanager
def booted(pkg: str, props: dict, **kw):
    """``bootstrap.build_app`` of ``pkg`` on ``props`` (reference key
    names; port=0, the port's on ``device="cpu"``), shut down on exit, the
    host profiler's sampler stopped and its captures dropped, and the
    tracing, journal, trace-store and host-profiler switches put back as
    they were."""
    switches, host_profile = _telemetry(pkg)
    saved = [getattr(obj, attr) for obj, attr in switches]
    if pkg == PORT:
        kw.setdefault("device", "cpu")
    app = module(pkg, "bootstrap").build_app(config(pkg, props), port=0,
                                             **kw)
    try:
        yield app
    finally:
        app.shutdown()
        host_profile.PROFILER.stop()
        host_profile.PROFILER.reset()
        for (obj, attr), value in zip(switches, saved):
            setattr(obj, attr, value)


def feed(app, windows: int = 3, window_ms: int = 1000) -> int:
    """Report ``windows`` metric windows from the simulated brokers and
    fetch them once, as the reference's bootstrap test does."""
    for w in range(windows):
        app.reporter.report(time_ms=w * window_ms + 500)
    return app.fetcher_manager.fetch_once(now_ms=(windows + 1) * window_ms)


def http(url: str, method: str = "GET"):
    """(status, JSON body) of one request; error statuses included."""
    req = urllib.request.Request(url, method=method)
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")
