"""``python -m cruise_control_tpu [config.properties] [port]`` — the
standalone server entry point (upstream ``kafka-cruise-control-start.sh`` →
``KafkaCruiseControlMain.main``; SURVEY.md §3.1).

Starts the REST server (with /ui), metric sampling, anomaly detection, and
proposal precomputation over the simulated cluster, then serves until
SIGINT/SIGTERM.
"""

from __future__ import annotations

import signal
import sys
import threading
import time

from cruise_control_tpu_torch.bootstrap import build_app, load_properties
from cruise_control_tpu_torch.config.cruise_control_config import CruiseControlConfig


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    props = load_properties(argv[0]) if argv else {}
    port = int(argv[1]) if len(argv) > 1 else None
    cfg = CruiseControlConfig(props)
    from cruise_control_tpu_torch.utils.logging import configure

    configure(cfg.get("logging.level"), cfg.get("logging.file"))
    app = build_app(cfg, port=port)

    app.server.start()
    app.fetcher_manager.start()
    app.detector_manager.start()
    app.cruise_control.start_proposal_precomputation(
        interval_s=app.config.get("proposal.precompute.interval.ms") / 1000,
        engine=app.config.get("proposal.precompute.engine"),
    )
    # the simulated brokers report on the sampling cadence (a real
    # cluster's broker-side reporters push to __CruiseControlMetrics on
    # their own schedule — no loop needed in Kafka mode)
    stop = threading.Event()
    if app.reporter is not None:
        def report_loop() -> None:
            interval = app.config.get("metric.sampling.interval.ms") / 1000
            while not stop.wait(min(interval, 5.0)):
                app.reporter.report(time_ms=int(time.time() * 1000))

        threading.Thread(target=report_loop, daemon=True,
                         name="simulated-reporters").start()

    print(f"cruise-control listening on {app.server.url} (UI at /ui)")
    done = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: done.set())
    done.wait()
    stop.set()
    app.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
