"""Logging setup (upstream ships log4j config — ``config/log4j.properties``,
SURVEY.md §5.5; here the stdlib ``logging`` tree rooted at
``cruise_control_tpu_torch``).

Subsystems log under ``cruise_control_tpu_torch.<area>`` (engine, analyzer,
executor, detector, monitor, server), so operators can tune per-area levels
the way upstream's log4j categories allow.  ``configure()`` is called by the
server bootstrap from the ``logging.level`` / ``logging.file`` /
``telemetry.logging.json`` config keys; library use (tests, notebooks)
inherits whatever the host application set up — we never call
``basicConfig`` on import.

``json_lines=True`` switches the handler to structured JSON lines sharing
the event-journal field vocabulary (``ts`` / ``severity`` / ``kind`` —
``kind`` is ``log.<area>``), so one ``jq 'select(.severity=="ERROR")'``
works across the log file and the ``cc-tpu-events/1`` journal alike.
"""

from __future__ import annotations

import json
import logging
import sys
from typing import Optional

#: every in-package logger hangs off this root
ROOT = "cruise_control_tpu_torch"

_FORMAT = "%(asctime)s %(levelname)-5s [%(name)s] %(message)s"


def get_logger(area: str) -> logging.Logger:
    """Logger for a subsystem area (e.g. ``engine``, ``executor``)."""
    return logging.getLogger(f"{ROOT}.{area}")


class JsonLineFormatter(logging.Formatter):
    """One JSON object per record, field names shared with the
    ``cc-tpu-events/1`` journal so grep/jq pipelines span both files."""

    def format(self, record: logging.LogRecord) -> str:
        area = record.name
        if area.startswith(ROOT):
            area = area[len(ROOT):].lstrip(".") or "root"
        out = {
            "ts": round(record.created, 3),
            "severity": record.levelname,
            "kind": f"log.{area}",
            "logger": record.name,
            "message": record.getMessage(),
        }
        if record.exc_info and record.exc_info[0] is not None:
            out["error"] = repr(record.exc_info[1])
        return json.dumps(out, default=str)


def configure(level: str = "INFO", file: Optional[str] = None,
              json_lines: bool = False) -> None:
    """Install handlers on the package root (idempotent: replaces any
    handlers a previous configure() installed)."""
    root = logging.getLogger(ROOT)
    for h in list(root.handlers):
        root.removeHandler(h)
    handler: logging.Handler
    if file:
        handler = logging.FileHandler(file)
    else:
        handler = logging.StreamHandler(sys.stderr)
    if json_lines:
        handler.setFormatter(JsonLineFormatter())
    else:
        handler.setFormatter(logging.Formatter(_FORMAT))
    root.addHandler(handler)
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
    root.propagate = False
