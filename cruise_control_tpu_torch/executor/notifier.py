"""Executor completion hooks (upstream ``executor/ExecutorNotifier`` SPI;
SURVEY.md §2.6)."""

from __future__ import annotations

import logging

logger = logging.getLogger(__name__)


class ExecutorNotifier:
    """SPI: implement either hook; the executor calls exactly one per run."""

    def on_execution_finished(self, result) -> None:  # pragma: no cover - SPI
        pass

    def on_execution_stopped(self, result) -> None:  # pragma: no cover - SPI
        pass


class LoggingExecutorNotifier(ExecutorNotifier):
    def on_execution_finished(self, result) -> None:
        logger.info(
            "execution finished: %d completed, %d dead, %d aborted (%d ticks)",
            result.completed, result.dead, result.aborted, result.ticks,
        )

    def on_execution_stopped(self, result) -> None:
        logger.warning(
            "execution stopped by request: %d completed, %d aborted",
            result.completed, result.aborted,
        )
