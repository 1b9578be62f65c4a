"""Multi-sink logger, the `slog` equivalent (ref: src-core/logger.h:14-159).

Levels match the reference's (trace/debug/info/warn/error/critical). Built on
the stdlib logging module with an ANSI console sink; file sinks and callback
sinks (the analogue of the GUI notify/status sinks) can be attached at runtime.
"""

from __future__ import annotations

import logging
import sys
from typing import Callable

TRACE = 5
logging.addLevelName(TRACE, "TRACE")

_ANSI = {
    "TRACE": "\033[37m",
    "DEBUG": "\033[36m",
    "INFO": "\033[32m",
    "WARNING": "\033[33m",
    "ERROR": "\033[31m",
    "CRITICAL": "\033[1;31m",
}
_RESET = "\033[0m"


class _ConsoleFormatter(logging.Formatter):
    def __init__(self, color: bool = True):
        super().__init__("%(asctime)s %(levelname)-8s %(message)s", "%H:%M:%S")
        self.color = color

    def format(self, record: logging.LogRecord) -> str:
        msg = super().format(record)
        if self.color:
            c = _ANSI.get(record.levelname, "")
            return f"{c}{msg}{_RESET}" if c else msg
        return msg


class Logger(logging.Logger):
    def trace(self, msg, *args, **kwargs):
        if self.isEnabledFor(TRACE):
            self._log(TRACE, msg, args, **kwargs)


logging.setLoggerClass(Logger)
logger: Logger = logging.getLogger("satdump_tpu_torch")  # type: ignore[assignment]
logging.setLoggerClass(logging.Logger)

if not logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(_ConsoleFormatter(color=sys.stderr.isatty()))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)
    logger.propagate = False


def set_level(level: str) -> None:
    logger.setLevel(TRACE if level.lower() == "trace" else level.upper())


def add_file_sink(path: str, level: str = "debug") -> logging.Handler:
    """File sink (ref FileLoggerSink, src-core/logger.h)."""
    h = logging.FileHandler(path)
    h.setFormatter(_ConsoleFormatter(color=False))
    h.setLevel(TRACE if level.lower() == "trace" else level.upper())
    logger.addHandler(h)
    return h


class CallbackSink(logging.Handler):
    """Push log records to a Python callback (the notify/status-bar sink analogue)."""

    def __init__(self, fn: Callable[[str, str], None], level: int = logging.INFO):
        super().__init__(level)
        self.fn = fn

    def emit(self, record: logging.LogRecord) -> None:
        try:
            self.fn(record.levelname, record.getMessage())
        except Exception:
            pass


def add_callback_sink(fn: Callable[[str, str], None]) -> CallbackSink:
    h = CallbackSink(fn)
    logger.addHandler(h)
    return h
