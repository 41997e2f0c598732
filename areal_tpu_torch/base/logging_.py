"""Logging helpers (copy of ``areal_tpu/base/logging_.py``): named loggers
under the ``areal`` hierarchy with a compact colored formatter, and a
``getLogger(name, type_)`` API.
"""

from __future__ import annotations

import logging
import os
import sys

_FORMAT = "%(asctime)s.%(msecs)03d %(name)s %(levelname)s: %(message)s"
_DATE_FORMAT = "%Y%m%d-%H:%M:%S"

_COLORS = {
    "DEBUG": "\033[36m",  # cyan
    "INFO": "\033[32m",  # green
    "WARNING": "\033[33m",  # yellow
    "ERROR": "\033[31m",  # red
    "CRITICAL": "\033[41m",  # red background
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        msg = super().format(record)
        if sys.stderr.isatty():
            color = _COLORS.get(record.levelname, "")
            if color:
                msg = f"{color}{msg}{_RESET}"
        return msg


_configured = False


def _configure_root():
    global _configured
    if _configured:
        return
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(_ColorFormatter(fmt=_FORMAT, datefmt=_DATE_FORMAT))
    root = logging.getLogger("areal")
    root.addHandler(handler)
    root.propagate = False
    level = os.environ.get("AREAL_LOG_LEVEL", "INFO").upper()
    root.setLevel(level)
    _configured = True


def getLogger(name: str = "areal", type_: str | None = None) -> logging.Logger:
    """Return a logger under the ``areal`` hierarchy.

    ``type_`` mirrors the reference's "benchmark"/"system" logger types; here it
    only namespaces the logger.
    """
    _configure_root()
    if name == "areal" or name is None:
        return logging.getLogger("areal")
    if type_:
        return logging.getLogger(f"areal.{type_}.{name}")
    return logging.getLogger(f"areal.{name}")
