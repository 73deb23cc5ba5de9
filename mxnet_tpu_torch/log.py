# copied from mxnet_tpu/log.py (backend-free)
"""Colored console logging helper (reference: python/mxnet/log.py — same
public surface: ``getLogger(name, filename, filemode, level)`` plus the
level constants; the formatter is this repo's own, keyed on ANSI support).
"""
from __future__ import annotations

import logging
import sys

DEBUG = logging.DEBUG
INFO = logging.INFO
WARNING = logging.WARNING
ERROR = logging.ERROR
CRITICAL = logging.CRITICAL
NOTSET = logging.NOTSET

_COLORS = {
    logging.DEBUG: "\x1b[36m",     # cyan
    logging.INFO: "\x1b[32m",      # green
    logging.WARNING: "\x1b[33m",   # yellow
    logging.ERROR: "\x1b[31m",     # red
    logging.CRITICAL: "\x1b[35m",  # magenta
}
_RESET = "\x1b[0m"


class _LevelColorFormatter(logging.Formatter):
    """Prefix the level tag, colored when the stream is a terminal."""

    def __init__(self, colored):
        super().__init__("%(asctime)s %(message)s", "%m%d %H:%M:%S")
        self._colored = colored

    def format(self, record):
        tag = record.levelname[0]
        if self._colored and record.levelno in _COLORS:
            tag = _COLORS[record.levelno] + tag + _RESET
        return "%s %s" % (tag, super().format(record))


def getLogger(name=None, filename=None, filemode=None, level=WARNING):
    """A configured logger: console (colored on TTYs) or ``filename``.
    Idempotent per logger: repeat calls reuse the existing configuration
    (and ``propagate`` is off) so records never print twice."""
    logger = logging.getLogger(name)
    if getattr(logger, "_mxtpu_configured", False):
        return logger
    if filename:
        handler: logging.Handler = logging.FileHandler(filename, filemode or "a")
        colored = False
    else:
        handler = logging.StreamHandler(sys.stderr)
        colored = getattr(sys.stderr, "isatty", lambda: False)()
    handler.setFormatter(_LevelColorFormatter(colored))
    logger.addHandler(handler)
    logger.setLevel(level)
    logger.propagate = False
    logger._mxtpu_configured = True
    return logger
