"""mx.log — logging helpers (colored level tags, one-call setup).

Copy of ``mxnet_tpu/log.py`` (the port imports nothing of the JAX
package). Reference parity: python/mxnet/log.py (CRITICAL..NOTSET constants,
``getLogger``/``get_logger`` returning a logger with a colored
``LEVEL MMDD HH:MM:SS file:line] msg`` formatter). The reference colors by
escape codes only when the stream is a tty; same here.
"""
from __future__ import annotations

import logging
import sys
import warnings

CRITICAL = logging.CRITICAL
ERROR = logging.ERROR
WARNING = logging.WARNING
INFO = logging.INFO
DEBUG = logging.DEBUG
NOTSET = logging.NOTSET

_LEVEL_CHAR = {
    logging.CRITICAL: "C", logging.ERROR: "E", logging.WARNING: "W",
    logging.INFO: "I", logging.DEBUG: "D",
}
# red for warning+, green for info, blue below
_LEVEL_COLOR = {
    logging.CRITICAL: "\x1b[31m", logging.ERROR: "\x1b[31m",
    logging.WARNING: "\x1b[31m", logging.INFO: "\x1b[32m",
}


class _Formatter(logging.Formatter):
    """``LEVEL date file:line] message``, colored on ttys."""

    def __init__(self, colored=True):
        super().__init__(datefmt="%m%d %H:%M:%S")
        self._colored = colored

    def format(self, record):
        char = _LEVEL_CHAR.get(record.levelno, "U")
        label = f"{char} {self.formatTime(record, self.datefmt)} " \
                f"{record.filename}:{record.lineno}]"
        if self._colored:
            color = _LEVEL_COLOR.get(record.levelno, "\x1b[34m")
            label = f"{color}{label}\x1b[0m"
        return f"{label} {record.getMessage()}"


def get_logger(name=None, filename=None, filemode=None, level=WARNING):
    """Return a logger configured with the mxnet formatter.

    Idempotent per name: an already-configured logger keeps its handler.
    `filename` switches to a FileHandler (mode `filemode`, default 'a').
    """
    logger = logging.getLogger(name)
    if getattr(logger, "_mx_log_configured", False):
        return logger
    if filename:
        handler = logging.FileHandler(filename, filemode or "a")
        colored = False
    else:
        handler = logging.StreamHandler(sys.stderr)
        colored = getattr(sys.stderr, "isatty", lambda: False)()
    handler.setFormatter(_Formatter(colored))
    logger.addHandler(handler)
    logger.setLevel(level)
    logger._mx_log_configured = True
    return logger


def getLogger(name=None, filename=None, filemode=None, level=WARNING):
    """Deprecated alias of :func:`get_logger` (reference keeps both)."""
    warnings.warn("getLogger is deprecated, use get_logger instead",
                  DeprecationWarning, stacklevel=2)
    return get_logger(name, filename, filemode, level)
