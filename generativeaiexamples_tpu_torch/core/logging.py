"""Logging bootstrap.

Parity with the reference's pattern: stdlib logging configured from the
``LOGLEVEL`` env var (``common/server.py:40``) with the structured format +
verbosity flags of the frontend (``frontend/__init__.py:30-56``).
"""

from __future__ import annotations

import logging
import os
import sys

_FORMAT_SIMPLE = "%(levelname)s %(asctime)s %(name)s: %(message)s"
_FORMAT_VERBOSE = (
    "%(levelname)s %(asctime)s %(name)s %(filename)s:%(lineno)d: %(message)s"
)

_configured = False


def configure_logging(verbosity: int | None = None) -> None:
    """Configure the root logger once.

    Args:
      verbosity: 0 = WARNING, 1 = INFO, 2+ = DEBUG. When ``None``, the
        ``LOGLEVEL`` env var is honored (name or number), defaulting to INFO.
    """
    global _configured
    if _configured:
        return
    if verbosity is None:
        level_name = os.environ.get("LOGLEVEL", "INFO").upper()
        level = getattr(logging, level_name, None)
        if not isinstance(level, int):
            try:
                level = int(level_name)
            except ValueError:
                level = logging.INFO
    else:
        level = {0: logging.WARNING, 1: logging.INFO}.get(verbosity, logging.DEBUG)
    fmt = _FORMAT_VERBOSE if level <= logging.DEBUG else _FORMAT_SIMPLE
    logging.basicConfig(stream=sys.stderr, level=level, format=fmt)
    _configured = True


def get_logger(name: str) -> logging.Logger:
    configure_logging()
    return logging.getLogger(name)
