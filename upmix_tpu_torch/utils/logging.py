"""Structured logging for the port: the copy of `upmix_tpu/utils/logging.py`
under the `upmix_tpu_torch` logger (level from UPMIX_LOG_LEVEL, INFO by
default, to stderr)."""

from __future__ import annotations

import logging
import os
import sys

_CONFIGURED = False


def get_logger(name: str = "upmix_tpu_torch") -> logging.Logger:
    global _CONFIGURED
    if not _CONFIGURED:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
        root = logging.getLogger("upmix_tpu_torch")
        root.addHandler(handler)
        root.setLevel(os.environ.get("UPMIX_LOG_LEVEL", "INFO").upper())
        root.propagate = False
        _CONFIGURED = True
    return logging.getLogger(name)
