"""Structured logging for the port (port of unimedvl_tpu/utils/logging.py):
one stderr handler on the ``unimedvl_tpu_torch`` logger, installed once."""

from __future__ import annotations

import logging
import sys

_FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"
_ROOT = "unimedvl_tpu_torch"
_configured = False


def get_logger(name: str = _ROOT) -> logging.Logger:
    """The logger ``name`` (a child of ``unimedvl_tpu_torch`` by convention),
    with the package's handler and INFO level set up at the first call."""
    global _configured
    if not _configured:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        root = logging.getLogger(_ROOT)
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        root.propagate = False
        _configured = True
    return logging.getLogger(name)
