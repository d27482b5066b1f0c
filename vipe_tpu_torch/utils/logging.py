"""Logging helper (a copy of ``vipe_tpu/utils/logging.py``)."""

from __future__ import annotations

import logging
import sys

_LOGGER = None


def configure_logging(level=logging.INFO):
    """tqdm-friendly logger detached from root."""
    global _LOGGER
    if _LOGGER is not None:
        return _LOGGER
    logger = logging.getLogger("vipe_tpu_torch")
    logger.setLevel(level)
    logger.propagate = False
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(
        logging.Formatter("[%(asctime)s %(name)s %(levelname)s] %(message)s")
    )
    logger.addHandler(handler)
    _LOGGER = logger
    return logger


def get_logger():
    return configure_logging()

