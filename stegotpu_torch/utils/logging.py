"""Structured logging for the pipeline (replaces the reference's prints).

A copy of ``stegotpu/utils/logging.py`` for the port's logger
``stegotpu_torch``: a standard library logger with a level-tagged format,
quiet by default, and a helper the CLI uses to turn on verbosity.
"""

from __future__ import annotations

import logging
import sys


def get_logger(name: str = "stegotpu_torch") -> logging.Logger:
    return logging.getLogger(name)


def configure(verbose: bool = False, stream=None) -> None:
    logger = logging.getLogger("stegotpu_torch")
    if logger.handlers:
        logger.handlers.clear()
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(
        logging.Formatter("%(asctime)s %(levelname)-7s %(name)s: %(message)s",
                          datefmt="%H:%M:%S")
    )
    logger.addHandler(handler)
    logger.setLevel(logging.DEBUG if verbose else logging.INFO)
    logger.propagate = False
