"""Structured logging (replaces the reference's stray couts, e.g. the
leftover debug prints at reference main.cpp:182,421)."""

from __future__ import annotations

import logging
import sys


def get_logger(name: str = "crypto_rec_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
        )
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
    return logger
