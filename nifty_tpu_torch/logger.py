"""Module logger (single stream handler, INFO default)."""

import logging
import sys

logger = logging.getLogger("nifty_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler(sys.stdout)
    _h.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)
    logger.propagate = False
