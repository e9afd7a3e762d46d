"""Logging for the port (own copy of vits_tpu/utils/summary.py's logger)."""

import logging

logger = logging.getLogger("vits_tpu_torch")
