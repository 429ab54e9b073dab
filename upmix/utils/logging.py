"""Structured logging — replaces the reference's bare prints
(main.py:44,91-92; center_extraction.py:560-564) while keeping the same
facts available; the band-config table stays accessible via
UpmixConfig.make(verbose=True)."""

from __future__ import annotations

import logging
import os
import sys

_CONFIGURED = False


def get_logger(name: str = "upmix") -> logging.Logger:
    global _CONFIGURED
    if not _CONFIGURED:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
        root = logging.getLogger("upmix")
        root.addHandler(handler)
        root.setLevel(os.environ.get("UPMIX_LOG_LEVEL", "INFO").upper())
        root.propagate = False
        _CONFIGURED = True
    return logging.getLogger(name)
