"""Structured logging.

The reference's only observability is bare ``print`` progress lines
(tiff_analysis.py:103,124,127,654,667 — SURVEY.md §5); here: a standard
logger with a compact structured format, rate-controlled by the usual env
(``PCIS_LOG=debug|info|warning``).
"""

from __future__ import annotations

import logging
import os
import sys

_FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"
_configured = False


def get_logger(name: str = "pcis") -> logging.Logger:
    global _configured
    if not _configured:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        root = logging.getLogger("pcis")
        root.addHandler(handler)
        level = os.environ.get("PCIS_LOG", "info").upper()
        root.setLevel(getattr(logging, level, logging.INFO))
        root.propagate = False
        _configured = True
    return logging.getLogger(name if name.startswith("pcis") else f"pcis.{name}")
