"""Logging configuration — the rosconsole/log4j config equivalent.

The reference injects a log4j levels file (config/logging.conf, loaded by
the launch env at launch/liodom.launch:8).  Here the same control surface is
Python logging: one call, level per subsystem, optional file sink.
"""

from __future__ import annotations

import logging
import sys
from typing import Dict, Optional

_FMT = "%(asctime)s %(levelname)s %(name)s: %(message)s"

# config/logging.conf:1-4 defaults everything to INFO
DEFAULT_LEVELS: Dict[str, str] = {
    "liodom_tpu_torch": "INFO",
}


def configure(levels: Optional[Dict[str, str]] = None,
              logfile: Optional[str] = None) -> None:
    """Set up handlers and per-logger levels.

    ``levels``: {logger name: level name}, merged over DEFAULT_LEVELS."""
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FMT))
    handlers = [handler]
    if logfile:
        fh = logging.FileHandler(logfile)
        fh.setFormatter(logging.Formatter(_FMT))
        handlers.append(fh)
    root = logging.getLogger("liodom_tpu_torch")
    root.handlers = handlers
    root.propagate = False
    merged = dict(DEFAULT_LEVELS)
    if levels:
        merged.update(levels)
    for name, level in merged.items():
        logging.getLogger(name).setLevel(getattr(logging, level.upper()))
