"""Logging + offline progress reporting.

Replaces the reference's std::cout progress prints (1% steps,
Application.cpp:426-438) and its OUTPUT_MODE_SILENT profiling switch
(global_preprocessor_flags.h:22) with standard logging; silence with
level=WARNING.
"""

from __future__ import annotations

import logging
import sys


def get_logger(name: str = "cprt", silent: bool = False) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter("[%(name)s] %(message)s"))
        logger.addHandler(h)
    logger.setLevel(logging.WARNING if silent else logging.INFO)
    return logger


def progress(logger: logging.Logger, frame: int, total: int) -> None:
    """Log at every whole percent, like Application.cpp:430-437."""
    if total <= 0:
        return
    step = max(total // 100, 1)
    if frame % step == 0 or frame == total - 1:
        logger.info("render progress: %d%% (%d/%d frames)",
                    int(100 * (frame + 1) / total), frame + 1, total)
