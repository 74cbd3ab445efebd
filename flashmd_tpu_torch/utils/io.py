"""Host-side logging and the progress bar (port of the logging half of
flashmd_tpu/utils/io.py; its YAML helpers belong to the CLI).

``tqdm`` is imported when a bar is made, not when this module is: where it
is not installed the bar is the reference's no-op fallback
(flashmd_tpu/utils/io.py:17-19).
"""

from __future__ import annotations

import logging
import logging.handlers
import sys

logger = logging.getLogger("flashmd_tpu_torch")

#: File-sink rotation of the reference's logging setup: 100 MB a file,
#: 7 rotated generations.
LOG_ROTATE_BYTES = 100 * 1024 * 1024
LOG_BACKUP_COUNT = 7

_FORMAT = "%(asctime)s | %(levelname)s | %(name)s - %(message)s"


class _NoBar:
    """What ``tqdm`` returns where it is not installed."""

    def __init__(self, *args, **kwargs):
        pass

    def update(self, n=1):
        pass

    def close(self):
        pass


def tqdm(*args, **kwargs):
    """A ``tqdm`` progress bar, or a no-op one without ``tqdm``."""
    try:
        from tqdm import tqdm as bar
    except ImportError:
        bar = _NoBar
    return bar(*args, **kwargs)


def setup_logging(
    level: int = logging.INFO,
    log_file: str | None = None,
    rotate_bytes: int = LOG_ROTATE_BYTES,
    backup_count: int = LOG_BACKUP_COUNT,
) -> logging.Logger:
    """Console (and, with ``log_file``, rotating file) logging in the
    reference's format; idempotent per handler."""
    logger.setLevel(level)
    if not any(type(h) is logging.StreamHandler for h in logger.handlers):
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
    if log_file is not None and not any(
        isinstance(h, logging.FileHandler)
        and getattr(h, "baseFilename", None) == log_file
        for h in logger.handlers
    ):
        fh = logging.handlers.RotatingFileHandler(
            log_file, maxBytes=rotate_bytes, backupCount=backup_count
        )
        fh.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(fh)
    return logger


def close_log_file(log_file: str) -> None:
    """Detach and close the file handler of ``log_file``, so that a later
    simulation in the process does not write into it."""
    for h in list(logger.handlers):
        if getattr(h, "baseFilename", None) == log_file:
            logger.removeHandler(h)
            h.close()
