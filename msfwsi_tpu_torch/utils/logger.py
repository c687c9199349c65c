"""Logging to stdout and ``<log_dir>/log.txt`` (port of ``setup_logger`` in
``msfwsi_tpu/utils/logger.py``; reference ``src/utils/logger.py:17-69``):
rank 0 logs to stdout and ``log.txt``, other ranks to ``log.txt.rank{N}``.
Cached, so a repeat call returns the same logger; :func:`close_logger`
closes its files and lets a later run in the same process start afresh."""

from __future__ import annotations

import functools
import logging
import os
import sys

__all__ = ["setup_logger", "close_logger"]

_FORMAT = "[%(asctime)s] %(name)s %(levelname)s: %(message)s"
_DATEFMT = "%m/%d %H:%M:%S"


@functools.lru_cache(maxsize=None)
def setup_logger(
    output: str | None = None,
    distributed_rank: int = 0,
    *,
    name: str = "MSF-WSI",
    abbrev_name: str | None = None,
) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False

    fmt = _FORMAT.replace("%(name)s", abbrev_name) if abbrev_name else _FORMAT
    formatter = logging.Formatter(fmt, datefmt=_DATEFMT)
    if distributed_rank == 0:
        ch = logging.StreamHandler(stream=sys.stdout)
        ch.setLevel(logging.DEBUG)
        ch.setFormatter(formatter)
        logger.addHandler(ch)

    if output is not None:
        filename = os.path.join(output, "log.txt") if not output.endswith(".txt") else output
        if distributed_rank > 0:
            filename = f"{filename}.rank{distributed_rank}"
        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        fh = logging.FileHandler(filename, mode="a")
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(formatter)
        logger.addHandler(fh)

    return logger


def close_logger(logger: logging.Logger) -> None:
    """Remove and close every handler of ``logger``, let its records reach
    the root logger again (as before :func:`setup_logger`), and forget the
    cached set-ups."""
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    logger.propagate = True
    setup_logger.cache_clear()
