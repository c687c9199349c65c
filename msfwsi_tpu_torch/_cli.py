"""Plumbing shared by the port's inference CLIs (``evaluate``, ``predict``,
``extract_features``, ``linear_probe``): the run directory, the seeds, the
log and the crash record, as the training CLIs set them up."""

from __future__ import annotations

import random
import sys
from typing import Callable

import numpy as np

from . import resolve_device
from .ssl_train import add_error_capture
from .utils import close_logger, dump_config, increment_path, setup_logger

__all__ = ["start", "run"]


def start(parser, argv):
    """Parse ``argv``, resolve ``--device`` (raising without a card unless
    it is ``cpu``), make the incremented ``--log-dir``, seed Python's and
    numpy's generators from ``--seed``, and write ``configs.txt``. Returns
    ``(args, device, parser defaults)``."""
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    args.log_dir = str(increment_path(args.log_dir, sep="_", mkdir=True))
    if args.seed is not None:
        random.seed(args.seed)
        np.random.seed(args.seed)
    dump_config(args.log_dir, args)
    return args, dev, {a.dest: a.default for a in parser._actions}


def run(args, argv, module: str, fn: Callable):
    """``fn(logger)`` with the run's logger (its command line logged first),
    a crash's traceback also written to ``<log_dir>/error.txt``."""
    cmdline = " ".join([sys.executable, "-m", module, *(sys.argv[1:] if argv is None else argv)])

    def worker():
        logger = setup_logger(args.log_dir, name="MSF-WSI")
        try:
            logger.info(cmdline)
            return fn(logger)
        finally:
            close_logger(logger)

    return add_error_capture(args.log_dir)(worker)()
