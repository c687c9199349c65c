"""Plumbing shared by the port's CLIs: the process group, the run
directory, the seeds, the log and the crash record.

:func:`launch` parses a CLI's flags and runs its body on every rank of the
run's process group: one from the reference's flags where the CLI has them
(:func:`dist_plan`), else from ``torchrun``'s environment, else one the
caller formed already, else a single process. Rank 0 makes the run
directory and writes ``configs.txt``; each rank logs to its own file."""

from __future__ import annotations

import os
import random
import sys
import traceback
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from . import resolve_device
from .parallel.mesh import Mesh, MeshSpec, broadcast_object, make_mesh, plan_launch
from .parallel.mesh import launch as launch_plan
from .utils import close_logger, dump_config, increment_path, setup_logger

__all__ = ["launch", "dist_plan", "rank_mesh", "start_run", "warn_noop_flags",
           "add_error_capture", "log_mesh", "group_info"]


def dist_plan(args, argv, dev):
    """The process group the run's flags ask for (``plan_launch``). The
    parser's ``--dist-backend`` default (``nccl``, the reference's) stands
    for "the device's backend": gloo on the CPU, unless given explicitly."""
    argv = sys.argv[1:] if argv is None else argv
    explicit = any(a == "--dist-backend" or a.startswith("--dist-backend=") for a in argv)
    return plan_launch(dev, world_size=args.world_size, rank=args.rank, dist_url=args.dist_url,
                       dist_backend=args.dist_backend if explicit else None,
                       multiprocessing_distributed=args.multiprocessing_distributed)


def rank_mesh(model_parallel: int, batch_size: int, accum_steps: int) -> Mesh:
    """The run's ``(data, model)`` mesh, checked as the JAX CLI checks it
    (``tools/ssl_train.py:57-80``): ``accum_steps`` must divide the global
    batch, the model size the world, the data ranks the global batch, and
    ``accum_steps`` each rank's part."""
    if accum_steps < 1 or batch_size % accum_steps:
        raise ValueError(f"--batch-size {batch_size} must be divisible by --accum-steps "
                         f"{accum_steps}")
    try:
        mesh = make_mesh(MeshSpec(model=model_parallel))
    except ValueError as e:
        raise ValueError(f"bad --model-parallel {model_parallel}: {e}") from e
    if batch_size % mesh.data:
        raise ValueError(f"global batch {batch_size} must be divisible by the {mesh.data}-rank "
                         "data axis")
    if accum_steps > 1 and (batch_size // mesh.data) % accum_steps:
        raise ValueError(f"per-rank batch {batch_size // mesh.data} must be divisible by "
                         f"--accum-steps {accum_steps}")
    return mesh


def _mesh(args) -> Mesh:
    """A training CLI's checked mesh (``rank_mesh``); an inference CLI
    splits its chunks over every rank."""
    if not hasattr(args, "accum_steps"):
        return make_mesh()
    return rank_mesh(getattr(args, "model_parallel", 1), args.batch_size, args.accum_steps)


def start_run(args, mesh: Mesh) -> None:
    """Rank 0 makes the incremented ``--log-dir`` and writes
    ``configs.txt``; every rank takes its name and seeds Python's and
    numpy's generators from ``--seed``."""
    if mesh.is_main:
        args.log_dir = str(increment_path(args.log_dir, sep="_", mkdir=True))
    args.log_dir = broadcast_object(args.log_dir)
    if args.seed is not None:
        random.seed(args.seed)
        np.random.seed(args.seed)
    if mesh.is_main:
        dump_config(args.log_dir, args)


def warn_noop_flags(logger, args, parser_defaults, table) -> None:
    for flag, why in table.items():
        if getattr(args, flag) != parser_defaults.get(flag):
            logger.info(f"=> flag --{flag.replace('_', '-')} accepted for parity but inert: {why}")


def add_error_capture(log_dir):
    """Crash tracebacks also go to ``<log_dir>/error.txt`` (reference
    ``ssl_train.py:72-81``)."""

    def capture(fn):
        def wrapped(*a, **kw):
            try:
                return fn(*a, **kw)
            except Exception as e:  # noqa: BLE001 — recorded, then raised again
                print(e, "\n")
                with open(os.path.join(log_dir, "error.txt"), "a") as f:
                    traceback.print_exc(file=f)
                    f.write("\n")
                raise

        return wrapped

    return capture


def group_info(mesh: Mesh) -> dict:
    """The process group's ``{"backend", "world", "rank"}`` (``backend``
    None: no group)."""
    backend = dist.get_backend() if dist.is_initialized() else None
    return {"backend": backend, "world": mesh.world, "rank": mesh.rank}


def log_mesh(logger, mesh: Mesh, dev) -> None:
    """Log the device and the process group."""
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    logger.info(f"=> device {dev} ({name})")
    backend = group_info(mesh)["backend"]
    if backend is not None:
        logger.info(f"=> process group: {backend}, rank {mesh.rank} of {mesh.world}; mesh "
                    f"{mesh.data} rank(s) on 'data' x {mesh.model} on 'model'")


def launch(parser, argv, module: str, body: Callable):
    """Parse ``argv`` and run ``body(args, device, defaults, logger, mesh)``
    (a module-level function: spawned workers import it) on every rank of
    the run's process group, with the run's logger (its command line and
    the group logged first; ``--logger-name`` where the CLI has it) and a
    crash's traceback also written to ``<log_dir>/error.txt``. Returns
    ``body``'s result on this process (None after a spawn: each worker's
    result stays in its process)."""
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    plan = dist_plan(args, argv, dev) if hasattr(args, "world_size") else plan_launch(dev)
    cmdline = " ".join([sys.executable, "-m", module, *(sys.argv[1:] if argv is None else argv)])
    defaults = {a.dest: a.default for a in parser._actions}
    return launch_plan(plan, dev, _rank_main, args, defaults, cmdline, body)


def _rank_main(args, defaults, cmdline: str, body: Callable, dev):
    mesh = _mesh(args)
    start_run(args, mesh)

    def worker():
        logger = setup_logger(args.log_dir, mesh.rank, name=getattr(args, "logger_name",
                                                                    "MSF-WSI"))
        try:
            logger.info(cmdline)
            log_mesh(logger, mesh, dev)
            return body(args, dev, defaults, logger, mesh)
        finally:
            close_logger(logger)

    return add_error_capture(args.log_dir)(worker)()
