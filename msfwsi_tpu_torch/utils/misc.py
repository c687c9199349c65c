"""Run-dir management, meters and a background iterator (port of
``msfwsi_tpu/utils/misc.py``; reference: ``src/utils/utils.py:10-24``
increment_path, ``tools/ssl_train.py:502-541`` AverageMeter/ProgressMeter)."""

from __future__ import annotations

import glob
import os
import queue
import re
import threading
from pathlib import Path

__all__ = ["increment_path", "dump_config", "AverageMeter", "ProgressMeter", "prefetch_iter"]


def prefetch_iter(iterable, depth: int = 1):
    """Run ``iterable`` on a background thread, keeping up to ``depth``
    items ready ahead of the consumer.

    Order is kept; an exception of the producer is raised at the consumer's
    next ``next()``; the producer (a daemon thread) stops early if the
    consumer abandons the iterator.
    """
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    done = object()
    stop = threading.Event()

    def put(msg) -> bool:
        while not stop.is_set():
            try:
                q.put(msg, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for item in iterable:
                if not put((False, item)):
                    return
            put((True, done))
        except Exception as e:  # noqa: BLE001 — raised again in the consumer
            put((True, e))

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            is_last, item = q.get()
            if is_last:
                if item is done:
                    return
                raise item
            yield item
    finally:
        stop.set()


def increment_path(path, exist_ok: bool = False, sep: str = "", mkdir: bool = False) -> Path:
    """YOLOv5-style run-dir auto-increment: runs/exp -> runs/exp{sep}2, ..."""
    path = Path(path)
    if path.exists() and not exist_ok:
        suffix = path.suffix
        path = path.with_suffix("")
        dirs = glob.glob(f"{path}{sep}*")
        matches = [re.search(rf"%s{sep}(\d+)" % re.escape(path.stem), d) for d in dirs]
        i = [int(m.groups()[0]) for m in matches if m]
        n = max(i) + 1 if i else 2
        path = Path(f"{path}{sep}{n}{suffix}")
    if mkdir:
        path.mkdir(parents=True, exist_ok=True)
    return path


def dump_config(log_dir: str, args) -> None:
    """Write every flag to configs.txt (``ssl_train.py:55-57``)."""
    with open(os.path.join(log_dir, "configs.txt"), "w") as f:
        for key in vars(args):
            f.write(f"{key}: {getattr(args, key)}\n")


class AverageMeter:
    """Weighted running mean that also remembers the last value.

    ``str()`` renders ``"<name> <val> (<avg>)"``, the reference's training
    log line format (``ssl_train.py:502-518``). ``fmt`` is a ``":"``-prefixed
    format spec (e.g. ``":6.3f"``).
    """

    def __init__(self, name: str, fmt: str = ":f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n

    def __str__(self):
        spec = self.fmt.removeprefix(":")
        return f"{self.name} {self.val:{spec}} ({self.avg:{spec}})"


class ProgressMeter:
    """Joins a ``prefix[batch/total]`` heading with its meters, tab-separated
    (``ssl_train.py:521-536``)."""

    def __init__(self, num_batches: int, meters, prefix: str = ""):
        self.total = num_batches
        self.meters = meters
        self.prefix = prefix

    def display(self, batch: int) -> str:
        width = len(str(self.total))
        heading = f"{self.prefix}[{batch:{width}d}/{self.total}]"
        return "\t".join([heading, *(str(m) for m in self.meters)])
