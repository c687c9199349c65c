"""Kernel timing on a CUDA card, and the H100 peaks a bound is taken from.

Two ways to time a kernel whose data would fit in the 50 MB L2 cache:
``cuda_time_ms(fn, cold_l2=True)`` writes a 128 MB buffer before each
timing, and :func:`rotating_time_ms` runs the call over several distinct
sets of buffers in turn. The first leaves the cache full of dirty lines,
whose write-back the timed call pays for when its own traffic evicts them;
the second charges each call, in steady state, one read of its input from
device memory and one write-back of its output.
"""

from __future__ import annotations

import functools
import math
import statistics
import time

import torch

__all__ = ["HBM_BYTES_PER_S", "FP32_FLOP_PER_S", "cuda_time_ms", "rotation_count",
           "rotating_time_ms", "host_time_ms", "bound_ms"]

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bandwidth and
# fp32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


# Cycles of the spin kernel that holds the device while the host enqueues a
# timed call (about 1 ms at the H100's clocks).
_SPIN_CYCLES = 2_000_000


def cuda_time_ms(fn, reps: int = 20, cold_l2: bool = False) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after 2 warm-ups:
    the device's time. Before each timing a spin kernel keeps the device
    busy while the host enqueues the start event, ``fn`` and the end event,
    so the host's launch latency (Python, checks, ctypes) is not counted.
    With ``cold_l2``, 128 MB are written before each timing, outside it, so
    that ``fn`` finds none of its data in the 50 MB L2 cache."""
    for _ in range(2):
        fn()
    flush = torch.empty(32 * 2**20, device="cuda") if cold_l2 else None
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(_SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _l2_bytes() -> int:
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    return int(getattr(props, "L2_cache_size", 50 * 2**20))


def rotation_count(nbytes: int) -> int:
    """How many distinct sets of buffers, each of ``nbytes`` read and
    written by one call, :func:`rotating_time_ms` needs to hold more than
    twice the L2 cache between two calls on the same set: at least 2."""
    return max(2, math.floor(2 * _l2_bytes() / nbytes) + 1)


@functools.lru_cache(maxsize=None)
def _spin_ms(cycles: int) -> float:
    torch.cuda._sleep(cycles)  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def rotating_time_ms(fn, sets, reps: int = 20) -> float:
    """Device time per call of ``fn(s)`` for ``s`` in ``sets`` (distinct
    buffers, together more than twice the L2 cache: :func:`rotation_count`),
    each timing ``len(sets)`` calls back to back between two CUDA events,
    median of ``reps``, after one round of warm-up. Each set's last result
    is kept until the set comes round again, so an output is written where
    the same set's output was written a round before, long since evicted:
    in steady state every call reads its input from device memory and pays
    for one write-back of an output, its own bytes and no others. As in
    :func:`cuda_time_ms` a spin kernel holds the device while the host
    enqueues; it is lengthened (and the timing taken again) whenever the
    host took longer than the spin, and a ``fn`` that keeps the host longer
    than 64 spins, one that waits for the device, raises ``RuntimeError``."""
    outs = [fn(s) for s in sets]
    cycles = _SPIN_CYCLES
    times = []
    while len(times) < reps:
        if cycles > 64 * _SPIN_CYCLES:
            raise RuntimeError(f"{fn} held the host {host_ms:.1f} ms for {len(sets)} calls: it "
                               "waits for the device, so its device time cannot be isolated")
        torch.cuda._sleep(cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for i, s in enumerate(sets):
            outs[i] = None  # its buffer goes back to the allocator for this call
            outs[i] = fn(s)
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        if host_ms > 0.8 * _spin_ms(cycles):
            cycles *= 2
            continue
        times.append(start.elapsed_time(end) / len(sets))
    return statistics.median(times)


def host_time_ms(fn, reps: int = 20) -> float:
    """Wall time per call of ``reps`` back-to-back calls of ``fn`` after 2
    warm-ups, from an idle device to the end of the last call: the time a
    caller sees, the host's cost of each call (Python, checks, ctypes)
    included. It is the larger of that cost and the device's time, as the
    host enqueues while the device runs."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def bound_ms(nbytes: float, flops: float = 0.0) -> tuple[float, str]:
    """Least time the card could take to move ``nbytes`` through device
    memory and do ``flops`` fp32 operations: the larger of the two times,
    in ms, and which of them it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")
