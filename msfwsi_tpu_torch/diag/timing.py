"""Kernel timing on a CUDA card, and the H100 peaks a bound is taken from."""

from __future__ import annotations

import statistics
import time

import torch

__all__ = ["HBM_BYTES_PER_S", "FP32_FLOP_PER_S", "cuda_time_ms", "host_time_ms", "bound_ms"]

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
