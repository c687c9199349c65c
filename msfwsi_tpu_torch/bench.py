"""SSL pretrain throughput of the port (from ``bench.py``'s two SSL modes).

    python -m msfwsi_tpu_torch.bench               # BENCH_MODE=pipeline
    BENCH_MODE=step python -m msfwsi_tpu_torch.bench
    python -m msfwsi_tpu_torch.bench --device cpu  # tiny sizes only

Modes, as ``bench.py`` defines them:
  pipeline: raw uint8 (B, 1024, 1024, 3) tiles on the device -> on-device
            views -> the train step (the fused step);
  step:     the train step alone, on random-normal 224 px views.

Metric: 224 px tile views per second per device, B * iters * (2 + 2K) /
seconds / devices (K = 16), timed over ``BENCH_ITERS`` steps after
``BENCH_WARMUP`` and ended by a device sync (``float(loss)``), as in
``bench.py:106-119``. The window is repeated ``BENCH_REPEATS`` times;
earlier lines give each window's rate, their median and quartiles and the
peak device memory, and the last line is ``bench.py``'s JSON with the
median as its value (no ``vs_baseline``: that target was set for a TPU).

Env knobs: BENCH_ARCH, BENCH_BATCH, BENCH_ITERS, BENCH_WARMUP,
BENCH_REPEATS, BENCH_MODE, and those of ``bench.py`` the port raises on
unless left at their defaults (BENCH_USE_AC, BENCH_ACCUM,
BENCH_INTER_OPT, BENCH_INTER_DTYPE, BENCH_REMAT_STAGES). Modes
``hooknet``, ``infer`` and ``eval_e2e`` are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from . import resolve_device
from .data.pipeline import AugConfig, target_keys
from .train.ssl import SSLConfig, create_ssl_state, make_fused_step, ssl_train_step, view_seed

__all__ = ["main"]

IMG_SIZE = 224  # the views' size, as in bench.py; it names the metric
_NOT_PORTED = {"hooknet": 4, "infer": 5, "eval_e2e": 5}


def _config(arch: str, batch: int, env) -> SSLConfig:
    if env.get("BENCH_INTER_DTYPE", "float32") != "float32" or env.get("BENCH_REMAT_STAGES"):
        raise ValueError("BENCH_INTER_DTYPE / BENCH_REMAT_STAGES: not ported yet, "
                         "ROADMAP.md queue 1 item 6")
    return SSLConfig(
        arch=arch, scale=4, batch_size=batch, amp=True,
        use_ac=env.get("BENCH_USE_AC", "0") == "1",
        inter_opt=env.get("BENCH_INTER_OPT", "adam"),
        accum_steps=int(env.get("BENCH_ACCUM", "1")),
    )


def main(argv=None, env=os.environ, img_size: int = IMG_SIZE) -> dict:
    """Run the bench with the ``BENCH_*`` knobs of ``env``; returns the
    last line's fields with each window's rate, the quartiles and the peak
    memory. ``img_size`` is the views' size: bench.py's 224, smaller only
    in CPU tests (the metric's name keeps 224px)."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    arch = env.get("BENCH_ARCH", "resnet18")
    batch = int(env.get("BENCH_BATCH", "32"))
    iters = int(env.get("BENCH_ITERS", "20"))
    warmup = int(env.get("BENCH_WARMUP", "3"))
    repeats = int(env.get("BENCH_REPEATS", "5"))
    mode = env.get("BENCH_MODE", "pipeline")
    if mode in _NOT_PORTED:
        raise NotImplementedError(f"BENCH_MODE={mode}: not ported yet, ROADMAP.md queue 1 "
                                  f"item {_NOT_PORTED[mode]}")
    if mode not in ("pipeline", "step"):
        raise ValueError(f"unknown BENCH_MODE {mode!r}")
    dev = resolve_device(args.device)

    config = _config(arch, batch, env)
    K = config.scale**2
    state = create_ssl_state(config, device=dev)
    rng = np.random.default_rng(0)
    if mode == "pipeline":
        aug_cfg = AugConfig(img_size=img_size, grid=config.scale, compute_dtype="bfloat16")
        src = config.scale * aug_cfg.tile_px  # 1024 px source tiles
        tiles = torch.from_numpy(rng.integers(0, 255, (batch, src, src, 3), np.uint8)).to(dev)
        step = make_fused_step(config, aug_cfg, device=dev)
        gen = torch.Generator(device=dev)

        def run(i):
            gen.manual_seed(view_seed(1, 0, i))
            return step(state, tiles, gen)
    else:
        S = img_size
        rev = torch.from_numpy(np.argsort(np.stack([rng.permutation(K) for _ in range(batch)]),
                                          axis=1)).to(dev)
        t1, t2 = target_keys(config.shuffle_views)

        def normal(*shape):
            return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

        views = {"context1": normal(batch, S, S, 3), "context2": normal(batch, S, S, 3),
                 t1: normal(batch * K, S, S, 3), t2: normal(batch * K, S, S, 3),
                 "rev1": rev, "rev2": rev}

        def run(i):
            return ssl_train_step(state, views, config.fuser_weights, amp=config.amp)

    for i in range(warmup):
        metrics = run(i)
    float(metrics["loss"])  # sync
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rates = []
    for r in range(repeats):
        t0 = time.perf_counter()
        for i in range(iters):
            metrics = run(warmup + r * iters + i)
        loss = float(metrics["loss"])  # sync
        dt = time.perf_counter() - t0
        if not np.isfinite(loss):
            raise RuntimeError(f"non-finite loss {loss} in the benchmark")
        rates.append(batch * iters * (2 + 2 * K) / dt)
        print(f"window {r + 1}/{repeats}: {iters} steps in {dt:.4f} s, {rates[-1]:.2f} tile "
              f"views/s, {1e3 * dt / iters:.2f} ms/step, loss {loss:.6f}", flush=True)
    q1, median, q3 = (statistics.quantiles(rates, n=4) if len(rates) > 1
                      else (rates[0], rates[0], rates[0]))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"{mode} on {name}: median {median:.2f} tile views/s, quartiles {q1:.2f} / {q3:.2f} "
          f"over {repeats} windows of {iters} steps; peak memory "
          + (f"{peak / 2**30:.2f} GiB" if peak is not None else "not measured (cpu)"), flush=True)
    line = {
        "metric": f"ssl_pretrain_e2e_tile_views_per_sec_per_chip[{arch},b{batch},scale4,"
                  f"{IMG_SIZE}px,{mode}]",
        "value": median,
        "unit": "tiles/sec/chip",
    }
    print(json.dumps(line), flush=True)
    return {**line, "rates": rates, "q1": q1, "q3": q3, "peak_bytes": peak, "device": name}


if __name__ == "__main__":
    main()
    sys.exit(0)
