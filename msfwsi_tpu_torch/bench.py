"""Throughput of the port (from ``bench.py``'s SSL and HookNet modes).

    python -m msfwsi_tpu_torch.bench               # BENCH_MODE=pipeline
    BENCH_MODE=step python -m msfwsi_tpu_torch.bench
    BENCH_MODE=hooknet BENCH_BATCH=64 python -m msfwsi_tpu_torch.bench
    BENCH_MODE=eval_e2e python -m msfwsi_tpu_torch.bench   # 32 tiles a slide
    python -m msfwsi_tpu_torch.bench --device cpu  # tiny sizes only

Modes, as ``bench.py`` defines them:
  pipeline: raw uint8 (B, 1024, 1024, 3) tiles on the device -> on-device
            views -> the SSL train step (the fused step);
  step:     the SSL train step alone, on random-normal 224 px views;
  hooknet:  the fused fine-tuning step: uint8 (B, 1024, 1024, 3) tiles and
            (B, 1024, 1024) masks -> 256 px context/target views -> the
            HookNet train step (Dice, Adam), bf16;
  infer:    the per-slide validation chunk (``make_chunk_stats``): eval
            forward of B = chunk random-normal 256 px view pairs, target
            argmax and confusion counts kept on the device, bf16;
  eval_e2e: the evaluation CLI's datapath end to end on synthetic slides
            of B = BENCH_BATCH 1024 px tiles: host uint8 views (threaded),
            then ``validate_slide_hostviews`` at chunk 128 (pinned
            side-stream uploads, counts on the device, one fetch a slide),
            the next slide's views made while the current one runs; a
            step is one slide, bf16.

Metrics: pipeline/step, 224 px tile views per second per device, B * iters
* (2 + 2K) / seconds / devices (K = 16); hooknet, context/target pairs per
second, B * iters / seconds; infer, tiles per second, chunk * iters /
seconds; eval_e2e, source tiles per second, B * slides / seconds. Each is
timed over ``BENCH_ITERS`` steps after ``BENCH_WARMUP`` and ended by a
device sync, as in ``bench.py:106-119,142-199,205-290``. The window
is repeated ``BENCH_REPEATS`` times; earlier lines give each window's rate,
their median and quartiles and the peak device memory, and the last line is
``bench.py``'s JSON with the median as its value (no ``vs_baseline``: that
target was set for a TPU).

Env knobs: BENCH_ARCH, BENCH_BATCH, BENCH_ITERS, BENCH_WARMUP,
BENCH_REPEATS, BENCH_MODE, and ``bench.py``'s memory-path knobs of the SSL
modes: BENCH_USE_AC (1), BENCH_REMAT_STAGES (e.g. ``1,2``),
BENCH_INTER_OPT (adam, adafactor, fused_adafactor), BENCH_INTER_DTYPE
(float32, bfloat16) and BENCH_ACCUM (also in mode ``hooknet``), each named
in the metric as ``bench.py`` names it (``,ac``, ``,fused_adafactor``,
``,interbf16``, ``,rs12``, ``,accum2``). BENCH_PACKED_TAIL=1 runs modes
``hooknet`` and ``infer`` with decoder blocks from BENCH_PACKED_FROM (3)
in the space-to-depth domain, packed logits and the packed Dice in
``hooknet`` only, as ``bench.py:211-218``; the metric gains ``,packed``.
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
from .data.loader import synthetic_tile_library
from .data.pipeline import AugConfig, make_seg_val_views_host, target_keys
from .train import evaluate as EV
from .train import finetune as FT
from .train.ssl import SSLConfig, create_ssl_state, make_fused_step, ssl_train_step, view_seed
from .utils import prefetch_iter

__all__ = ["main"]

IMG_SIZE = 224  # the SSL views' size, as in bench.py; it names the metric
SEG_SIZE = 256  # the HookNet views' size, as in bench.py; it names the metric
EVAL_CHUNK = 128  # the evaluation CLI's --val-chunk default


def _config(arch: str, batch: int, env) -> SSLConfig:
    stages = tuple(int(s) for s in env.get("BENCH_REMAT_STAGES", "").split(",") if s)
    return SSLConfig(
        arch=arch, scale=4, batch_size=batch, amp=True,
        use_ac=env.get("BENCH_USE_AC", "0") == "1",
        inter_opt=env.get("BENCH_INTER_OPT", "adam"),
        inter_dtype=env.get("BENCH_INTER_DTYPE", "float32"),
        remat_stages=stages or None,
        accum_steps=int(env.get("BENCH_ACCUM", "1")),
    )


def _suffix(config: SSLConfig) -> str:
    """``bench.py``'s metric-name suffix of the memory-path knobs."""
    return ((",ac" if config.use_ac else "")
            + (f",{config.inter_opt}" if config.inter_opt != "adam" else "")
            + (",interbf16" if config.inter_dtype == "bfloat16" else "")
            + (f",rs{''.join(map(str, config.remat_stages))}" if config.remat_stages else "")
            + (f",accum{config.accum_steps}" if config.accum_steps > 1 else ""))


def _ssl_mode(mode, arch, batch, env, dev, rng, img_size):
    """(run(i) -> metrics, metric name, items per step) of an SSL mode."""
    config = _config(arch, batch, env)
    K = config.scale**2
    state = create_ssl_state(config, device=dev)
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
            return ssl_train_step(state, views, config.fuser_weights, amp=config.amp,
                                  accum_steps=config.accum_steps)

    metric = (f"ssl_pretrain_e2e_tile_views_per_sec_per_chip[{arch},b{batch},scale4,"
              f"{IMG_SIZE}px,{mode}{_suffix(config)}]")
    return run, metric, batch * (2 + 2 * K), "tile views"


def _hooknet_mode(mode, arch, batch, env, dev, rng, seg_size):
    """(run(i) -> metrics, metric name, items per step) of a HookNet mode."""
    packed = env.get("BENCH_PACKED_TAIL", "0") == "1"
    accum = int(env.get("BENCH_ACCUM", "1")) if mode == "hooknet" else 1
    config = FT.FinetuneConfig(arch=arch, batch_size=batch, amp=True, accum_steps=accum,
                               packed_tail=packed, packed_logits=packed and mode == "hooknet",
                               packed_from=int(env.get("BENCH_PACKED_FROM", "3")))
    suffix = ",packed" if packed else ""
    state = FT.create_finetune_state(config, device=dev)
    if mode == "hooknet":
        aug_cfg = AugConfig(seg_size=seg_size, compute_dtype="bfloat16")
        src = 4 * seg_size  # 1024 px source tiles
        imgs = torch.from_numpy(rng.integers(0, 255, (batch, src, src, 3), np.uint8)).to(dev)
        masks = torch.from_numpy(rng.integers(0, config.num_classes, (batch, src, src),
                                              np.uint8)).to(dev)
        step = FT.make_fused_finetune_step(config, aug_cfg, device=dev)
        gen = torch.Generator(device=dev)

        def run(i):
            gen.manual_seed(view_seed(1, 0, i))
            return step(state, imgs, masks, gen)

        metric = (f"hooknet_finetune_pairs_per_sec_per_chip[{arch},b{batch},{SEG_SIZE}px"
                  + (f",accum{accum}" if accum > 1 else "") + suffix + "]")
        return run, metric, batch, "pairs"

    C = config.num_fg  # foreground classes, as in the eval CLIs
    S = seg_size

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    ctx, tgt = normal(batch, S, S, 3), normal(batch, S, S, 3)
    masks = torch.from_numpy(rng.integers(0, C + 1, (batch, S, S)).astype(np.int32)).to(dev)
    stats = EV.make_chunk_stats(state.model, C, amp=True)
    acc = torch.zeros((4, C), dtype=torch.int64, device=dev)

    def run(i):
        nonlocal acc
        acc = stats(ctx, tgt, masks, acc)
        return {"loss": acc[0, 0]}  # the sync reads the counts

    metric = f"hooknet_inference_tiles_per_sec_per_chip[{arch},chunk{batch},{SEG_SIZE}px{suffix}]"
    return run, metric, batch, "tiles"


def _eval_e2e_mode(arch, tiles_per_slide, dev, seg_size, n_slides):
    """(run(i) -> metrics, metric name, items per step) of ``eval_e2e``:
    step i validates slide i % 2 of a synthetic library, its host views
    made ahead on a background thread (``n_slides`` in all)."""
    classes = ("a", "b", "c", "d", "e")
    config = FT.FinetuneConfig(arch=arch, class_names=classes)
    state = FT.create_finetune_state(config, device=dev)
    cfg = AugConfig(seg_size=seg_size)  # fp32 views, as bench.py's; the model runs in bf16
    C = len(classes)
    stats = EV.make_chunk_stats_hostviews(state.model, C, cfg, amp=True)
    imgs, masks, slide_ids = synthetic_tile_library(
        n_slides=2, tiles_per_slide=tiles_per_slide, tile_size=4 * seg_size, num_classes=C,
        seed=0)
    slides = [(imgs[slide_ids == s], masks[slide_ids == s]) for s in np.unique(slide_ids)]
    views = prefetch_iter(make_seg_val_views_host(*slides[i % len(slides)], cfg)
                          for i in range(n_slides))

    def run(i):
        micro, _ = EV.validate_slide_hostviews(stats, *next(views), num_classes=C,
                                               chunk=EVAL_CHUNK, device=dev)
        return {"loss": micro["f1"]}  # the slide's fetch has synchronized

    metric = f"eval_cli_e2e_source_tiles_per_sec[{arch},{tiles_per_slide}t/slide,hostviews]"
    return run, metric, tiles_per_slide, "tiles"


def main(argv=None, env=os.environ, img_size: int = IMG_SIZE, seg_size: int = SEG_SIZE) -> dict:
    """Run the bench with the ``BENCH_*`` knobs of ``env``; returns the
    last line's fields with each window's rate, the quartiles and the peak
    memory. ``img_size`` / ``seg_size`` are the SSL / HookNet views' sizes:
    bench.py's 224 / 256, smaller only in CPU tests (the metric's name keeps
    bench.py's)."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    arch = env.get("BENCH_ARCH", "resnet18")
    batch = int(env.get("BENCH_BATCH", "32"))
    iters = int(env.get("BENCH_ITERS", "20"))
    warmup = int(env.get("BENCH_WARMUP", "3"))
    repeats = int(env.get("BENCH_REPEATS", "5"))
    mode = env.get("BENCH_MODE", "pipeline")
    if mode not in ("pipeline", "step", "hooknet", "infer", "eval_e2e"):
        raise ValueError(f"unknown BENCH_MODE {mode!r}")
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    if mode in ("pipeline", "step"):
        run, metric, per_step, unit = _ssl_mode(mode, arch, batch, env, dev, rng, img_size)
    elif mode == "eval_e2e":
        run, metric, per_step, unit = _eval_e2e_mode(arch, batch, dev, seg_size,
                                                     warmup + repeats * iters)
    else:
        run, metric, per_step, unit = _hooknet_mode(mode, arch, batch, env, dev, rng, seg_size)

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
        rates.append(per_step * iters / dt)
        print(f"window {r + 1}/{repeats}: {iters} steps in {dt:.4f} s, {rates[-1]:.2f} {unit}/s, "
              f"{1e3 * dt / iters:.2f} ms/step, loss {loss:.6f}", flush=True)
    q1, median, q3 = (statistics.quantiles(rates, n=4) if len(rates) > 1
                      else (rates[0], rates[0], rates[0]))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"{mode} on {name}: median {median:.2f} {unit}/s, quartiles {q1:.2f} / {q3:.2f} "
          f"over {repeats} windows of {iters} steps; peak memory "
          + (f"{peak / 2**30:.2f} GiB" if peak is not None else "not measured (cpu)"), flush=True)
    line = {"metric": metric, "value": median, "unit": "tiles/sec/chip"}
    print(json.dumps(line), flush=True)
    return {**line, "rates": rates, "q1": q1, "q3": q3, "peak_bytes": peak, "device": name}


if __name__ == "__main__":
    main()
    sys.exit(0)
