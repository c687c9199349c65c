#!/usr/bin/env python3
"""Smoke of the PyTorch/H100 port (``msfwsi_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each logged with a timestamp:

1. device: the card's name, and its name and power limit as nvidia-smi
   gives them;
2. build: every kernel of ``msfwsi_tpu_torch/csrc`` compiled with nvcc;
3. kernel: ``blur_or_sharpen_fused`` against its plain PyTorch version at
   the main path's shapes, (32,224,224,3) and (32,1024,1024,3), in bf16 and
   fp32 (and fp16 at 224), with all three selectors present; kernel and
   plain times by CUDA events (median of 20, the device's time: a spin
   kernel hides the host's launch latency) beside the bound, and the
   kernel's time per call as a caller sees it, host included (``host_ms``);
   then one more timed row at (32,1024,1024,3) bf16 with the SSL step's
   mix of selectors (16 passthrough, 8 blur, 8 sharpen);
4. small: the view pipeline and one fp32 train step on the card against the
   same inputs and weights on the CPU, at a small size, and the encoder's
   features bf16 under autocast;
5. slice: the fused SSL pretrain step (resnet18, b32, scale 4 so K=16,
   224 px views from 1024 px uint8 tiles, bf16 amp) for 2 warm-up and 5
   timed steps: finite loss, 4 kernel launches per step, tile views/s
   (B*steps*(2+2K)/seconds) and peak memory; then 3 more steps traced by
   ``torch.profiler``: ms/step, the device's busy share and the CUDA time
   by kernel;
6. blur: the standalone 23-tap blur kernel against its plain version at
   (32,224,224,3) and (32,1024,1024,3) in fp32 and bf16 (and fp16 at 224),
   each batch holding all three drawn kernel sizes; kernel, plain and cuDNN
   (reflect pad + two depthwise convolutions) times, L2 cold, beside the
   bound, and the kernel's ``host_ms``; then the path, ``gaussian_blur(..., use_kernel=True)`` on the
   slice's (32,1024,1024,3) tiles as fp32: one launch, finite output in
   [0, 1], equal to the plain version on the same taps;
7. probe: the layout probe entry point once per probe (P1, P2, P3), each
   case's kernel equal to its plain version bit for bit, then the 20 cases
   timed (kernel, plain, one PyTorch expression, each over copies of the
   input rotated so that every call reads its own bytes from device memory,
   and the kernel's ``host_ms``) beside the bound; and its max over every
   pair of special values (signed zeros, subnormals, infinities, NaNs) bit
   for bit against its element-wise rule;
8. edges: both stencil kernels (K1, K2) against their plain versions at
   edge shapes (K2 with strips of 1, 3 and 6 chunks): the minimum sizes,
   N = 1, rows whose bytes are not a multiple of 16 and an input that does
   not start on a 16-byte boundary (the element-wise path), border,
   interior and ragged tiles and strips; each batch (or, for N < 3, each of three
   runs) holds all three selectors / kernel sizes; passthrough samples
   bit for bit;
9. datapath: the port's tile decoder built with g++ (whether libjpeg and
   libpng headers were found), 64 smooth 1024 px RGB PNG tiles written by
   the port's own writer (rows cycling through filters 0-4) with a
   BCSS-style ``data.csv``, decoded bit for bit equal to the written
   arrays; the decode rate at the loader's thread count and the
   host-to-device time of one batch; two loader epochs onto the card,
   every device batch equal to its host batch;
10. cli: ``ssl_train.main`` in-process (resnet18, b32, scale 4, amp, BCSS,
   2 epochs of 2 steps, a checkpoint each epoch): finite epoch losses, both
   checkpoints on disk, K1 4 launches a step; a resume from
   ``checkpoint_0000.pth.tar`` whose model and Adam state equal the saved
   ones; a run from a ``--packed-cache``; the CLI's tile views/s from PNG
   and from the pack (from each epoch's first batch in hand) beside phase
   "slice"'s, and the first batch's fill apart;
11. bench: the port bench (``python -m msfwsi_tpu_torch.bench``) in mode
   ``step`` for a few iterations;
12. finetune: one fp32 fine-tuning step (resnet10, 64 px views, b4) on the
   card against the same inputs, view parameters and weights on the CPU
   (the loss, and the gradients parameter by parameter), and the decoder's convolutions taking bf16 under autocast; then the
   fused fine-tuning step at full width (resnet18 HookNet, b64, 256 px
   context and target views from (64,1024,1024,3) uint8 tiles and
   (64,1024,1024) masks in 6 classes, bf16 amp, Dice lam 1, Adam) for 2
   warm-up and 5 timed steps: finite loss, no kernel launch (the seg views
   draw no blur or sharpen), pairs/s (B*steps/seconds), ms/step and peak
   memory; then 3 steps traced by ``torch.profiler``;
13. packed: the packed decoder tail at full width (resnet18 HookNet, b64,
   256 px views of (64,1024,1024,3) tiles): one train-mode forward and
   backward against the unpacked decoder on the same model (lam 0.5), in
   fp32 with TF32 off and under bf16 autocast, both logits, the loss,
   every parameter's gradient and the running stats within
   ``diag/packed_check.py``'s bounds (those the CPU tests measured);
   ``dice_loss_packed`` against ``dice_loss`` on (64,256,256,6) fp32 and
   bf16 logits, value and gradient; the fused fine-tuning step packed
   (packed logits, packed Dice) and unpacked from the same weights, 2
   warm-up steps each, then 8 windows of 10 steps in turns (unpacked,
   packed, packed, unpacked, twice): the median ms/step, pairs/s and peak
   memory beside the
   nvidia-smi line, and 2 traced steps of each (busy share, top kernels);
   no kernel launch on either path;
14. ft_cli: ``ssl_finetune.main`` in-process on the datapath's tiles, which
   gain grey mask PNGs and a validation slide of 16 tiles: from phase
   "cli"'s ``checkpoint_0001.pth.tar``, the branch encoders equal the
   checkpoint's bit for bit before any step; then resnet18, amp, b16, 2
   epochs of 2 steps through the packed tail (the CLI's default), a validation each epoch: finite losses, scores in
   [0, 1], a ``best_ft_model.pth.tar`` equal to the model saved; a run with
   ``--val-views device``; host and device views on one model scoring
   alike; the CLI's pairs/s (from each epoch's first batch in hand, the
   fill apart) beside phase "finetune"'s;
15. eval_cli: ``evaluate.main`` in-process on phase "ft_cli"'s
   ``best_ft_model.pth.tar`` and validation slide, with its ``--amp``,
   ``--seg-size 256`` and chunk 128: every summary score within 1e-6 of a
   validation of the same model with fp32 views (the CLI's, as the JAX
   tool's) run in the phase; that validation with bf16 views (the
   fine-tuning's) gives the micro F1 of the best epoch that phase "ft_cli"
   recorded within 1e-6; then ``--val-views device`` (scores within 1e-3,
   the views differ by design); no kernel launch;
16. predict: ``predict.main`` at full width (resnet18 HookNet, 1024 px
   tiles, chunk 128, ``--head both --stitch``) on the validation slide's
   tiles and a 4096 px raw slide PNG that they tile: per-tile and stitched
   palette PNGs, the target masks read back through the port's decoder
   and scored on the host equal to phase "eval_cli"'s counts exactly;
   tiles/s and peak memory; one 128-tile chunk traced by the profiler; no
   kernel launch;
17. features: ``extract_features.main`` from phase "cli"'s
   ``checkpoint_0001.pth.tar`` (resnet18, scale 4, chunk 32, ``--amp``) on
   both sides of fold 0: float16 features of the spec's shapes, the
   context features within bf16's 2e-2 (relative to 1 + |x|) of an fp32
   forward of the checkpoint's encoder, then ``linear_probe.main`` on them
   with finite scores; tiles/s and peak memory; no kernel launch;
18. bench eval_e2e: the port bench in mode ``eval_e2e`` at 32 tiles a
   slide for a few slides; no kernel launch;
19. prepare: ``make_synthetic_slides.main`` (3 BCSS region PNGs at 4096
   px, institutions OL, A1, A2) and ``bcss_prepare.main`` at the recipe's
   ``-s 1024 --overlap 512``, on a machine without PIL: ``data.csv``'s
   columns, all four variants, every tile and mask decoded by the port's
   decoder, masks in 0-5 and none empty, unmasked pixels 0; tiles/s; then
   ``ssl_train.main`` on the prepared root (resnet18, b32, amp, fold 0, 1
   epoch of 2 steps): a finite loss, K1 4 launches a step;
20. serving: ``export_serving.main`` on phase "ft_cli"'s best model at the
   JAX tool's defaults (resnet18, chunk 128, 256 px, ``--amp``), the
   artifact loaded on the card and run on one 128-tile chunk of the
   validation slide's fp32 views: int32, equal to the eager model's argmax
   but where its two largest logits lie within bf16's 2e-2 (counted);
   tiles/s of the artifact and of the eager forward, peak memory; no
   kernel launch;
21. encoders: resnet50 and resnext50_32x4d in fp32 (b2, 64 px views) on
   the card against the CPU: with every residual branch active, eval-mode
   features and gradients parameter by parameter; a train step's loss and
   running stats (those against a float64 forward); the fused SSL step at resnet50's full width (b8, scale 4, bf16 amp, 2
   warm-up and 3 timed steps): finite loss, K1 4 launches a step, tile
   views/s, peak memory and its part held before the first step; one fused
   HookNet fine-tuning step at resnext50_32x4d (b16, 256 px), no launch;
22. memory: the large-model memory path. resnet50 SSL at full width and
   the recipe's b32 (scale 4, bf16 amp) as 2 microbatches, the fused
   outer-product Adafactor on bf16 fuser heads: 2 warm-up and 3 timed
   steps, finite loss, K1 8 launches a step (4 a microbatch), no dense head
   gradient, tile views/s, peak memory and the part held between steps, 1
   step traced; the same model with ``use_ac`` on stages 1-2: a lower
   peak; at resnet10 on the card (fp32): fused against plain Adafactor
   over 3 steps, accum 2 on a duplicated batch against accum 1, remat's
   gradients and running stats against none; ``ssl_train.main`` with
   ``--accum-steps 2 --inter-opt fused_adafactor --inter-dtype bfloat16``
   at resnet18 b32 (2 epochs of 1 step on the datapath's tiles, K1 8 a
   step) and a resume whose model and optimizer states equal the
   checkpoint's; one fused HookNet fine-tuning step at resnet18 b64,
   accum 2, no launch;
23. distributed, in two child processes with their own time limits: (a)
   ``ssl_train.main`` with the recipe's ``--multiprocessing-distributed
   --world-size 1 --rank 0`` (resnet18, b32, scale 4, amp, 7 epochs of 1
   step): an NCCL group of one formed, K1 4 launches a step, the losses
   within bf16's 2e-2 of the same run without the flags, tile views/s over
   the last 6 steps beside phase "slice"'s; (b) two ranks on the one card
   over gloo (NCCL takes one rank a device): which collectives gloo takes
   on CUDA tensors, then at resnet10 b8 (fp32, TF32 off, cuDNN
   deterministic) the fused SSL step at accum 1 and 2, the fused Adafactor
   on bf16 heads, ``--model-parallel 2`` with Adam and with the fused
   Adafactor, and a HookNet step with a wrap-padded trailing batch, each
   against one process at the global batch on the card under the CPU
   tests' bounds (the fused Adafactor's ``v_row`` / ``v_col`` after the
   step too), and the SSL step under amp on bf16 views (K1 4 launches a
   rank; held to Adam's one-step bound);
24. the kernels JSON line (each kernel's count on every path: 0 on the
   fine-tuning paths, packed (``packed_check``, ``packed_step``) and not,
   and the inference and serving paths, K1's on the SSL runs and on
   each rank of the distributed ones), then the result line.

Any failed phase ends the run with a non-zero exit and no result line. A
watchdog dumps the stacks and exits if the run hangs. Without a CUDA device
the script exits non-zero at once.
"""

from __future__ import annotations

import faulthandler
import json
import logging
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

# A hang must end in a traceback well before any outer time limit (1200 s):
# the whole run, build and profile included, took 421.6-464.7 s on an H100
# at 700 W, 414.0-523.2 s with phase "packed"; the margin is for a slower
# host or a card capped below 700 W.
WATCHDOG_S = 720
T0 = time.perf_counter()

MAIN_SHAPES = ((32, 224, 224, 3), (32, 1024, 1024, 3))
EDGE_SHAPES = {
    "blur_or_sharpen_fused": ((1, 16, 16, 3), (3, 17, 23, 3), (3, 40, 72, 3), (2, 1000, 1016, 3)),
    "separable_blur_nhwc": ((1, 12, 12, 3), (2, 13, 29, 3), (3, 40, 72, 3), (2, 1000, 1016, 3)),
}
TOLERANCE = {"float32": 1e-5, "bfloat16": 2e-2, "float16": 2e-2}
# fp32 backwards, card against CPU: the worst parameter's gradient distance
# relative to its norm. On an H100 4.3e-3 (resnet10 HookNet train step),
# 4.4e-3 (resnet50 SSL, eval mode) and 1.2e-4 (resnext50_32x4d), each at a
# BatchNorm bias, whose gradient is a sum that cancels; the CPU's own stand
# up to 3.7e-3 from a float64 backward's. A wrong backward is off by O(1).
GRAD_BOUND = 2e-2
# the eval-mode pooled features of those encoders, relative to their largest
# value: 2.4e-6 at most on an H100 (the CPU's stand 9.9e-7 from float64)
ENC_FEATURE_BOUND = 1e-5


def log(phase: str, msg: str) -> None:
    stamp = time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime())
    print(f"[{stamp} +{time.perf_counter() - T0:7.1f}s] {phase}: {msg}", flush=True)


def kernel_bound_ms(img, sel) -> tuple[float, str]:
    """Least time the card could take for one blur-or-sharpen launch on
    these inputs: the image read once and written once (plus the per-sample
    parameters) at the HBM rate, against the fp32 FMAs that this run's
    selectors ask for (2x17 per element for a blurred sample, 9 for a
    sharpened one) at the fp32 peak."""
    from msfwsi_tpu_torch.diag.timing import bound_ms

    N, H, W, C = img.shape
    nbytes = 2 * img.numel() * img.element_size() + N * (17 + 9 + 1) * 4
    per_sample = H * W * C
    n_blur = int((sel == 1).sum())
    n_sharp = int((sel == 2).sum())
    flops = per_sample * (n_blur * 2 * 17 * 2 + n_sharp * 9 * 2)
    return bound_ms(nbytes, flops)


def phase_device():
    import torch

    name = torch.cuda.get_device_name(0)
    log("device", f"{name}, {torch.cuda.device_count()} visible, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    return name, line


def phase_build():
    from msfwsi_tpu_torch import _build

    t = time.perf_counter()
    libs = _build.build_all()
    secs = time.perf_counter() - t
    log("build", f"{len(libs)} kernel librar{'y' if len(libs) == 1 else 'ies'} in {secs:.2f} s: "
        + ", ".join(p.name for p in libs.values()))
    return secs


def phase_kernel(dev, shapes=MAIN_SHAPES):
    """Hold the kernel against its plain version; returns per-case rows."""
    import torch

    from msfwsi_tpu_torch.diag.timing import cuda_time_ms, host_time_ms
    from msfwsi_tpu_torch.ops import augment as A
    from msfwsi_tpu_torch.ops.cuda import colorops as K

    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [(s, torch.bfloat16) for s in shapes] + [(s, torch.float32) for s in shapes]
    cases.append((shapes[0], torch.float16))
    rows, failures = [], []
    for shape, dt in cases:
        N = shape[0]
        img = torch.rand(shape, generator=gen, device=dev).to(dt)
        taps = A.sample_blur_taps(gen, N, kmax=K.KMAX17)
        sharp = A.sample_sharpen_kern(gen, N)
        sel = (torch.arange(N, device=dev) % 3).to(torch.int32)  # all three ops
        out = K.blur_or_sharpen_fused(img, taps, sharp, sel)
        torch.cuda.synchronize()
        ref = K.blur_or_sharpen_fused_ref(img, taps, sharp, sel)
        torch.cuda.synchronize()
        if out.shape != img.shape or out.dtype != img.dtype or not bool(out.isfinite().all()):
            failures.append(f"{shape} {dt}: bad output {tuple(out.shape)} {out.dtype}")
        err = float((out.float() - ref.float()).abs().max())
        dtype = str(dt).replace("torch.", "")
        tol = TOLERANCE[dtype]
        ms = cuda_time_ms(lambda: K.blur_or_sharpen_fused(img, taps, sharp, sel))
        plain_ms = cuda_time_ms(lambda: K.blur_or_sharpen_fused_ref(img, taps, sharp, sel))
        host_ms = host_time_ms(lambda: K.blur_or_sharpen_fused(img, taps, sharp, sel))
        bound_ms, bound_by = kernel_bound_ms(img, sel)
        row = {"shape": list(shape), "dtype": dtype, "max_abs_err": err, "atol": tol,
               "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by}
        rows.append(row)
        log("kernel", json.dumps(row))
        if not err <= tol:
            failures.append(f"{shape} {dtype}: max |kernel - plain| {err} > {tol}")
        del img, out, ref
    # The SSL step's own mix: apply with p = 0.5, then blur or sharpen 50/50.
    shape, N = shapes[-1], shapes[-1][0]
    img = torch.rand(shape, generator=gen, device=dev).to(torch.bfloat16)
    taps = A.sample_blur_taps(gen, N, kmax=K.KMAX17)
    sharp = A.sample_sharpen_kern(gen, N)
    mix = torch.tensor([0] * (N // 2) + [1] * (N // 4) + [2] * (N - N // 2 - N // 4))
    sel = mix[torch.randperm(N, generator=torch.Generator().manual_seed(0))].to(dev, torch.int32)
    err = float((K.blur_or_sharpen_fused(img, taps, sharp, sel).float()
                 - K.blur_or_sharpen_fused_ref(img, taps, sharp, sel).float()).abs().max())
    bound_ms, bound_by = kernel_bound_ms(img, sel)
    row = {"shape": list(shape), "dtype": "bfloat16", "mix": "16 passthrough, 8 blur, 8 sharpen",
           "max_abs_err": err, "atol": TOLERANCE["bfloat16"],
           "ms": cuda_time_ms(lambda: K.blur_or_sharpen_fused(img, taps, sharp, sel)),
           "host_ms": host_time_ms(lambda: K.blur_or_sharpen_fused(img, taps, sharp, sel)),
           "plain_ms": cuda_time_ms(lambda: K.blur_or_sharpen_fused_ref(img, taps, sharp, sel)),
           "bound_ms": bound_ms, "bound_by": bound_by}
    rows.append(row)
    log("kernel", json.dumps(row))
    if not err <= TOLERANCE["bfloat16"]:
        failures.append(f"{shape} bfloat16, step mix: max |kernel - plain| {err}")
    del img
    if failures:
        raise AssertionError("blur_or_sharpen_fused disagrees with its plain version: "
                             + "; ".join(failures))
    return rows


def _to(tree, dev):
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return type(tree)(_to(v, dev) for v in tree)


def phase_small(dev):
    """The view pipeline and one fp32 train step on ``dev`` against the CPU,
    on the same tiles, view parameters and weights (TF32 off: fp32 sums in
    another order differ by ~1e-6 relative, so views are held to 1e-4 and
    the loss to a relative 1e-3)."""
    import copy

    import numpy as np
    import torch

    from msfwsi_tpu_torch.data.pipeline import AugConfig, make_ssl_views, sample_ssl_views
    from msfwsi_tpu_torch.train.ssl import SSLConfig, create_ssl_state, ssl_train_step

    config = SSLConfig(arch="resnet10", scale=2, batch_size=4, amp=False)
    aug = AugConfig(img_size=32, grid=2, tile_px=32)
    tiles = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (4, 64, 64, 3), np.uint8))
    params = sample_ssl_views(torch.Generator().manual_seed(1), 4, (64, 64), aug)
    views = {d: make_ssl_views(tiles.to(d), aug, params=_to(params, d)) for d in ("cpu", dev)}
    err = max(float((views[dev][k].cpu().float() - v.float()).abs().max())
              for k, v in views["cpu"].items())
    log("small", f"views on the card vs the CPU: max abs diff {err:.3g}")
    if not err <= 1e-4:
        raise AssertionError(f"views differ between the card and the CPU by {err}")

    cpu_state = create_ssl_state(config, device="cpu")
    dev_state = create_ssl_state(config, device=dev, model=copy.deepcopy(cpu_state.model))
    batch = make_ssl_views(tiles, aug, params=params, shuffle_views=config.shuffle_views)
    old = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        loss_cpu = float(ssl_train_step(cpu_state, batch, config.fuser_weights)["loss"])
        loss_dev = float(ssl_train_step(dev_state, _to(batch, dev), config.fuser_weights)["loss"])
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old
    log("small", f"fp32 train step loss: card {loss_dev:.8f}, cpu {loss_cpu:.8f}")
    if not (math.isfinite(loss_dev) and math.isclose(loss_dev, loss_cpu, rel_tol=1e-3)):
        raise AssertionError(f"train-step loss on the card {loss_dev} vs the CPU {loss_cpu}")
    # under amp every activation stays bf16, as at dtype bf16 in JAX
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        feats = dev_state.model.context_encoder(batch["context1"].to(dev).bfloat16())
    dtypes = sorted({str(f.dtype) for f in feats})
    log("small", f"encoder features under autocast: {dtypes}")
    if dtypes != ["torch.bfloat16"]:
        raise AssertionError(f"encoder features under bf16 autocast are {dtypes}")


def _busy_us(events) -> float:
    """Length of the union of the device kernel intervals (us)."""
    busy, end = 0.0, -1.0
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in events):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


MMA_NAMES = ("conv", "xmma", "gemm", "gemv", "cutlass", "cudnn")
LAYOUT_NAMES = ("nchwtonhwc", "nhwctonchw", "transpose")


TRACE_WINDOW = "traced_steps"


def _gaps(spans, lo, hi, min_us):
    """The gaps of at least ``min_us`` in [lo, hi] between the union of
    ``spans``."""
    gaps, end = [], lo
    for s, e in sorted(spans):
        if s - end >= min_us:
            gaps.append((end, s))
        end = max(end, e)
    if hi - end >= min_us:
        gaps.append((end, hi))
    return gaps


def profile_steps(step, steps, top=25, warmup=0):
    """Trace ``warmup`` + ``steps`` calls of ``step`` with torch.profiler
    and read the last ``steps``: log the wall time per step, the device's
    busy share (the union of kernel intervals over the traced wall time),
    the CUDA time by kernel (the ``top`` kernels) and the host's side: aten
    ops and CUDA runtime calls per step (count and host time by call) and
    the device's idle gaps of 1 ms or more, each with the shortest host
    event that spans it. Returns these numbers and the convolutions'
    share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(warmup):
            float(step()["loss"])
        torch.cuda.synchronize()
        with record_function(TRACE_WINDOW):
            t0 = time.perf_counter()
            for _ in range(steps):
                metrics = step()
            float(metrics["loss"])
            wall_s = time.perf_counter() - t0
    events = prof.events()
    window = next(e for e in events if e.name == TRACE_WINDOW and e.device_type == DeviceType.CPU)
    lo, hi = window.time_range.start, window.time_range.end
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False) and lo <= e.time_range.start <= hi]
    if not kernels:
        raise AssertionError("the profiler recorded no device events")
    busy_s = _busy_us(kernels) * 1e-6
    log("profile", f"{1e3 * wall_s / steps:.1f} ms/step over {steps} traced steps"
        f"{f' after {warmup} traced warm-up' if warmup else ''}, device busy "
        f"{100 * busy_s / wall_s:.1f}% ({1e3 * busy_s / steps:.1f} ms/step of kernels)")
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    total = sum(by_name.values())
    mma = sum(us for name, us in by_name.items() if any(k in name.lower() for k in MMA_NAMES))
    log("profile", f"convolution and matmul kernels (cuDNN, cuBLAS): {mma / 1e3 / steps:.3f} "
        f"ms/step ({100 * mma / total:.2f}% of the kernels' time)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log("profile", f"{us / 1e3 / steps:9.3f} ms/step {100 * us / total:6.2f}%  {name[:110]}")
    host = [e for e in events if e.device_type == DeviceType.CPU and e is not window
            and lo <= e.time_range.start <= hi]
    aten = sum(1 for e in host if e.name.startswith("aten::"))
    runtime: dict[str, list] = {}
    for e in host:
        if e.name.startswith("cu"):
            c = runtime.setdefault(e.name, [0, 0.0])
            c[0] += 1
            c[1] += e.time_range.elapsed_us()
    runtime = {k: (n / steps, us / 1e3 / steps) for k, (n, us) in runtime.items()}
    log("profile", f"host: {aten / steps:.0f} aten ops/step (nested included); CUDA runtime "
        "calls/step (count, host ms): " + ", ".join(f"{k} {n:.0f} {ms:.3f}" for k, (n, ms) in
                                 sorted(runtime.items(), key=lambda kv: -kv[1][1])[:8]))
    gaps = _gaps([(e.time_range.start, e.time_range.end) for e in kernels], lo, hi, 1000.0)
    gap_ms = sum(b - a for a, b in gaps) / 1e3
    log("profile", f"device idle gaps of 1 ms or more: {len(gaps) / steps:.1f}/step, "
        f"{gap_ms / steps:.3f} ms/step; the largest, with the shortest host event over 80% of "
        "each:")
    spans = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:5]:
        over = [e for e in host if min(e.time_range.end, b) - max(e.time_range.start, a)
                >= 0.8 * (b - a)]
        e = min(over, key=lambda e: e.time_range.elapsed_us(), default=None)
        what = "none (Python between ops)" if e is None else (
            f"{e.name} ({e.time_range.elapsed_us() / 1e3:.3f} ms)")
        spans.append(((b - a) / 1e3, what))
        log("profile", f"{(b - a) / 1e3:9.3f} ms at +{(a - lo) / 1e3:.1f} ms: {what}")
    return {"ms": 1e3 * wall_s / steps, "busy": busy_s / wall_s,
            "kernel_ms": 1e3 * busy_s / steps, "mma_share": mma / total,
            "aten_ops": aten / steps, "runtime": runtime, "gap_ms": gap_ms / steps,
            "gaps": spans, "by_name_ms": {k: us / 1e3 / steps for k, us in by_name.items()}}


def host_waits(step, reps=3):
    """The host's side of ``step`` without the profiler: the operations
    that make the host wait for the device in one step (each warns under
    ``torch.cuda.set_sync_debug_mode("warn")``; counted by Python line),
    and, from an idle queue, the time until ``step`` returns (the host's
    time to launch it) against the time until the device is done (median
    of ``reps``)."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            metrics = step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    float(metrics["loss"])
    waits: dict[str, int] = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            f = w.filename
            where = f"{f[f.find('msfwsi_tpu_torch'):] if 'msfwsi_tpu_torch' in f else f}:{w.lineno}"
            waits[where] = waits.get(where, 0) + 1
    returned, done = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step()
        returned.append(1e3 * (time.perf_counter() - t0))
        float(metrics["loss"])
        done.append(1e3 * (time.perf_counter() - t0))
    return {"waits": waits, "return_ms": statistics.median(returned),
            "done_ms": statistics.median(done)}


def phase_slice(dev, batch=32, arch="resnet18", scale=4, warmup=2, steps=5, traced=3,
                name="slice"):
    """The main path: ``make_fused_step`` at full width, then ``traced``
    steps under the profiler (none for 0). Returns its numbers, with the
    memory still held after the timed steps (``held_bytes``: weights, Adam's
    state, gradients)."""
    import numpy as np
    import torch

    from msfwsi_tpu_torch.data.pipeline import AugConfig, make_ssl_views
    from msfwsi_tpu_torch.ops.cuda import colorops as K
    from msfwsi_tpu_torch.train.ssl import SSLConfig, create_ssl_state, make_fused_step

    config = SSLConfig(arch=arch, batch_size=batch, scale=scale, amp=True)
    aug = AugConfig(grid=scale, compute_dtype="bfloat16")
    src = scale * aug.tile_px
    K_tiles = scale**2
    rng = np.random.default_rng(config.seed)
    tiles = torch.from_numpy(rng.integers(0, 256, (batch, src, src, 3), np.uint8)).to(dev)
    state = create_ssl_state(config, device=dev)
    step = make_fused_step(config, aug, device=dev)
    gen = torch.Generator(device=dev).manual_seed(config.seed)

    views = make_ssl_views(tiles, aug, gen, shuffle_views=config.shuffle_views)
    want = {"context1": (batch, 224, 224, 3), "target1_spatial": (batch * K_tiles, 224, 224, 3),
            "rev1": (batch, K_tiles)}
    for k, shape in want.items():
        v = views[k]
        if tuple(v.shape) != shape or (v.is_floating_point() and not bool(v.isfinite().all())):
            raise AssertionError(f"view {k}: shape {tuple(v.shape)} (want {shape}) or non-finite")
    del views
    log(name, f"views ok: {', '.join(f'{k} {s}' for k, s in want.items())}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.LAUNCHES = 0  # every kernel count to 0 just before the main path
    t_start = time.perf_counter()
    for i in range(warmup):
        loss = float(step(state, tiles, gen)["loss"])
        log(name, f"warm-up step {i + 1}: loss {loss:.6f}")
    t0 = time.perf_counter()
    for _ in range(steps):
        metrics = step(state, tiles, gen)
    loss = float(metrics["loss"])  # synchronizes
    dt = time.perf_counter() - t0
    launches = K.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    held = torch.cuda.memory_allocated()
    total = warmup + steps
    views_per_s = batch * steps * (2 + 2 * K_tiles) / dt
    log(name, f"{arch} b{batch}: {steps} timed steps in {dt:.3f} s ({1e3 * dt / steps:.1f} "
        f"ms/step, {total} steps {time.perf_counter() - t_start:.1f} s): loss {loss:.6f}, "
        f"{views_per_s:.1f} tile views/s/device, peak memory {peak / 2**30:.2f} GiB, "
        f"blur_or_sharpen_fused launches {launches}")
    if not math.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    if launches != 4 * total:
        raise AssertionError(f"{launches} kernel launches in {total} steps, want 4 per step")
    if traced:
        profile_steps(lambda: step(state, tiles, gen), traced)
    return {"launches": launches, "steps": total, "loss": loss, "views_per_s": views_per_s,
            "step_ms": 1e3 * dt / steps, "peak_bytes": peak, "held_bytes": held}


def blur_bound_ms(img, kern, ksize) -> tuple[float, str]:
    """Least time the card could take for one standalone blur: the image
    read once and written once (plus the taps) at the HBM rate, against 2
    fp32 FMAs per element per drawn tap (one per pass; ``ksize`` (N,) of
    19, 21 or 23) at the fp32 peak."""
    from msfwsi_tpu_torch.diag.timing import bound_ms

    N, H, W, C = img.shape
    nbytes = 2 * img.numel() * img.element_size() + kern.numel() * 4
    flops = H * W * C * 2 * 2 * int(ksize.sum())
    return bound_ms(nbytes, flops)


def cudnn_blur(img, w):
    """The yardstick: the same blur as PyTorch's convolutions compute it
    (cuDNN, or PyTorch's own depthwise kernel where it dispatches there), on
    the NCHW copy ``img`` (1, N*3, H, W) with each channel's taps ``w``
    (N*3, 23): a reflect pad (PyTorch's "reflect" is reflect-101) and two
    depthwise convolutions, three calls."""
    import torch.nn.functional as F

    NC = img.shape[1]
    x = F.pad(img, (11, 11, 11, 11), mode="reflect")
    x = F.conv2d(x, w.view(NC, 1, 23, 1), groups=NC)
    return F.conv2d(x, w.view(NC, 1, 1, 23), groups=NC)


def phase_blur(dev, shapes=MAIN_SHAPES):
    """Hold the standalone blur kernel against its plain version, then drive
    the op on the slice's tiles. Returns (per-case rows, path numbers)."""
    import numpy as np
    import torch

    from msfwsi_tpu_torch.diag.timing import cuda_time_ms, host_time_ms
    from msfwsi_tpu_torch.ops import augment as A
    from msfwsi_tpu_torch.ops.cuda import blur as K
    from msfwsi_tpu_torch.train.ssl import SSLConfig

    gen = torch.Generator(device=dev).manual_seed(1)
    cases = [(s, dt) for s in shapes for dt in (torch.float32, torch.bfloat16)]
    cases.append((shapes[0], torch.float16))
    rows, failures = [], []
    for shape, dt in cases:
        N, H, W, _ = shape
        img = torch.rand(shape, generator=gen, device=dev).to(dt)
        ksize = 19 + 2 * (torch.arange(N, device=dev) % 3)  # all three drawn sizes
        sigma = torch.rand(N, generator=gen, device=dev) * 1.9 + 0.1
        taps = A.blur_taps_from_draws(ksize, sigma, K.KMAX)
        out = K.separable_blur_nhwc(img, taps)
        ref = K.separable_blur_nhwc_ref(img, taps)
        nchw = img.permute(0, 3, 1, 2).reshape(1, N * 3, H, W).contiguous()
        w = taps.repeat_interleave(3, 0).to(dt)
        lib = cudnn_blur(nchw, w).view(N, 3, H, W).permute(0, 2, 3, 1)
        torch.cuda.synchronize()
        if out.shape != img.shape or out.dtype != img.dtype or not bool(out.isfinite().all()):
            failures.append(f"{shape} {dt}: bad output {tuple(out.shape)} {out.dtype}")
        err = float((out.float() - ref.float()).abs().max())
        dtype = str(dt).replace("torch.", "")
        tol = TOLERANCE[dtype]
        bound_ms, bound_by = blur_bound_ms(img, taps, ksize)
        row = {"shape": list(shape), "dtype": dtype, "max_abs_err": err, "atol": tol,
               "library_max_abs_diff": float((lib.float() - ref.float()).abs().max()),
               "ms": cuda_time_ms(lambda: K.separable_blur_nhwc(img, taps), cold_l2=True),
               "host_ms": host_time_ms(lambda: K.separable_blur_nhwc(img, taps)),
               "plain_ms": cuda_time_ms(lambda: K.separable_blur_nhwc_ref(img, taps),
                                        cold_l2=True),
               "library_ms": cuda_time_ms(lambda: cudnn_blur(nchw, w), cold_l2=True),
               "bound_ms": bound_ms, "bound_by": bound_by}
        rows.append(row)
        log("blur", json.dumps(row))
        if not err <= tol:
            failures.append(f"{shape} {dtype}: max |kernel - plain| {err} > {tol}")
        del img, out, ref, nchw, lib
    if failures:
        raise AssertionError("separable_blur_nhwc disagrees with its plain version: "
                             + "; ".join(failures))

    # The path: the op on the slice's 1024 px uint8 tiles, as fp32 in [0, 1].
    shape = shapes[-1]
    rng = np.random.default_rng(SSLConfig().seed)
    tiles = torch.from_numpy(rng.integers(0, 256, shape, np.uint8)).to(dev)
    x = tiles.float() / 255
    gen = torch.Generator(device=dev).manual_seed(SSLConfig().seed)
    replay = torch.Generator(device=dev)
    replay.set_state(gen.get_state())
    torch.cuda.synchronize()
    K.LAUNCHES = 0  # the count to 0 just before the path
    out = A.gaussian_blur(gen, x, use_kernel=True)
    torch.cuda.synchronize()
    launches = K.LAUNCHES
    ref = K.separable_blur_nhwc_ref(x, A.sample_blur_taps(replay, shape[0], kmax=K.KMAX))
    err = float((out - ref).abs().max())
    lo, hi = float(out.min()), float(out.max())
    log("blur", f"gaussian_blur(use_kernel=True) on {shape} fp32 tiles: {launches} launch(es), "
        f"output in [{lo:.6f}, {hi:.6f}], max |out - plain| {err:.3g}")
    if launches != 1:
        raise AssertionError(f"gaussian_blur launched the kernel {launches} times, want 1")
    if not (bool(out.isfinite().all()) and 0.0 <= lo and hi <= 1.0 and err <= TOLERANCE["float32"]):
        raise AssertionError(f"gaussian_blur output: range [{lo}, {hi}], max |out - plain| {err}")
    return rows, {"launches": launches, "shape": list(shape), "max_abs_err": err}


def phase_probe(dev):
    """The layout probe entry point once per probe, with the count at 0
    before each; then every case timed. Returns (launches by probe, rows)."""
    from msfwsi_tpu_torch.diag import layout_probe as P

    launches = {}
    for probe in ("P1", "P2", "P3"):
        P.LAUNCHES = 0  # the count to 0 just before the path
        rc = P.main(["--probe", probe])
        launches[probe] = P.LAUNCHES
        n_cases = sum(c.probe == probe for c in P.CASES)
        log("probe", f"{probe}: exit {rc}, {launches[probe]} launches for {n_cases} cases")
        if rc != 0 or launches[probe] != n_cases:
            raise AssertionError(f"layout probe {probe}: exit {rc}, {launches[probe]} launches")
    rows = P.run_probes(dev, timed=True)
    for row in rows:
        log("probe", json.dumps(row))
    bad = [r["case"] for r in rows if not r["exact"]]
    if bad or len(rows) != 20:
        raise AssertionError(f"layout probe cases not exact: {bad} ({len(rows)} rows)")
    probe_max_special_values(dev, P)
    return launches, rows


def probe_max_special_values(dev, P):
    """The probe kernel's max over every pair of special bf16 values (signed
    zeros, subnormals, infinities, NaNs with payloads), bit for bit against
    its element-wise rule: isnan(a) ? a : isnan(b) ? b : a >= b ? a : b."""
    import torch

    special = [0x0000, 0x8000, 0x0001, 0x8001, 0x007F, 0x0080, 0x3F80, 0xBF80, 0x3F81,
               0x7F80, 0xFF80, 0x7FC0, 0xFFC1, 0x7F81]
    pairs = [(a, b) for a in special for b in special]
    pairs += [(0, 0)] * (-len(pairs) % 8)
    bits = torch.tensor(pairs, dtype=torch.int32).T.contiguous().to(torch.int16)
    a, b = (v.view(torch.bfloat16).to(dev) for v in bits)
    n = a.numel() // 8
    x = torch.cat((a, b)).view(1, 1, 2 * n, 8)
    got = P.gather_op(x, "max", (1, 1, n, 8), P.Gather(), P.Gather(w=P.AxisMap(off=n)))
    want = torch.where(a.isnan(), a, torch.where(b.isnan(), b, torch.where(a >= b, a, b)))
    wrong = int((got.reshape(-1).view(torch.int16) != want.view(torch.int16)).sum())
    log("probe", f"max over {len(special)}^2 pairs of special values: {wrong} differ from the rule")
    if wrong:
        raise AssertionError(f"probe kernel's max: {wrong} special-value pairs differ")


def _misaligned(x):
    """A contiguous copy of ``x`` whose data starts one element past a
    16-byte boundary."""
    import torch

    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def phase_edges(dev):
    """Both stencil kernels against their plain versions at the edge shapes
    of ``EDGE_SHAPES``, launched through the wrappers' ``_launch`` with the
    row path that ``launch_plan`` gives those tensors (and, for the blur,
    strips of 1, 3 and 6 chunks, so strip borders fall inside small images
    too). Op samples within the tolerance, passthrough samples bit for bit.
    Returns the per-case rows."""
    import torch

    from msfwsi_tpu_torch.ops import augment as A
    from msfwsi_tpu_torch.ops.cuda import blur as K2
    from msfwsi_tpu_torch.ops.cuda import colorops as K1

    gen = torch.Generator(device=dev).manual_seed(2)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, failures = [], []
    for name, shapes in EDGE_SHAPES.items():
        fused = name == "blur_or_sharpen_fused"
        dtypes = ((torch.bfloat16, torch.float16, torch.float32) if fused
                  else (torch.float32, torch.bfloat16))
        cases = [(s, dt, False) for s in shapes for dt in dtypes]
        cases += [(shapes[2], dt, True) for dt in dtypes]  # input off a 16-byte boundary
        for shape, dt, shifted in cases:
            N = shape[0]
            x = torch.rand(shape, generator=gen, device=dev).to(dt)
            img = _misaligned(x) if shifted else x
            dtype = str(dt).replace("torch.", "")
            tol = TOLERANCE[dtype]
            err, exact, vecs = 0.0, True, set()
            for shift in range(1 if N >= 3 else 3):  # every selector / size meets every sample
                pick = (torch.arange(N, device=dev) + shift) % 3
                if fused:
                    taps = A.sample_blur_taps(gen, N, kmax=K1.KMAX17)
                    sel = pick.to(torch.int32)
                    args = (img, taps, A.sample_sharpen_kern(gen, N), sel)
                    ref = K1.blur_or_sharpen_fused_ref(*args)
                    plans = [None]
                else:
                    sigma = torch.rand(N, generator=gen, device=dev) * 1.9 + 0.1
                    args = (img, A.blur_taps_from_draws(19 + 2 * pick, sigma, K2.KMAX))
                    ref = K2.separable_blur_nhwc_ref(*args)
                    plans = [1, K2.FEW_CHUNKS, K2.STRIP_CHUNKS]
                for chunks in plans:
                    out = torch.empty_like(x)
                    if fused:
                        vec = K1.launch_plan(shape, x.element_size(), img.data_ptr(),
                                             out.data_ptr())
                        K1._launch(*args, out, vec)
                        keep = sel == 0
                        exact &= bool(torch.equal(out[keep], img[keep]))
                        done = ~keep
                    else:
                        _, vec = K2.launch_plan(shape, x.element_size(), img.data_ptr(),
                                                out.data_ptr(), sms=sms)
                        K2._launch(*args, out, (chunks, vec))
                        done = torch.ones(N, dtype=torch.bool, device=dev)
                    vecs.add(vec)
                    torch.cuda.synchronize()
                    if done.any():
                        err = max(err, float((out[done].float() - ref[done].float()).abs().max()))
            row = {"kernel": name, "shape": list(shape), "dtype": dtype, "aligned": not shifted,
                   "vec": sorted(vecs), "max_abs_err": err, "atol": tol,
                   "passthrough_exact": exact}
            rows.append(row)
            log("edges", json.dumps(row))
            if not (err <= tol and exact):
                failures.append(f"{name} {shape} {dtype} aligned={not shifted}: max |kernel - "
                                f"plain| {err} (atol {tol}), passthrough exact {exact}")
    if failures:
        raise AssertionError("stencil kernels disagree at edge shapes: " + "; ".join(failures))
    return rows


def phase_datapath(dev, tmp):
    """The tile decoder, a written PNG dataset decoded bit for bit, the
    decode rate, one batch's H2D time, and two loader epochs onto the card
    against the same loader on the host. Returns (dataset root, numbers)."""
    import numpy as np
    import torch

    from msfwsi_tpu_torch import native
    from msfwsi_tpu_torch.data.loader import TileBatchLoader
    from msfwsi_tpu_torch.diag import datapath as DP

    t = time.perf_counter()
    native.load_library()
    out = {"build_s": time.perf_counter() - t, "libjpeg": native.has_jpeg(),
           "libpng_header": native.header_found("png.h")}
    log("datapath", f"decoder built with g++ in {out['build_s']:.2f} s: libjpeg found "
        f"{out['libjpeg']}, png.h found {out['libpng_header']} (PNG is decoded on zlib)")
    root = os.path.join(tmp, "data")
    t = time.perf_counter()
    tiles = DP.smooth_tiles(64, 1024, seed=0, device=dev)
    files = DP.write_bcss_dataset(root, tiles)
    paths = [os.path.join(root, f) for f in files]
    ratio = sum(os.path.getsize(p) for p in paths) / tiles.nbytes
    log("datapath", f"wrote {len(files)} PNG tiles (1024 px RGB, filters 0-4) and data.csv in "
        f"{time.perf_counter() - t:.1f} s, {ratio:.3f} of the raw bytes")
    decoded = native.decode_batch(paths, 1024, 1024, 3, DP.NUM_THREADS)
    wrong = int((decoded != tiles).any(axis=(1, 2, 3)).sum())
    log("datapath", f"decoded {len(paths)} tiles: {wrong} differ from the written arrays")
    if wrong:
        raise AssertionError(f"{wrong} decoded tiles differ from the written ones")
    del decoded
    out["decode_tiles_per_s"] = DP.decode_rate(paths, (1024, 1024, 3))
    out["h2d_ms"] = DP.h2d_ms((32, 1024, 1024, 3), dev)
    log("datapath", f"decode {out['decode_tiles_per_s']:.1f} tiles/s at {DP.NUM_THREADS} "
        f"threads; H2D of a (32,1024,1024,3) uint8 batch {out['h2d_ms']:.3f} ms")

    on_card = TileBatchLoader(root, files, 32, seed=0, device=dev)
    on_host = TileBatchLoader(root, files, 32, seed=0, device="cpu")
    n = 0
    for epoch in range(2):
        for got, want in zip(on_card.epoch(epoch), on_host.epoch(epoch), strict=True):
            if got.device.type != "cuda" or not torch.equal(got.cpu(), want):
                raise AssertionError(f"epoch {epoch}: a device batch differs from its host batch")
            n += 1
    log("datapath", f"loader: {n} device batches over 2 epochs, each equal to its host batch")
    if n != 2 * len(on_card):
        raise AssertionError(f"loader gave {n} batches, want {2 * len(on_card)}")
    return root, out


def _tree_equal(a, b) -> bool:
    """Nested dicts and lists of tensors equal bit for bit, dtypes too."""
    import torch

    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and torch.equal(a.cpu(), b.cpu()))
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_tree_equal(x, y) for x, y in zip(a, b))
    return a == b


def _state_equal(state, payload) -> bool:
    """Whether a train state holds the model and optimizer state of a saved
    checkpoint payload, bit for bit."""
    sd = {f"module.{k}": v for k, v in state.model.state_dict().items()}
    return _tree_equal(sd, payload["state_dict"]) and _tree_equal(
        state.optimizer.state_dict(), payload["optimizer"])


def phase_cli(dev, root, tmp, slice_views_per_s):
    """The SSL CLI in-process on the datapath's tiles: train with
    checkpoints, resume, train from a pack. K1's count is set to 0 before
    each run and read after it. Returns its numbers."""
    import torch

    from msfwsi_tpu_torch import ssl_train
    from msfwsi_tpu_torch.diag import datapath as DP
    from msfwsi_tpu_torch.ops.cuda import colorops as K

    logs = os.path.join(tmp, "logs")
    out = {}
    K.LAUNCHES = 0  # the count to 0 just before the path
    res = ssl_train.main(DP.cli_argv(root, os.path.join(logs, "png"), extra=(
        "--steps-per-epoch", "2", "--save-freq", "1")))
    out["launches_png"] = K.LAUNCHES
    losses = [e["loss"] for e in res["epochs"]]
    steps = sum(e["steps"] for e in res["epochs"])
    ckpts = [os.path.join(res["log_dir"], f"checkpoint_{e:04d}.pth.tar") for e in (0, 1)]
    log("cli", f"PNG run: epoch losses {losses}, {steps} steps, K1 launches {K.LAUNCHES}, "
        f"checkpoints {[os.path.basename(c) for c in ckpts if os.path.exists(c)]}")
    if not (len(losses) == 2 and all(math.isfinite(x) for x in losses)):
        raise AssertionError(f"CLI epoch losses {losses}")
    if not all(os.path.exists(c) for c in ckpts):
        raise AssertionError(f"missing checkpoints among {ckpts}")
    if K.LAUNCHES != 4 * steps:
        raise AssertionError(f"{K.LAUNCHES} K1 launches in {steps} CLI steps, want 4 per step")
    out["png_views_per_s"] = DP.cli_rate(res, 32)
    out["png_fill_s"] = DP.cli_fill_s(res)
    out["ckpt_dir"] = res["log_dir"]
    del res

    resumed = ssl_train.main(DP.cli_argv(root, os.path.join(logs, "resume"), epochs=1, extra=(
        "--resume", ckpts[0])))
    saved = torch.load(ckpts[0], map_location="cpu", weights_only=True)
    equal = resumed["start_epoch"] == 1 and _state_equal(resumed["state"], saved)
    log("cli", f"resume from {os.path.basename(ckpts[0])}: start epoch {resumed['start_epoch']}, "
        f"model and Adam state equal to the saved ones: {equal}")
    if not equal:
        raise AssertionError("the resumed state differs from the saved checkpoint")
    del resumed, saved

    K.LAUNCHES = 0
    res = ssl_train.main(DP.cli_argv(root, os.path.join(logs, "pack"), extra=(
        "--steps-per-epoch", "2", "--packed-cache", os.path.join(tmp, "pack"))))
    out["launches_pack"] = K.LAUNCHES
    losses = [e["loss"] for e in res["epochs"]]
    steps = sum(e["steps"] for e in res["epochs"])
    if not (len(losses) == 2 and all(math.isfinite(x) for x in losses)):
        raise AssertionError(f"CLI epoch losses from the pack {losses}")
    if K.LAUNCHES != 4 * steps:
        raise AssertionError(f"{K.LAUNCHES} K1 launches in {steps} packed CLI steps")
    out["pack_views_per_s"] = DP.cli_rate(res, 32)
    out["pack_fill_s"] = DP.cli_fill_s(res)
    del res
    log("cli", f"tile views/s: CLI from PNG {out['png_views_per_s']:.1f}, from the pack "
        f"{out['pack_views_per_s']:.1f} (epoch 2, its 2 steps from the first batch in hand; "
        f"that batch's fill {out['png_fill_s']:.3f} / {out['pack_fill_s']:.3f} s apart), "
        f"phase slice {slice_views_per_s:.1f}")
    return out


def phase_bench(dev):
    """The port bench in mode ``step`` for a few iterations."""
    from msfwsi_tpu_torch import bench

    knobs = {"BENCH_MODE": "step", "BENCH_ITERS": "3", "BENCH_WARMUP": "1", "BENCH_REPEATS": "2"}
    res = bench.main(["--device", str(dev)], env={**os.environ, **knobs})
    log("bench", f"{res['metric']}: median {res['value']:.1f}, windows {res['rates']}")
    if not (math.isfinite(res["value"]) and res["value"] > 0):
        raise AssertionError(f"bench value {res['value']}")
    return res


def _reset_counts():
    """Every kernel's launch count to 0."""
    from msfwsi_tpu_torch.diag import layout_probe as P
    from msfwsi_tpu_torch.ops.cuda import blur as K2
    from msfwsi_tpu_torch.ops.cuda import colorops as K1

    K1.LAUNCHES = K2.LAUNCHES = P.LAUNCHES = 0


def _read_counts() -> dict:
    from msfwsi_tpu_torch.diag import layout_probe as P
    from msfwsi_tpu_torch.ops.cuda import blur as K2
    from msfwsi_tpu_torch.ops.cuda import colorops as K1

    return {"K1": K1.LAUNCHES, "K2": K2.LAUNCHES, "probe": P.LAUNCHES}


def grad_distances(card, cpu, exact) -> dict:
    """The relative gradient distances ||a - b|| / ||b|| of three copies of
    one model after their backward: the card's from the CPU's, the CPU's
    from a float64 backward's and the card's from it, each as (the worst
    parameter's distance, its name)."""
    grads = [{k: p.grad.detach().cpu().double() for k, p in m.named_parameters()
              if p.grad is not None} for m in (card, cpu, exact)]
    if not grads[0].keys() == grads[1].keys() == grads[2].keys():
        raise AssertionError("the copies' parameters with a gradient differ")
    out = {}
    for pair, (a, b) in {"card-cpu": (0, 1), "cpu-f64": (1, 2), "card-f64": (0, 2)}.items():
        out[pair] = max((float((grads[a][k] - g).norm() / g.norm().clamp_min(1e-30)), k)
                        for k, g in grads[b].items())
    return out


def finetune_step_check(dev):
    """A small fp32 fine-tuning step (resnet10 HookNet, b4, 64 px) on the
    card against the CPU (TF32 off): the loss within 1e-3 relative, and
    the gradients, parameter by parameter, within ``GRAD_BOUND`` of the
    CPU's relative to their norm; a float64 backward's distance from the
    CPU's is logged beside it. Returns the card's model after the step."""
    import copy

    import numpy as np
    import torch

    from msfwsi_tpu_torch.data.pipeline import (AugConfig, make_seg_train_views,
                                                sample_seg_train_views)
    from msfwsi_tpu_torch.train import finetune as FT

    config = FT.FinetuneConfig(arch="resnet10", batch_size=4, amp=False)
    aug = AugConfig(seg_size=64)
    rng = np.random.default_rng(2)
    imgs = torch.from_numpy(rng.integers(0, 256, (4, 256, 256, 3), np.uint8))
    masks = torch.from_numpy(rng.integers(0, config.num_classes, (4, 256, 256), np.uint8))
    params = sample_seg_train_views(torch.Generator().manual_seed(2), 4, aug)
    cpu_state = FT.create_finetune_state(config, device="cpu")
    dev_state = FT.create_finetune_state(config, device=dev, model=copy.deepcopy(cpu_state.model))
    exact = copy.deepcopy(cpu_state.model).double().train()
    old = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        m_cpu = FT.make_fused_finetune_step(config, aug, "cpu")(cpu_state, imgs, masks,
                                                               view_params=params)
        m_dev = FT.make_fused_finetune_step(config, aug, dev)(dev_state, imgs, masks,
                                                             view_params=_to(params, dev))
        loss_cpu, loss_dev = float(m_cpu["loss"]), float(m_dev["loss"])
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old
    (ctx, tgt), (cm, tm) = make_seg_train_views(imgs, masks, aug, None, params=params)
    batch64 = {"context": ctx.double(), "target": tgt.double(), "context_mask": cm,
               "target_mask": tm}
    FT.finetune_loss_fn(exact, batch64, config.lam, config.num_fg)[0].backward()
    grads = grad_distances(dev_state.model, cpu_state.model, exact)
    log("finetune", f"fp32 step, resnet10 b4 64 px: loss card {loss_dev:.8f}, cpu {loss_cpu:.8f}; "
        f"worst relative gradient distance (parameter): {grads} (card-cpu bound "
        f"{GRAD_BOUND:g})")
    if not (math.isfinite(loss_dev) and math.isclose(loss_dev, loss_cpu, rel_tol=1e-3)):
        raise AssertionError(f"fine-tuning loss on the card {loss_dev} vs the CPU {loss_cpu}")
    if not grads["card-cpu"][0] <= GRAD_BOUND:
        raise AssertionError(f"fine-tuning gradients differ between card and CPU: {grads}")
    return dev_state.model


def phase_finetune(dev, batch=64, arch="resnet18", warmup=2, steps=5, traced=3):
    """The fine-tuning step: ``finetune_step_check``, then the fused step at
    full width and under the profiler. Returns its numbers."""
    import numpy as np
    import torch

    from msfwsi_tpu_torch.data.pipeline import AugConfig
    from msfwsi_tpu_torch.train import finetune as FT

    model = finetune_step_check(dev)
    # under amp every decoder convolution takes bf16, as at dtype bf16 in JAX
    seen = []
    hooks = [m.register_forward_pre_hook(lambda m, args: seen.append(str(args[0].dtype)))
             for name, m in model.named_modules()
             if ".decoder." in f".{name}." and isinstance(m, torch.nn.Conv2d)]
    x = torch.zeros((2, 64, 64, 3), device=dev)
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        model(x, x)
    for h in hooks:
        h.remove()
    log("finetune", f"decoder convolution inputs under autocast: {sorted(set(seen))}")
    if sorted(set(seen)) != ["torch.bfloat16"]:
        raise AssertionError(f"decoder convolutions under bf16 autocast take {sorted(set(seen))}")
    del model

    # the main path at full width
    config = FT.FinetuneConfig(arch=arch, batch_size=batch, amp=True)
    aug = AugConfig(compute_dtype="bfloat16")
    rng = np.random.default_rng(config.seed)
    src = 4 * aug.seg_size
    imgs = torch.from_numpy(rng.integers(0, 256, (batch, src, src, 3), np.uint8)).to(dev)
    masks = torch.from_numpy(rng.integers(0, config.num_classes, (batch, src, src),
                                          np.uint8)).to(dev)
    state = FT.create_finetune_state(config, device=dev)
    step = FT.make_fused_finetune_step(config, aug, device=dev)
    gen = torch.Generator(device=dev).manual_seed(config.seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()  # every kernel count to 0 just before the path
    t_start = time.perf_counter()
    for i in range(warmup):
        loss = float(step(state, imgs, masks, gen)["loss"])
        log("finetune", f"warm-up step {i + 1}: loss {loss:.6f}")
    t0 = time.perf_counter()
    for _ in range(steps):
        metrics = step(state, imgs, masks, gen)
    loss = float(metrics["loss"])  # synchronizes
    dt = time.perf_counter() - t0
    launches = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    pairs_per_s = batch * steps / dt
    log("finetune", f"{steps} timed steps in {dt:.3f} s ({1e3 * dt / steps:.1f} ms/step, "
        f"{warmup + steps} steps {time.perf_counter() - t_start:.1f} s): loss {loss:.6f}, "
        f"{pairs_per_s:.1f} pairs/s/device, peak memory {peak / 2**30:.2f} GiB, "
        f"kernel launches {launches}")
    if not math.isfinite(loss):
        raise AssertionError(f"non-finite fine-tuning loss {loss}")
    if any(launches.values()):
        raise AssertionError(f"the fine-tuning step launched kernels {launches}, want none")
    profile_steps(lambda: step(state, imgs, masks, gen), traced)
    return {"launches": launches, "steps": warmup + steps, "loss": loss,
            "pairs_per_s": pairs_per_s, "step_ms": 1e3 * dt / steps, "peak_bytes": peak}


def _dice_on_card(dev, dtype, batch=64, size=256, classes=6):
    """``dice_loss_packed`` on the space-to-depth of random logits against
    ``dice_loss`` on the logits, fp32 sums either way: (the value's
    relative difference, the largest gradient difference relative to the
    largest gradient, the packed gradient's dtype)."""
    import torch

    from msfwsi_tpu_torch.ops import losses as L
    from msfwsi_tpu_torch.ops import s2d

    gen = torch.Generator(device=dev).manual_seed(11)
    z = (2 * torch.randn((batch, size, size, classes), generator=gen, device=dev)).to(dtype)
    target = torch.randint(0, classes, (batch, size, size), generator=gen, device=dev)
    fg = list(range(1, classes))
    z = z.requires_grad_(True)
    want = L.dice_loss(z, target, classes=fg)
    want.backward()
    zp = s2d.space_to_depth(z.detach().permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    zp = zp.contiguous().requires_grad_(True)
    got = L.dice_loss_packed(zp, target, classes=fg)
    got.backward()
    dz = s2d.depth_to_space(zp.grad.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    scale = float(z.grad.float().abs().max())
    return (abs(float(got) - float(want)) / abs(float(want)),
            float((dz.float() - z.grad.float()).abs().max()) / scale, zp.grad.dtype)


def phase_packed(dev, smi_line, ft_out, batch=64, arch="resnet18", warmup=2, steps=10):
    """The packed decoder tail at full width (resnet18 HookNet, b64, 256 px
    views from (64,1024,1024,3) uint8 tiles, 6 classes): its train-mode
    forward and backward against the unpacked decoder on one model, in fp32
    (TF32 off) and under bf16 autocast, within ``diag/packed_check.py``'s
    bounds; ``dice_loss_packed`` against ``dice_loss``; then the fused
    fine-tuning step packed (the CLI's default) and unpacked from the same
    weights, timed in turns (unpacked, packed, packed, unpacked, twice);
    the host's waits for the device and launch time of each; then each side
    traced (three steps after a traced warm-up) in the order packed,
    unpacked, unpacked, packed. Returns its numbers and kernel counts."""
    import copy

    import numpy as np
    import torch

    from msfwsi_tpu_torch.data.pipeline import AugConfig, make_seg_train_views
    from msfwsi_tpu_torch.diag import packed_check as PC
    from msfwsi_tpu_torch.models.hooknet import build_hooknet
    from msfwsi_tpu_torch.train import finetune as FT

    out = {"launches": {}}
    base = FT.FinetuneConfig(arch=arch, batch_size=batch, amp=True)
    aug = AugConfig(compute_dtype="bfloat16")
    rng = np.random.default_rng(base.seed + 1)
    src = 4 * aug.seg_size
    imgs = torch.from_numpy(rng.integers(0, 256, (batch, src, src, 3), np.uint8)).to(dev)
    masks = torch.from_numpy(rng.integers(0, base.num_classes, (batch, src, src),
                                          np.uint8)).to(dev)
    gen = torch.Generator(device=dev)
    model = build_hooknet(torch.Generator().manual_seed(base.seed), device=dev, arch=arch,
                          classes=base.num_classes)
    (ctx, tgt), (cm, tm) = make_seg_train_views(imgs, masks, aug, gen.manual_seed(1))
    views = {"context": ctx, "target": tgt, "context_mask": cm, "target_mask": tm}

    _reset_counts()  # every kernel count to 0 just before the checks
    old = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    for kind, amp in (("fp32", False), ("bf16", True)):
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = amp
        try:
            b = {k: (v.float() if v.is_floating_point() else v) for k, v in views.items()}
            d = PC.packed_against_unpacked(copy.deepcopy(model), b, amp)
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old
        ok = PC.within_bounds(d, PC.BOUNDS[kind])
        log("packed", f"{kind}, train mode, {arch} b{batch} 256 px, packed against unpacked: "
            f"loss {d['loss']:.3g} apart, logits {d['logits']:.3g} (largest "
            f"{d['logit_max']:.3g}), gradients worst {d['grad_worst'][0]:.3g} "
            f"({d['grad_worst'][1]}), all {d['grad_all']:.3g}, running stats "
            f"{d['stats'][0]:.3g} ({d['stats'][1]}); bounds {PC.BOUNDS[kind]}: {ok}")
        if not ok:
            raise AssertionError(f"packed tail against unpacked, {kind}: {d}")
        out[kind] = d
    # bf16: both round one fp32 gradient; an ulp apart near the largest
    # element is up to 2^-7 of it (measured 6.5e-3 on the CPU): two ulps
    for kind, dtype, bound in (("fp32", torch.float32, 1e-4), ("bf16", torch.bfloat16, 2**-6)):
        rel, grad, gdtype = _dice_on_card(dev, dtype)
        log("packed", f"dice_loss_packed against dice_loss, {kind} logits (64,256,256,6): value "
            f"{rel:.3g} apart (relative, bound 1e-5), gradient {grad:.3g} of the largest (bound "
            f"{bound:g}), gradient dtype {gdtype}")
        if not (rel <= 1e-5 and grad <= bound and gdtype == dtype):
            raise AssertionError(f"dice_loss_packed on the card, {kind}: {rel}, {grad}, {gdtype}")
    out["launches"]["packed_check"] = _read_counts()

    states, step_fns = {}, {}
    for name, packed in (("unpacked", False), ("packed", True)):
        config = FT.FinetuneConfig(arch=arch, batch_size=batch, amp=True, packed_tail=packed,
                                   packed_logits=packed)
        states[name] = FT.create_finetune_state(config, device=dev,
                                                model=copy.deepcopy(model))
        step_fns[name] = FT.make_fused_finetune_step(config, aug, device=dev)
    del model
    if not states["packed"].model.emits_packed_logits:
        raise AssertionError("the packed state's model does not emit packed logits")

    def run(name, i):
        gen.manual_seed(100 + i)
        return step_fns[name](states[name], imgs, masks, gen)

    _reset_counts()  # every kernel count to 0 just before the timed path
    for name in states:
        for i in range(warmup):
            loss = float(run(name, i)["loss"])
            log("packed", f"{name} warm-up step {i + 1}: loss {loss:.6f}")
    times = {name: [] for name in states}
    peaks = {name: 0 for name in states}
    for r, name in enumerate(("unpacked", "packed", "packed", "unpacked") * 2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for i in range(steps):
            metrics = run(name, 10 * r + i)
        loss = float(metrics["loss"])  # synchronizes
        dt = time.perf_counter() - t0
        if not math.isfinite(loss):
            raise AssertionError(f"non-finite {name} fine-tuning loss {loss}")
        times[name].append(1e3 * dt / steps)
        peaks[name] = max(peaks[name], torch.cuda.max_memory_allocated())
        log("packed", f"window {r + 1} ({name}): {steps} steps in {dt:.3f} s, "
            f"{1e3 * dt / steps:.1f} ms/step, {batch * steps / dt:.1f} pairs/s, loss {loss:.6f}")
    out["launches"]["packed_step"] = _read_counts()
    for name in states:
        ms = statistics.median(times[name])
        out[name] = {"ms": ms, "pairs_per_s": 1e3 * batch / ms, "peak_bytes": peaks[name]}
        log("packed", f"{name} fused step {arch} b{batch}: median {ms:.2f} ms/step "
            f"({', '.join(f'{t:.2f}' for t in times[name])} by window), "
            f"{1e3 * batch / ms:.1f} pairs/s, peak memory {peaks[name] / 2**30:.2f} GiB, on "
            f"{smi_line}")
    ratio = out["unpacked"]["ms"] / out["packed"]["ms"]
    log("packed", f"packed against unpacked: {ratio:.3f}x the median step rate (phase finetune's "
        f"unpacked {ft_out['pairs_per_s']:.1f} pairs/s) on {smi_line}")
    for name in states:
        h = host_waits(lambda: run(name, 80))
        out[name]["host"] = h
        log("packed", f"{name}: host waits for the device in one step: "
            f"{sum(h['waits'].values())} ({h['waits'] or 'none'}); from an idle queue the step "
            f"returns after {h['return_ms']:.1f} ms, the device is done after "
            f"{h['done_ms']:.1f} ms")
    # three steps after a warm-up under the profiler, each side traced
    # first once: the later trace of a side is the one kept
    for name in ("packed", "unpacked", "unpacked", "packed"):
        log("packed", f"three traced {name} steps after a traced warm-up step:")
        trace = profile_steps(lambda: run(name, 90), 3, top=12, warmup=1)
        by_name = trace.pop("by_name_ms")
        out.setdefault("traces", []).append({"side": name, "ms": trace["ms"],
                                             "busy": trace["busy"]})
        mma = sorted(((ms, k) for k, ms in by_name.items()
                      if any(m in k.lower() for m in MMA_NAMES + LAYOUT_NAMES)), reverse=True)
        layout = sum(ms for k, ms in by_name.items() if any(m in k.lower() for m in LAYOUT_NAMES))
        log("packed", f"{name}: convolution, matmul and layout kernels "
            f"{sum(m for m, _ in mma):.3f} ms/step, of which layout transposes {layout:.3f}; "
            "the largest:")
        for ms, k in mma[:8]:
            log("packed", f"{ms:9.3f} ms/step  {k[:120]}")
        out[name]["trace"] = {**trace, "layout_ms": layout}
    if any(v for c in out["launches"].values() for v in c.values()):
        raise AssertionError(f"the packed paths launched kernels {out['launches']}, want none")
    log("packed", f"kernel launches {out['launches']}")
    return out


def phase_ft_cli(dev, root, tmp, ckpt_dir, finetune_pairs_per_s):
    """The fine-tuning CLI in-process on the datapath's tiles, from phase
    "cli"'s SSL checkpoint. Returns its numbers."""
    import numpy as np
    import torch

    from msfwsi_tpu_torch import native, ssl_finetune
    from msfwsi_tpu_torch.data import datasets as D
    from msfwsi_tpu_torch.data.loader import load_slide_arrays
    from msfwsi_tpu_torch.data.pipeline import AugConfig, make_seg_val_views_host
    from msfwsi_tpu_torch.diag import datapath as DP
    from msfwsi_tpu_torch.models.hooknet import HookNet, unpacked
    from msfwsi_tpu_torch.train import checkpoint as C
    from msfwsi_tpu_torch.train import evaluate as EV

    files = sorted(f"tiles/{f}" for f in os.listdir(os.path.join(root, "tiles")))
    tiles = native.decode_batch([os.path.join(root, f) for f in files], 1024, 1024, 3)
    DP.write_bcss_masks(root, files, (tiles[..., 0] // 43).astype(np.uint8), n_val=16)
    del tiles
    groups = D.bcss_seg_val_slides(root)
    n_train = len(D.bcss_seg_samples(root))
    log("ft_cli", f"{len(files)} tiles gained grey mask PNGs (6 classes): {n_train} to train, "
        f"validation slides {[(g.filename, len(g.samples)) for g in groups]}")
    if not (n_train == 48 and len(groups) == 1 and len(groups[0].samples) == 16):
        raise AssertionError("the fine-tuning dataset is not 48 train tiles and one slide of 16")
    ckpt = os.path.join(ckpt_dir, "checkpoint_0001.pth.tar")
    logs = os.path.join(tmp, "ft_logs")

    def argv(name, *extra):
        return ["-a", "resnet18", "-b", "16", "--amp", "--data-name", "bcss", "--train-data", root,
                "--weights", ckpt, "--seed", "0", "-p", "1", "--device", str(dev), "--log-dir",
                os.path.join(logs, name), *extra]

    out = {}
    res = ssl_finetune.main(argv("zero", "--epochs", "0"))
    ssl_sd = {k.removeprefix("module."): v for k, v in C.load_torch_file(ckpt).items()}
    equal = all(
        torch.equal(v.cpu(), ssl_sd[f"{enc}.{k}"])
        for branch, enc in (("context_branch", "context_encoder"),
                            ("target_branch", "target_encoder"))
        for k, v in getattr(res["state"].model, branch).encoder.state_dict().items())
    log("ft_cli", f"--weights {os.path.basename(ckpt)}: both branch encoders equal the SSL "
        f"checkpoint's before any step: {equal}")
    if not equal:
        raise AssertionError("the branch encoders differ from the SSL checkpoint's encoders")
    del res

    saved = {}
    real_save = C.save_best_ft_model

    def save_and_keep(log_dir, model, epoch, arch):
        saved["sd"] = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        return real_save(log_dir, model, epoch, arch)

    C.save_best_ft_model = save_and_keep
    _reset_counts()  # every kernel count to 0 just before the path
    try:
        res = ssl_finetune.main(argv("host", "--epochs", "2", "--steps-per-epoch", "2"))
    finally:
        C.save_best_ft_model = real_save
    out["launches"] = _read_counts()
    packed = res["state"].model.emits_packed_logits
    log("ft_cli", f"trained through the packed tail by default (the model emits packed "
        f"logits, packed Dice): {packed}; validation ran it unpacked")
    if not packed:
        raise AssertionError("the fine-tuning CLI did not train through the packed tail")
    epochs = res["epochs"]
    scores = [{k: e[k] for k in ("val_f1", "val_iou", "val_acc")} for e in epochs]
    log("ft_cli", f"host views: epoch losses {[e['loss'] for e in epochs]}, train F1 "
        f"{[e['train_f1'] for e in epochs]}, val micro {scores}, kernel launches "
        f"{out['launches']}")
    if not (len(epochs) == 2 and all(math.isfinite(e["loss"]) and e["steps"] == 2
                                     for e in epochs)):
        raise AssertionError(f"fine-tuning CLI epochs {epochs}")
    if not all(0.0 <= v <= 1.0 for sc in scores for v in sc.values()):
        raise AssertionError(f"validation scores out of [0, 1]: {scores}")
    if any(out["launches"].values()):
        raise AssertionError(f"the fine-tuning CLI launched kernels {out['launches']}")
    best = os.path.join(res["log_dir"], C.BEST_FT_MODEL)
    back = C.load_ft_model(best, HookNet(arch="resnet18", classes=6))
    same = all(torch.equal(v, saved["sd"][k]) for k, v in back.state_dict().items())
    log("ft_cli", f"{C.BEST_FT_MODEL} (best epoch "
        f"{max(e['epoch'] for e in epochs if e['is_best'])}) loads back equal to the model "
        f"saved: {same}")
    if not same:
        raise AssertionError("best_ft_model.pth.tar differs from the model saved")
    rates = [16 * e["steps"] / (e["seconds"] - e["fill_seconds"]) for e in epochs]
    fills = [e["fill_seconds"] for e in epochs]
    out.update(pairs_per_s=rates, fill_s=fills, val_s=[e["val_seconds"] for e in epochs],
               best_dir=res["log_dir"], best_f1=res["best"]["f1"])

    # one model, both kinds of evaluation views, unpacked as the CLI validates
    model = res["state"].model
    aug = AugConfig(seg_size=256, compute_dtype="bfloat16")
    slide = load_slide_arrays(root, groups[0])
    classes = ssl_finetune.CLASS_NAMES["bcss"]
    by_views = {}
    for views in ("host", "device"):
        stats = EV.make_chunk_stats_for_views(model, len(classes), views, aug, amp=True)
        item = make_seg_val_views_host(*slide, aug) if views == "host" else slide
        with unpacked(model):
            by_views[views] = EV.validate_slides(stats, [item], views, classes,
                                                 device=dev).summary()
    diff = max(abs(by_views["host"][k] - by_views["device"][k]) for k in by_views["host"])
    log("ft_cli", f"one model, host against device views: micro F1 "
        f"{by_views['host']['f1_micro']:.6f} / {by_views['device']['f1_micro']:.6f}, largest "
        f"score difference {diff:.3g} (the host rounds its resized context view to uint8)")
    if not diff <= 1e-3:
        raise AssertionError(f"host and device evaluation views score {diff} apart")
    del res, model

    res = ssl_finetune.main(argv("device", "--epochs", "1", "--steps-per-epoch", "2",
                                 "--val-views", "device"))
    e = res["epochs"][0]
    log("ft_cli", f"--val-views device: loss {e['loss']:.6f}, val micro F1/IoU/acc "
        f"{e['val_f1']:.6f} / {e['val_iou']:.6f} / {e['val_acc']:.6f} (the host run's epoch 0: "
        f"{scores[0]['val_f1']:.6f} / {scores[0]['val_iou']:.6f} / {scores[0]['val_acc']:.6f})")
    if not (math.isfinite(e["loss"]) and all(0.0 <= e[k] <= 1.0
                                             for k in ("val_f1", "val_iou", "val_acc"))):
        raise AssertionError(f"--val-views device epoch {e}")
    del res
    log("ft_cli", f"pairs/s: CLI {', '.join(f'{r:.1f}' for r in rates)} by epoch (from its first "
        f"batch in hand; that batch's fill {', '.join(f'{f:.3f}' for f in fills)} s apart), "
        f"phase finetune {finetune_pairs_per_s:.1f}")
    return out


def _no_launches(phase, launches):
    if any(launches.values()):
        raise AssertionError(f"phase {phase} launched kernels {launches}, want none")


def phase_eval_cli(dev, root, tmp, ft_cli_out, smi_line):
    """The evaluation CLI in-process on phase "ft_cli"'s best model and
    validation slide, with its ``--amp`` and chunk: every summary score
    within 1e-6 of a validation of the same model with the CLI's fp32 views
    run here; that validation with ft_cli's bf16 views gives ft_cli's best
    epoch within 1e-6 (the gap between the two views is logged); then
    ``--val-views device``. Returns the slide's counts and the numbers."""
    from msfwsi_tpu_torch import evaluate
    from msfwsi_tpu_torch.data import datasets as D
    from msfwsi_tpu_torch.data.loader import load_slide_arrays
    from msfwsi_tpu_torch.data.pipeline import AugConfig, make_seg_val_views_host
    from msfwsi_tpu_torch.models.hooknet import HookNet
    from msfwsi_tpu_torch.ssl_finetune import CLASS_NAMES
    from msfwsi_tpu_torch.train import checkpoint as C
    from msfwsi_tpu_torch.train import evaluate as EV

    weights = os.path.join(ft_cli_out["best_dir"], C.BEST_FT_MODEL)
    model = C.load_ft_model(weights, HookNet(arch="resnet18", classes=6)).to(dev)
    classes = CLASS_NAMES["bcss"]
    slide = load_slide_arrays(root, D.bcss_seg_val_slides(root)[0])
    direct = {}
    for dtype in ("float32", "bfloat16"):  # the CLI's views (tools/evaluate.py's), ft_cli's
        aug = AugConfig(seg_size=256, compute_dtype=dtype)
        stats = EV.make_chunk_stats_hostviews(model, len(classes), aug, amp=True)
        direct[dtype] = EV.validate_slides(stats, [make_seg_val_views_host(*slide, aug)], "host",
                                           classes, chunk=128, device=dev).summary()
    del model, stats, slide
    out = {}
    for views in ("host", "device"):
        argv = ["-a", "resnet18", "--amp", "--seg-size", "256", "--val-chunk", "128",
                "--data-name", "bcss", "--train-data", root, "--weights", weights, "--device",
                str(dev), "--val-views", views, "--log-dir", os.path.join(tmp, "eval", views)]
        _reset_counts()  # every kernel count to 0 just before the path
        t = time.perf_counter()
        res = evaluate.main(argv)
        seconds = time.perf_counter() - t
        launches = _read_counts()
        s = res["summary"]
        log("eval_cli", f"--val-views {views}: micro F1/IoU/acc {s['f1_micro']:.6f} / "
            f"{s['iou_micro']:.6f} / {s['acc_micro']:.6f}, {16 / seconds:.1f} tiles/s for the "
            f"whole run (model load, decode, views, forward) on {smi_line}, kernel launches "
            f"{launches}")
        _no_launches("eval_cli", launches)
        out[views] = {"launches": launches, "summary": s, "seconds": seconds,
                      "counts": res["slides"][0]["counts"]}
    host = out["host"]["summary"]
    fp32, bf16 = direct["float32"], direct["bfloat16"]
    diff = max(abs(host[k] - fp32[k]) for k in fp32)
    best_diff = abs(bf16["f1_micro"] - ft_cli_out["best_f1"])
    log("eval_cli", f"micro F1 {host['f1_micro']:.8f}; a validation of the same model here with "
        f"fp32 views {fp32['f1_micro']:.8f}, largest score difference {diff:.3g} (tolerance "
        f"1e-6); with bf16 views {bf16['f1_micro']:.8f}, phase ft_cli's best epoch "
        f"{ft_cli_out['best_f1']:.8f}, {best_diff:.3g} apart (tolerance 1e-6); fp32 against "
        f"bf16 views {abs(fp32['f1_micro'] - bf16['f1_micro']):.3g} apart (not held: they round "
        f"apart); device views {abs(out['device']['summary']['f1_micro'] - host['f1_micro']):.3g}"
        " apart (they differ by design, within 1e-3)")
    if not diff <= 1e-6:
        raise AssertionError(f"the evaluation CLI's scores are {diff} from a direct validation")
    if not best_diff <= 1e-6:
        raise AssertionError(f"a validation with bf16 views is {best_diff} from ft_cli's best "
                             "epoch")
    for k, v in out["device"]["summary"].items():
        if not abs(v - host[k]) <= 1e-3:
            raise AssertionError(f"device views score {k} {v}, host views {host[k]}")
    return {"launches": out["host"]["launches"], "launches_device": out["device"]["launches"],
            "counts": out["host"]["counts"], "f1": host["f1_micro"],
            "tiles_per_s": 16 / out["host"]["seconds"]}


def phase_predict(dev, root, tmp, ft_cli_out, eval_out, smi_line):
    """The prediction CLI at full width (resnet18 HookNet, 1024 px tiles,
    chunk 128, both heads, stitched) on the validation slide's tiles and a
    raw slide PNG that they tile: the target masks, read back through the
    port's decoder and scored on the host, equal phase eval_cli's counts
    exactly; one chunk's forward traced. Returns its numbers."""
    import numpy as np
    import torch

    from msfwsi_tpu_torch import native, predict
    from msfwsi_tpu_torch.data import datasets as D
    from msfwsi_tpu_torch.data.pipeline import make_seg_val_views_host
    from msfwsi_tpu_torch.data.png import png_size, write_png
    from msfwsi_tpu_torch.ops.geometry import TileGrid
    from msfwsi_tpu_torch.ops.metrics import get_stats
    from msfwsi_tpu_torch.train import checkpoint as C
    from msfwsi_tpu_torch.train import predict as PR

    group = D.bcss_seg_val_slides(root)[0]
    paths = [os.path.join(root, s.img) for s in group.samples]
    imgs = native.decode_batch(paths, 1024, 1024, 3)
    masks = native.decode_batch([os.path.join(root, s.mask) for s in group.samples], 1024, 1024, 1)
    grid = TileGrid(4096, 4096, 1024)  # 4x4 tiles; the prep grid pads it to 5x5
    ids = [r * grid.num_w + c for r in range(4) for c in range(4)]
    tiles_dir = os.path.join(tmp, "pred_tiles", group.filename, "images")
    os.makedirs(tiles_dir)
    for i, p in zip(ids, paths):
        os.symlink(p, os.path.join(tiles_dir, f"{i}.png"))
    raw_dir = os.path.join(tmp, "pred_raw", "images")
    os.makedirs(raw_dir)
    raw = os.path.join(raw_dir, f"{group.filename}.png")
    t = time.perf_counter()
    write_png(raw, imgs.reshape(4, 4, 1024, 1024, 3).transpose(0, 2, 1, 3, 4)
              .reshape(4096, 4096, 3), filters=(0,))
    log("predict", f"raw slide {png_size(raw)} written in {time.perf_counter() - t:.1f} s; "
        f"tiles {ids} of a {grid.num_h}x{grid.num_w} grid")
    weights = os.path.join(ft_cli_out["best_dir"], C.BEST_FT_MODEL)
    argv = ["-a", "resnet18", "--amp", "--seg-size", "256", "--val-chunk", "128", "--weights",
            weights, "--tiles-dir", os.path.dirname(os.path.dirname(tiles_dir)), "--head",
            "both", "--stitch", "--raw-data", os.path.dirname(raw_dir), "--device", str(dev),
            "--log-dir", os.path.join(tmp, "pred_log")]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()  # every kernel count to 0 just before the path
    res = predict.main(argv)
    launches = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    rate = res["tiles"] / res["seconds"]
    log("predict", f"{res['tiles']} tiles in {res['seconds']:.3f} s, {rate:.1f} tiles/s (decode, "
        f"host views, forward, PNG writes) on {smi_line}; peak memory {peak / 2**30:.2f} GiB; "
        f"kernel launches {launches}")
    _no_launches("predict", launches)
    pdir = res["out_dir"]
    tgt = native.decode_batch([os.path.join(pdir, group.filename, "target", f"{i}.png")
                               for i in ids], 256, 256, 1)
    tmask = masks[:, 384:640, 384:640].astype(np.int64)
    counts = np.stack([c.sum(0).numpy() for c in get_stats(
        torch.from_numpy(tgt).long() - 1, torch.from_numpy(tmask) - 1, 5, ignore_index=-1)])
    same = bool(np.array_equal(counts, eval_out["counts"]))
    log("predict", f"target masks scored on the host: counts equal phase eval_cli's: {same}")
    if not same:
        raise AssertionError(f"predicted masks score {counts.tolist()}, evaluation "
                             f"{eval_out['counts'].tolist()}")
    shapes = {}
    for head, size in (("context", 1024), ("target", 4096)):
        stitched = os.path.join(pdir, f"{group.filename}_{head}_stitched.png")
        shapes[head] = png_size(stitched)
        if shapes[head] != (size, size):
            raise AssertionError(f"stitched {head} map {shapes[head]}, want {(size, size)}")
    stitched_tgt = native.load_image(os.path.join(pdir, f"{group.filename}_target_stitched.png"))
    if not np.array_equal(stitched_tgt, PR.stitch_target_preds(tgt, ids, grid)):
        raise AssertionError("the stitched target map differs from its tiles' masks")
    log("predict", f"stitched maps {shapes} hold the tiles' masks")

    # one chunk's forward under the profiler
    from msfwsi_tpu_torch.evaluate import eval_aug_config, load_hooknet

    args = predict.build_parser().parse_args(argv)
    model = load_hooknet(weights, "resnet18", 6, dev, args, logging.getLogger("chip_smoke"))
    cfg = eval_aug_config(args)
    ctx_u8, tgt_u8, _ = make_seg_val_views_host(imgs, masks, cfg)
    ctx_d, tgt_d = (torch.from_numpy(np.concatenate([v] * 8)).to(dev) for v in (ctx_u8, tgt_u8))
    fn = PR.make_chunk_preds_hostviews(model, cfg, heads=PR.HEADS, amp=True)
    fn(ctx_d, tgt_d)
    profile_steps(lambda: {"loss": fn(ctx_d, tgt_d)[1].sum()}, 3)
    return {"launches": launches, "tiles_per_s": rate, "peak_bytes": peak}


def phase_features(dev, root, tmp, ckpt_dir, smi_line):
    """Tile features at full width from phase "cli"'s SSL checkpoint
    (resnet18, scale 4, chunk 32, amp) on both sides of fold 0: shapes, fp16,
    the validation slide's context features within bf16's 2e-2 of an fp32
    forward of the checkpoint's context encoder, then the linear probe on
    them. Returns its numbers."""
    import numpy as np
    import torch

    from msfwsi_tpu_torch import extract_features, linear_probe, native
    from msfwsi_tpu_torch.data import datasets as D
    from msfwsi_tpu_torch.data.pipeline import AugConfig, _to_float
    from msfwsi_tpu_torch.ops import augment as A
    from msfwsi_tpu_torch.train import checkpoint as C
    from msfwsi_tpu_torch.train import features as F

    ckpt = os.path.join(ckpt_dir, "checkpoint_0001.pth.tar")
    dirs, spec, tiles, seconds = {}, None, 0, 0.0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()  # every kernel count to 0 just before the path
    for split in ("train", "val"):
        res = extract_features.main([
            "--weights", ckpt, "-a", "resnet18", "--scale", "4", "--chunk", "32", "--amp",
            "--train-data", root, "--split", split, "--device", str(dev), "--out",
            os.path.join(tmp, "feats", split), "--log-dir", os.path.join(tmp, "feats_log")])
        dirs[split], spec = res["out_dir"], res["spec"]
        tiles += res["tiles"]
        seconds += res["seconds"]
    launches = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    log("features", f"{tiles} tiles in {seconds:.3f} s, {tiles / seconds:.1f} tiles/s (decode, "
        f"17 encoder passes a tile, fetch, npz) on {smi_line}; peak memory "
        f"{peak / 2**30:.2f} GiB; kernel launches {launches}")
    _no_launches("features", launches)
    group = D.bcss_seg_val_slides(root)[0]
    z = np.load(os.path.join(dirs["val"], f"{group.filename}.npz"))
    for b, s, c in spec:
        arr = z[f"{b}_s{s}"]
        want = (16, c) if b == "context" else (16, 16, c)
        if arr.shape != want or arr.dtype != np.float16 or not np.isfinite(arr).all():
            raise AssertionError(f"{b}_s{s}: {arr.dtype} {arr.shape}, want float16 {want}")
    # the context features against an fp32 forward of the checkpoint's encoder
    sd = {k.removeprefix("module."): v for k, v in C.load_torch_file(ckpt).items()}
    model = extract_features.encoders_model(sd, "resnet18", 4, ("context",), dev, ckpt)
    imgs = torch.from_numpy(native.decode_batch(
        [os.path.join(root, s.img) for s in group.samples], 1024, 1024, 3)).to(dev)
    cfg = AugConfig()
    with torch.no_grad():
        x = _to_float(imgs)
        ref = model.encode_context(A.normalize(A.resize_bilinear(x, 224), cfg.mean, cfg.std))
    # under --amp the encoder's convolutions compute in bf16 (the stem's
    # takes the fp32 views and autocast casts them)
    seen = []
    hooks = [m.register_forward_hook(lambda m, a, out: seen.append(str(out.dtype)))
             for m in model.context_encoder.modules() if isinstance(m, torch.nn.Conv2d)]
    F.make_chunk_features(model, cfg, ("context",), amp=True)(imgs)
    for h in hooks:
        h.remove()
    if sorted(set(seen)) != ["torch.bfloat16"]:
        raise AssertionError(f"encoder convolutions under --amp take {sorted(set(seen))}")
    worst = 0.0
    for s in (1, 2, 3, 4):
        got = torch.from_numpy(z[f"context_s{s}"].astype(np.float32)).to(dev)
        want = ref[s - 1].float()
        worst = max(worst, float(((got - want).abs() / (1 + want.abs())).max()))
    log("features", f"context features against an fp32 forward: max |amp - fp32| / (1 + |fp32|) "
        f"{worst:.4g} (tolerance 2e-2); encoder convolution outputs under --amp "
        f"{sorted(set(seen))}")
    if not worst <= 2e-2:
        raise AssertionError(f"context features {worst} from the fp32 forward")
    res = linear_probe.main(["--features", dirs["train"], "--features-val", dirs["val"],
                             "--train-data", root, "--epochs", "50", "--device", str(dev),
                             "--log-dir", os.path.join(tmp, "probe_log")])
    scores = {k: (res[k]["acc"], res[k]["micro_f1"]) for k in ("train", "val")}
    log("features", f"linear probe (context_s4, 50 epochs): acc / micro F1 {scores}, val CI95 "
        f"{res['val']['acc_ci95']}")
    if not all(np.isfinite(v) for pair in scores.values() for v in pair):
        raise AssertionError(f"probe scores {scores}")
    return {"launches": launches, "tiles_per_s": tiles / seconds, "peak_bytes": peak}


def phase_bench_eval(dev):
    """The port bench in mode ``eval_e2e``, 32 tiles a slide, a few slides."""
    from msfwsi_tpu_torch import bench

    knobs = {"BENCH_MODE": "eval_e2e", "BENCH_BATCH": "32", "BENCH_ITERS": "3",
             "BENCH_WARMUP": "1", "BENCH_REPEATS": "2"}
    _reset_counts()  # every kernel count to 0 just before the path
    res = bench.main(["--device", str(dev)], env={**os.environ, **knobs})
    launches = _read_counts()
    log("bench", f"{res['metric']}: median {res['value']:.1f}, windows {res['rates']}, kernel "
        f"launches {launches}")
    _no_launches("bench eval_e2e", launches)
    if not (math.isfinite(res["value"]) and res["value"] > 0):
        raise AssertionError(f"bench value {res['value']}")
    return {**res, "launches": launches}


def phase_prepare(dev, tmp, smi_line):
    """Data preparation on the card's machine, which has no PIL: synthetic
    BCSS region PNGs (3 slides at 4096 px), ``bcss_prepare`` at the
    recipe's ``-s 1024 --overlap 512``, every tile and mask read back
    through the port's decoder, then ``ssl_train`` on the prepared root
    (resnet18, b32, amp, fold 0, 1 epoch of 2 steps). Returns its
    numbers."""
    import csv

    import numpy as np

    from msfwsi_tpu_torch import bcss_prepare, make_synthetic_slides, native, ssl_train
    from msfwsi_tpu_torch.data.prepare import CSV_COLUMNS
    from msfwsi_tpu_torch.diag import datapath as DP

    raw, root = os.path.join(tmp, "bcss_raw"), os.path.join(tmp, "bcss_prep")
    t = time.perf_counter()
    names = make_synthetic_slides.main(["-o", raw, "--slides", "3", "--size", "4096"])
    gen_s = time.perf_counter() - t
    t = time.perf_counter()
    shape = bcss_prepare.main(["-p", raw, "-o", root, "-s", "1024", "--overlap", "512"])
    prep_s = time.perf_counter() - t
    with open(os.path.join(root, "data.csv"), newline="") as f:
        header, *rows = list(csv.reader(f))
    if header != CSV_COLUMNS or (len(rows), len(header)) != shape:
        raise AssertionError(f"data.csv: header {header}, {len(rows)} rows, CLI said {shape}")
    variants = {r[2].removeprefix(n) for r in rows for n in names if r[2].startswith(n)}
    if variants != {"", "_shiftW_512", "_shiftH_512", "_shiftHW_512"}:
        raise AssertionError(f"shift variants {sorted(variants)}")
    imgs = native.decode_batch([os.path.join(root, r[0]) for r in rows], 1024, 1024, 3)
    masks = native.decode_batch([os.path.join(root, r[1]) for r in rows], 1024, 1024, 1)
    empty = int((~masks.reshape(len(rows), -1).any(axis=1)).sum())
    top = int(masks.max())
    unmasked_lit = bool(imgs[masks == 0].any())
    del imgs, masks
    log("prepare", f"{len(names)} synthetic 4096 px slides in {gen_s:.1f} s; bcss_prepare "
        f"-s 1024 --overlap 512: {shape[0]} tiles and masks in {prep_s:.1f} s, "
        f"{shape[0] / prep_s:.1f} tiles/s (decode, remap, cut, PNG writes on threads) on "
        f"{smi_line}; every one decoded by the port's decoder; masks in 0-{top}, {empty} empty; "
        f"variants {sorted(variants)}")
    if empty or top > 5 or unmasked_lit:
        raise AssertionError(f"{empty} empty masks, largest class {top}, unmasked pixels lit "
                             f"{unmasked_lit}")
    _reset_counts()  # every kernel count to 0 just before the path
    t = time.perf_counter()
    res = ssl_train.main(DP.cli_argv(root, os.path.join(tmp, "prep_logs"), epochs=1, extra=(
        "--steps-per-epoch", "2", "--fold", "0")))
    train_s = time.perf_counter() - t
    launches = _read_counts()
    e = res["epochs"][0]
    log("prepare", f"ssl_train on the prepared tiles (fold 0, resnet18 b32 amp): loss "
        f"{e['loss']:.6f} over {e['steps']} steps, {train_s:.1f} s for the run, kernel launches "
        f"{launches}")
    if not (math.isfinite(e["loss"]) and e["steps"] == 2):
        raise AssertionError(f"ssl_train on the prepared tiles: {e}")
    if launches != {"K1": 4 * e["steps"], "K2": 0, "probe": 0}:
        raise AssertionError(f"kernel launches {launches}, want K1 4 a step and no other")
    return {"launches": launches, "tiles": shape[0], "gen_s": gen_s, "prep_s": prep_s,
            "train_s": train_s}


def phase_serving(dev, root, tmp, ft_cli_out, smi_line):
    """The serving export of phase "ft_cli"'s best model at the JAX tool's
    defaults (resnet18, chunk 128, 256 px, ``--amp``), loaded on the card
    and run on one 128-tile chunk of the validation slide's views (its 16
    tiles 8 times) against the eager model. Returns its numbers."""
    import numpy as np
    import torch

    from msfwsi_tpu_torch import export_serving, native
    from msfwsi_tpu_torch.data import datasets as D
    from msfwsi_tpu_torch.data.pipeline import AugConfig, _to_float, make_seg_val_views_host
    from msfwsi_tpu_torch.diag.timing import cuda_time_ms
    from msfwsi_tpu_torch.models.hooknet import HookNet
    from msfwsi_tpu_torch.ops import augment as A
    from msfwsi_tpu_torch.train import checkpoint as C
    from msfwsi_tpu_torch.train import serving as SV

    weights = os.path.join(ft_cli_out["best_dir"], C.BEST_FT_MODEL)
    out = os.path.join(tmp, "hooknet.pt2")
    t = time.perf_counter()
    export_serving.main(["--checkpoint", weights, "--out", out, "--amp", "--device", str(dev)])
    export_s = time.perf_counter() - t
    group = D.bcss_seg_val_slides(root)[0]
    imgs = native.decode_batch([os.path.join(root, s.img) for s in group.samples], 1024, 1024, 3)
    masks = native.decode_batch([os.path.join(root, s.mask) for s in group.samples], 1024, 1024,
                                1)
    cfg = AugConfig(seg_size=256)  # fp32 views, as the evaluation builds them
    ctx_u8, tgt_u8, _ = make_seg_val_views_host(imgs, masks, cfg)
    ctx, tgt = (A.normalize(_to_float(torch.from_numpy(np.concatenate([v] * 8)).to(dev)),
                            cfg.mean, cfg.std) for v in (ctx_u8, tgt_u8))
    model = C.load_ft_model(weights, HookNet(arch="resnet18", classes=6)).to(dev).eval()

    def eager():
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            return model(ctx, tgt)[1].float()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()  # every kernel count to 0 just before the path
    infer = SV.load_serving_artifact(out, device=dev)
    got = infer(ctx, tgt)
    launches = _read_counts()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    logits = eager()
    want = logits.argmax(dim=-1).to(torch.int32)
    top2 = logits.topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) <= 2e-2
    differ = got != want
    n_near, n_diff, n_far = (int(x.sum()) for x in (near, differ, differ & ~near))
    ms_art = cuda_time_ms(lambda: infer(ctx, tgt), reps=10)
    ms_eager = cuda_time_ms(eager, reps=10)
    log("serving", f"export_serving (resnet18, chunk 128, 256 px, --amp) in {export_s:.1f} s; "
        f"artifact on a 128-tile chunk: {got.dtype} {tuple(got.shape)}, {n_diff} of "
        f"{got.numel()} pixels differ from the eager argmax, {n_far} of them outside the "
        f"{n_near} near ties (eager top-two logits within bf16's 2e-2); {128e3 / ms_art:.1f} "
        f"tiles/s ({ms_art:.3f} ms a chunk) against the eager forward's {128e3 / ms_eager:.1f} "
        f"({ms_eager:.3f} ms) on {smi_line}; peak memory {peak / 2**30:.2f} GiB; kernel "
        f"launches {launches}")
    _no_launches("serving", launches)
    if got.dtype != torch.int32 or tuple(got.shape) != (128, 256, 256) or n_far:
        raise AssertionError(f"artifact output {got.dtype} {tuple(got.shape)}, {n_far} pixels "
                             "differ from the eager argmax outside near ties")
    return {"launches": launches, "tiles_per_s": 128e3 / ms_art,
            "eager_tiles_per_s": 128e3 / ms_eager, "peak_bytes": peak, "differ": n_diff,
            "near": n_near}


def encoder_step_check(dev, arch) -> dict:
    """``arch``'s SSL model in fp32 (b2, 64 px views) on the card against
    the CPU, TF32 off. First a copy whose zero-init residual branches have
    their ``bn3`` weights drawn from U(0.5, 1.5), so that every convolution
    (the grouped 3x3 too) gets a gradient, in eval mode, where each
    BatchNorm is an affine map: the pooled features within
    ``ENC_FEATURE_BOUND`` of the CPU's relative to their largest value, and
    the gradients, parameter by parameter, within ``GRAD_BOUND`` of the
    CPU's relative to their norm. Then a train step of the model as drawn:
    its loss within 5e-3, the train-mode bound of
    ``tests/test_torch_models.py``, and its running stats no further from a
    float64 forward's than twice the CPU's are. That step normalizes by 2
    samples of a few pixels, which amplifies fp32 rounding by mean/std, so
    its gradients are not compared: on the CPU they stand up to 26% from a
    float64 backward's. The train-mode BatchNorm backward is held by
    ``finetune_step_check``. Returns the measured distances."""
    import copy

    import numpy as np
    import torch

    from msfwsi_tpu_torch.data.pipeline import AugConfig, make_ssl_views, sample_ssl_views
    from msfwsi_tpu_torch.train.ssl import (SSLConfig, create_ssl_state, ssl_loss_fn,
                                            ssl_train_step)

    aug = AugConfig(img_size=64, grid=2, tile_px=64)
    tiles = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 128, 128, 3),
                                                                 np.uint8))
    params = sample_ssl_views(torch.Generator().manual_seed(3), 2, (128, 128), aug)
    config = SSLConfig(arch=arch, scale=2, batch_size=2, amp=False)
    cpu_state = create_ssl_state(config, device="cpu")
    dev_state = create_ssl_state(config, device=dev, model=copy.deepcopy(cpu_state.model))
    exact = copy.deepcopy(cpu_state.model).double()
    batch = make_ssl_views(tiles, aug, params=params, shuffle_views=config.shuffle_views)
    batch64 = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
    active = copy.deepcopy(cpu_state.model).eval()
    with torch.no_grad():
        gen = torch.Generator().manual_seed(3)
        for name, p in active.named_parameters():
            if name.endswith(".bn3.weight"):
                p.uniform_(0.5, 1.5, generator=gen)
    models = (copy.deepcopy(active).to(dev), active, copy.deepcopy(active).double())
    batches = (_to(batch, dev), batch, batch64)
    old = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for m, b in zip(models, batches):
            ssl_loss_fn(m, b, config.fuser_weights)[0].backward()
        grads = grad_distances(*models)
        with torch.no_grad():
            feats = [[f.cpu().double() for f in m.encode_context(b["context1"])]
                     for m, b in zip(models, batches)]
        # the running stats of a float64 train-mode forward
        with torch.no_grad():
            ssl_loss_fn(exact.train(), batch64, config.fuser_weights)
        loss_cpu = float(ssl_train_step(cpu_state, batch, config.fuser_weights)["loss"])
        loss_dev = float(ssl_train_step(dev_state, batches[0], config.fuser_weights)["loss"])
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old
    err, err64 = (max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(x, y))
                  for x, y in ((feats[0], feats[1]), (feats[1], feats[2])))
    got = {k: v.cpu().double() for k, v in dev_state.model.state_dict().items()}
    cpu_sd = cpu_state.model.state_dict()
    stats = {k: v for k, v in exact.named_buffers() if k.endswith(("_mean", "_var"))}

    def rel(sd):
        """The largest error against the float64 stats, relative where a
        stat exceeds 1, absolute below (the heads' means lie near 0)."""
        return max(float((sd[k].double() - v).abs().max() / v.abs().max().clamp_min(1))
                   for k, v in stats.items())

    log("encoders", f"{arch} fp32, b2 64 px, eval mode with every branch active: pooled "
        f"features card vs CPU {err:.3g} relative to their largest (bound "
        f"{ENC_FEATURE_BOUND:g}; CPU vs float64 {err64:.3g}); worst relative gradient distance "
        f"(parameter): {grads} (card-cpu bound {GRAD_BOUND:g}). Train step: loss card "
        f"{loss_dev:.8f}, cpu {loss_cpu:.8f} (bound 5e-3, tests/test_torch_models.py's for "
        f"train-mode outputs); running stats from a float64 forward: card {rel(got):.3g}, CPU "
        f"{rel(cpu_sd):.3g} (relative above 1; the card held to twice the CPU's)")
    if not err <= ENC_FEATURE_BOUND:
        raise AssertionError(f"{arch} features differ between card and CPU by {err}")
    if not grads["card-cpu"][0] <= GRAD_BOUND:
        raise AssertionError(f"{arch} eval-mode gradients: {grads}")
    if not (math.isfinite(loss_dev) and abs(loss_dev - loss_cpu) <= 5e-3):
        raise AssertionError(f"{arch} loss on the card {loss_dev} vs the CPU {loss_cpu}")
    if not rel(got) <= 2 * rel(cpu_sd) + 1e-6:
        raise AssertionError(f"{arch} running stats {rel(got)} from a float64 forward, "
                             f"the CPU's {rel(cpu_sd)}")
    return {"features": (err, err64), "grads": grads, "stats": (rel(got), rel(cpu_sd)),
            "loss": (loss_dev, loss_cpu)}


def phase_encoders(dev, smi_line):
    """The Bottleneck encoders: ``encoder_step_check`` of resnet50 and
    resnext50_32x4d, then the fused SSL step at resnet50's full width (b8,
    scale 4, bf16 amp) and one fused HookNet fine-tuning step at
    resnext50_32x4d (b16, 256 px). Returns the counts of the SSL and
    fine-tuning paths and the numbers."""
    import numpy as np
    import torch

    from msfwsi_tpu_torch.data.pipeline import AugConfig
    from msfwsi_tpu_torch.train import finetune as FT

    for arch in ("resnet50", "resnext50_32x4d"):
        encoder_step_check(dev, arch)

    _reset_counts()  # every kernel count to 0 just before the path
    ssl = phase_slice(dev, batch=8, arch="resnet50", warmup=2, steps=3, traced=0,
                      name="encoders")
    ssl_launches = _read_counts()
    act = ssl["peak_bytes"] - ssl["held_bytes"]
    log("encoders", f"resnet50 SSL b8: {ssl['views_per_s']:.1f} tile views/s on {smi_line}; "
        f"peak {ssl['peak_bytes'] / 2**30:.2f} GiB = {ssl['held_bytes'] / 2**30:.2f} GiB held "
        f"between steps (weights, Adam, gradients) + {act / 2**30:.2f} GiB within a step; b32 "
        f"would need ~{(ssl['held_bytes'] + 4 * act) / 2**30:.1f} GiB if the part within a "
        f"step scales with the batch; kernel launches {ssl_launches}")
    if ssl_launches["K2"] or ssl_launches["probe"]:
        raise AssertionError(f"the resnet50 SSL step launched {ssl_launches}")
    torch.cuda.empty_cache()

    config = FT.FinetuneConfig(arch="resnext50_32x4d", batch_size=16, amp=True)
    rng = np.random.default_rng(config.seed)
    imgs = torch.from_numpy(rng.integers(0, 256, (16, 1024, 1024, 3), np.uint8)).to(dev)
    masks = torch.from_numpy(rng.integers(0, config.num_classes, (16, 1024, 1024),
                                          np.uint8)).to(dev)
    state = FT.create_finetune_state(config, device=dev)
    step = FT.make_fused_finetune_step(config, AugConfig(compute_dtype="bfloat16"), device=dev)
    gen = torch.Generator(device=dev).manual_seed(config.seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()  # every kernel count to 0 just before the path
    t = time.perf_counter()
    loss = float(step(state, imgs, masks, gen)["loss"])
    ft_s = time.perf_counter() - t
    ft_launches = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    log("encoders", f"resnext50_32x4d HookNet fine-tuning step b16 256 px: loss {loss:.6f}, "
        f"{1e3 * ft_s:.1f} ms (the first step), peak memory {peak / 2**30:.2f} GiB, kernel "
        f"launches {ft_launches}")
    if not math.isfinite(loss):
        raise AssertionError(f"non-finite resnext50 fine-tuning loss {loss}")
    _no_launches("encoders fine-tuning", ft_launches)
    return {"ssl_launches": ssl_launches, "ft_launches": ft_launches,
            "views_per_s": ssl["views_per_s"], "peak_bytes": ssl["peak_bytes"]}


MEMORY_FLAGS = ("--accum-steps", "2", "--inter-opt", "fused_adafactor", "--inter-dtype",
                "bfloat16")


def _memory_steps(name, state, step, tiles, gen, warmup, steps, smi_line):
    """``warmup`` then ``steps`` timed steps of a fused SSL step, every
    kernel count set to 0 just before; returns the numbers, with the
    memory held between steps (weights, optimizer state) after them."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()  # every kernel count to 0 just before the path
    for i in range(warmup):
        log(name, f"warm-up step {i + 1}: loss {float(step(state, tiles, gen)['loss']):.6f}")
    t0 = time.perf_counter()
    for _ in range(steps):
        metrics = step(state, tiles, gen)
    loss = float(metrics["loss"])  # synchronizes
    dt = time.perf_counter() - t0
    launches = _read_counts()
    out = {"launches": launches, "loss": loss, "step_ms": 1e3 * dt / steps,
           "views_per_s": tiles.shape[0] * steps * (2 + 2 * 16) / dt,  # K = 16
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "held_bytes": torch.cuda.memory_allocated(), "steps": warmup + steps}
    log(name, f"{steps} timed steps in {dt:.3f} s ({out['step_ms']:.1f} ms/step): loss "
        f"{loss:.6f}, {out['views_per_s']:.1f} tile views/s, peak memory "
        f"{out['peak_bytes'] / 2**30:.2f} GiB, held between steps "
        f"{out['held_bytes'] / 2**30:.2f} GiB, kernel launches {launches} on {smi_line}")
    if not math.isfinite(loss):
        raise AssertionError(f"{name}: non-finite loss {loss}")
    if launches != {"K1": 8 * out["steps"], "K2": 0, "probe": 0}:
        raise AssertionError(f"{name}: launches {launches} in {out['steps']} steps, want K1 8 "
                             "a step (4 per microbatch, accum 2)")
    return out


def _sync_fused_to_plain(plain, fused) -> None:
    """Give the fused-Adafactor train state the plain one's weights, running
    stats and optimizer state. The plain Adafactor keeps a torch weight's
    statistics along its own axes (``v_row`` keeps the second-largest), the
    fused one ``v_row`` along d_in and ``v_col`` along d_out."""
    import torch

    from msfwsi_tpu_torch.train.factored import factored_dims

    fused.model.load_state_dict(plain.model.state_dict())
    names = {p: n for n, p in fused.model.named_parameters()}
    plain_names = {p: n for n, p in plain.model.named_parameters()}
    src = {plain_names[p]: opt.state[p] for opt in plain.optimizer.optimizers.values()
           for g in opt.param_groups for p in g["params"]}
    with torch.no_grad():
        for kind, opt in fused.optimizer.optimizers.items():
            for g in opt.param_groups:
                for p in g["params"]:
                    theirs, mine = src.get(names[p], {}), opt.state[p]
                    if not theirs:
                        continue
                    if kind == "fused_adafactor" and factored_dims(tuple(p.shape))[0] != 1:
                        theirs = {**theirs, "v_row": theirs["v_col"], "v_col": theirs["v_row"]}
                    for k, v in theirs.items():
                        if k != "step":
                            mine[k].copy_(v)


def _accumulated_grads(state, batch, accum: int, fuser_weights):
    """Loss and mean gradient of one accumulated step before the optimizer
    runs: every ``.grad``, and for a fused-Adafactor weight the dense
    ``X^T dY`` of its stashed factors (their dY scaled by 1/accum as the
    optimizer takes them), by parameter name."""
    from msfwsi_tpu_torch.train.factored import is_factored_kernel
    from msfwsi_tpu_torch.train.ssl import accumulate, slice_microbatch, ssl_loss_fn

    model = state.model.train()
    parts = accumulate(model, accum, lambda i: slice_microbatch(batch, accum, i),
                       lambda mb: (ssl_loss_fn(model, mb, fuser_weights)[0], None), state.stash)
    grads = {}
    for n, p in model.named_parameters():
        if p.grad is not None:
            grads[n] = p.grad.detach().clone()
        elif state.stash is not None and is_factored_kernel(n, p):
            x, dy = state.stash.take(p)
            grads[n] = dy.float().T @ x.float()
    if state.stash is not None:
        state.stash.clear()
    return float(sum(loss for loss, _ in parts)) / accum, grads


def memory_checks(dev) -> dict:
    """The memory path's semantics on the card at a small size (resnet10,
    scale 2, b4, 64 px views, fp32, TF32 off, cuDNN deterministic): fused
    against plain Adafactor over 3 steps, each from equal states (the runs
    otherwise drift apart by Adam's flips on near-zero gradients, through
    BatchNorm over 4 samples), within ``tests/test_factored.py``'s bounds
    (losses rtol 1e-3 / atol 1e-5; every element within 2.5 lr, at most
    max(2, 0.5%) of a tensor outside 5e-5 + 5e-5 |ref|); accum 2 on the
    adjacent-duplicated batch against accum 1 (loss rel 1e-6, gradients 1e-6,
    ``tests/test_accum.py``'s), compared on the mean gradient before the
    optimizer runs, with Adam and with the fused Adafactor (its factored
    weights' ``X^T dY``), since a first optimizer step can hide a wrong
    scale; and remat's loss, gradients and running
    stats against none (1e-6 relative). Returns the measured distances."""
    import dataclasses

    import numpy as np
    import torch

    from msfwsi_tpu_torch.train.ssl import SSLConfig, create_ssl_state, ssl_loss_fn, ssl_train_step

    gen = torch.Generator().manual_seed(11)
    B, S = 4, 64

    def views(b):
        rev = torch.stack([torch.randperm(4, generator=gen) for _ in range(b)]).argsort(1)
        v = {k: torch.randn(n, S, S, 3, generator=gen) for k, n in (
            ("context1", b), ("context2", b), ("target1_spatial", 4 * b),
            ("target2_spatial", 4 * b))}
        return _to({**v, "rev1": rev, "rev2": rev}, dev)

    base = SSLConfig(arch="resnet10", scale=2, batch_size=B, amp=False)
    old = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    out = {}
    try:
        states = [create_ssl_state(dataclasses.replace(base, inter_opt=o), device=dev)
                  for o in ("adafactor", "fused_adafactor")]
        losses = []
        lr = base.init_lr
        worst, loose_worst = 0.0, 0.0
        for _ in range(3):
            _sync_fused_to_plain(*states)  # each step from equal states
            b = views(B)
            losses.append([float(ssl_train_step(s, b, base.fuser_weights)["loss"])
                           for s in states])
            plain = dict(states[0].model.named_parameters())
            for n, p in states[1].model.named_parameters():
                ref = plain[n].detach().float()
                d = (p.detach().float() - ref).abs()
                loose = int((d > 5e-5 + 5e-5 * ref.abs()).sum())
                worst = max(worst, float(d.max()) / lr)
                loose_worst = max(loose_worst, loose / d.numel())
                if not (float(d.max()) <= 2.5 * lr and loose <= max(2, int(5e-3 * d.numel()))):
                    raise AssertionError(f"fused vs plain Adafactor on the card: {n} max "
                                         f"{float(d.max()) / lr:.3g} lr, {loose} loose")
        got, want = np.array(losses).T[1], np.array(losses).T[0]
        if not np.allclose(got, want, rtol=1e-3, atol=1e-5):
            raise AssertionError(f"fused vs plain Adafactor losses {losses}")
        out["fused_vs_plain"] = {"max_d_over_lr": worst, "loose_fraction": loose_worst,
                                 "losses": losses}
        del states

        b = views(B)
        dup = {k: v.repeat_interleave(2, dim=0) if k.startswith(("context", "rev"))
               else v.reshape(B, 4, S, S, 3).repeat_interleave(2, dim=0).reshape(-1, S, S, 3)
               for k, v in b.items()}
        out["accum_duplicated"] = {}
        for opt in ("adam", "fused_adafactor"):
            cfg = dataclasses.replace(base, inter_opt=opt)
            res = [_accumulated_grads(create_ssl_state(cfg, device=dev), batch, accum,
                                      cfg.fuser_weights)
                   for batch, accum in ((b, 1), (dup, 2))]
            (l1, g1), (l2, g2) = res
            dg = max(float((g2[n] - g).norm() / g.norm().clamp_min(1e-30)) for n, g in g1.items())
            if not (g1.keys() == g2.keys() and abs(l2 - l1) <= 1e-6 * abs(l1) and dg <= 1e-6):
                raise AssertionError(f"accum 2 on the duplicated batch ({opt}): loss {l2} vs "
                                     f"{l1}, gradients {dg:.3g} apart")
            out["accum_duplicated"][opt] = {"loss": (l1, l2), "grads_rel": dg,
                                            "leaves": len(g1)}

        b = views(B)
        res = []
        for cfg in (base, dataclasses.replace(base, use_ac=True, remat_stages=(1, 2))):
            model = create_ssl_state(cfg, device=dev).model.train()
            loss, _ = ssl_loss_fn(model, b, cfg.fuser_weights)
            loss.backward()
            res.append((float(loss.detach()), {n: p.grad for n, p in model.named_parameters()},
                        dict(model.named_buffers())))
        (la, ga, ba), (lb, gb, bb) = res
        dg = max(float((gb[n] - g).norm() / g.norm().clamp_min(1e-30)) for n, g in ga.items())
        dbuf = max(float((bb[n] - v).abs().max()) for n, v in ba.items())
        if not (abs(lb - la) <= 1e-6 * abs(la) and dg <= 1e-6 and dbuf <= 1e-6):
            raise AssertionError(f"remat vs none on the card: loss {lb} vs {la}, gradients "
                                 f"{dg:.3g}, running stats {dbuf:.3g}")
        out["remat"] = {"loss": (la, lb), "grads_rel": dg, "stats_abs": dbuf}
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) = old
    log("memory", f"card checks (resnet10, b4, 64 px, fp32): fused vs plain Adafactor over 3 "
        f"steps {out['fused_vs_plain']} (bounds 2.5 lr, 0.5% outside 5e-5); accum 2 on the "
        f"duplicated batch vs accum 1 {out['accum_duplicated']} (bound 1e-6); remat (stages 1, "
        f"2) vs none {out['remat']} (bound 1e-6)")
    return out


def phase_memory(dev, root, tmp, smi_line):
    """The large-model memory path. (a) resnet50 SSL at full width, b32,
    scale 4, bf16 amp, accum 2, fused Adafactor on bf16 heads: 2 warm-up and
    3 timed steps, K1 8 launches a step, tile views/s, peak memory and the
    part held between steps, then 1 step traced; (b) the same model and
    tiles with ``use_ac`` on stages 1 and 2: a lower peak; (c) ``memory_checks``; (d)
    ``ssl_train.main`` with run a's flags at resnet18 b32 on the datapath's
    tiles, 2 epochs of 1 step, then a resume whose model and optimizer
    states equal the checkpoint's; (e) one fused HookNet fine-tuning step,
    resnet18 b64, accum 2, no launch. Returns each path's counts."""
    import numpy as np
    import torch

    from msfwsi_tpu_torch import ssl_train
    from msfwsi_tpu_torch.data.pipeline import AugConfig
    from msfwsi_tpu_torch.diag import datapath as DP
    from msfwsi_tpu_torch.train import finetune as FT
    from msfwsi_tpu_torch.train.ssl import SSLConfig, create_ssl_state, make_fused_step

    config = SSLConfig(arch="resnet50", batch_size=32, scale=4, amp=True, accum_steps=2,
                       inter_opt="fused_adafactor", inter_dtype="bfloat16")
    aug = AugConfig(grid=4, compute_dtype="bfloat16")
    rng = np.random.default_rng(config.seed)
    tiles = torch.from_numpy(rng.integers(0, 256, (32, 1024, 1024, 3), np.uint8)).to(dev)
    t = time.perf_counter()
    state = create_ssl_state(config, device=dev)
    n_params = sum(p.numel() for p in state.model.parameters())
    heads = sum(p.numel() * p.element_size() for n, p in state.model.named_parameters()
                if n.startswith("inter_"))
    log("memory", f"resnet50 scale 4 with bf16 heads: {n_params / 1e9:.3f}e9 parameters, the "
        f"fuser heads {heads / 2**30:.2f} GiB, built in {time.perf_counter() - t:.1f} s")
    step = make_fused_step(config, aug, device=dev)
    gen = torch.Generator(device=dev).manual_seed(config.seed)
    ssl = _memory_steps("memory", state, step, tiles, gen, 2, 3, smi_line)
    if state.stash is None or len(state.stash) or any(
            p.grad is not None for n, p in state.model.named_parameters()
            if n.startswith("inter_") and p.ndim == 2):
        raise AssertionError("the fused path left factors or a dense head gradient")
    profile_steps(lambda: step(state, tiles, gen), 1)
    for enc in (state.model.context_encoder, state.model.target_encoder):
        enc.remat_stages = (1, 2)  # the same weights, its blocks of stages 1-2 checkpointed
    remat = _memory_steps("memory", state, step, tiles, gen, 1, 3, smi_line)
    log("memory", f"resnet50 b32 accum 2 fused_adafactor bf16 heads: {ssl['views_per_s']:.1f} "
        f"tile views/s, peak {ssl['peak_bytes'] / 2**30:.2f} GiB, held "
        f"{ssl['held_bytes'] / 2**30:.2f} GiB; with use_ac (stages 1, 2) "
        f"{remat['views_per_s']:.1f} tile views/s, peak {remat['peak_bytes'] / 2**30:.2f} GiB "
        f"on {smi_line}")
    if not remat["peak_bytes"] < ssl["peak_bytes"]:
        raise AssertionError(f"remat peak {remat['peak_bytes']} not under {ssl['peak_bytes']}")
    del state, step, tiles
    torch.cuda.empty_cache()

    checks = memory_checks(dev)

    logs = os.path.join(tmp, "logs_memory")
    _reset_counts()  # every kernel count to 0 just before the path
    # 2 epochs of 1 step: phase "ft_cli" leaves 48 training tiles, a step at b32
    res = ssl_train.main(DP.cli_argv(root, os.path.join(logs, "train"), epochs=2, extra=(
        "--steps-per-epoch", "1", "--save-freq", "1", *MEMORY_FLAGS)))
    cli_launches = _read_counts()
    steps = sum(e["steps"] for e in res["epochs"])
    losses = [e["loss"] for e in res["epochs"]]
    ckpt = os.path.join(res["log_dir"], "checkpoint_0001.pth.tar")
    resumed = ssl_train.main(DP.cli_argv(root, os.path.join(logs, "resume"), epochs=2, extra=(
        "--resume", ckpt, *MEMORY_FLAGS)))
    saved = torch.load(ckpt, map_location="cpu", weights_only=True)
    equal = resumed["start_epoch"] == 2 and _state_equal(resumed["state"], saved)
    log("memory", f"ssl_train resnet18 b32 {' '.join(MEMORY_FLAGS)}: {steps} steps, losses "
        f"{losses}, K1 launches {cli_launches}; resume from checkpoint_0001: model and "
        f"optimizer state equal to the saved ones: {equal}")
    if not (steps == 2 and all(math.isfinite(x) for x in losses) and equal):
        raise AssertionError(f"the memory-path CLI: {steps} steps, equal {equal}")
    if cli_launches != {"K1": 8 * steps, "K2": 0, "probe": 0}:
        raise AssertionError(f"the memory-path CLI launched {cli_launches} in {steps} steps")
    del res, resumed, saved
    torch.cuda.empty_cache()

    config = FT.FinetuneConfig(arch="resnet18", batch_size=64, amp=True, accum_steps=2)
    rng = np.random.default_rng(config.seed)
    imgs = torch.from_numpy(rng.integers(0, 256, (64, 1024, 1024, 3), np.uint8)).to(dev)
    masks = torch.from_numpy(rng.integers(0, config.num_classes, (64, 1024, 1024),
                                          np.uint8)).to(dev)
    state = FT.create_finetune_state(config, device=dev)
    step = FT.make_fused_finetune_step(config, AugConfig(compute_dtype="bfloat16"), device=dev)
    gen = torch.Generator(device=dev).manual_seed(config.seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()  # every kernel count to 0 just before the path
    t = time.perf_counter()
    m = step(state, imgs, masks, gen)
    loss = float(m["loss"])
    ft_s = time.perf_counter() - t
    ft_launches = _read_counts()
    log("memory", f"HookNet fine-tuning resnet18 b64 accum 2: loss {loss:.6f}, {1e3 * ft_s:.1f} "
        f"ms (the first step), peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"counts {tuple(m['tp'].shape)}, kernel launches {ft_launches}")
    if not (math.isfinite(loss) and tuple(m["tp"].shape) == (64, config.num_fg)):
        raise AssertionError(f"memory fine-tuning step: loss {loss}, counts {m['tp'].shape}")
    _no_launches("memory fine-tuning", ft_launches)
    summary = (f"resnet50 b32 {ssl['views_per_s']:.1f} tile views/s, peak "
               f"{ssl['peak_bytes'] / 2**30:.2f} GiB, held {ssl['held_bytes'] / 2**30:.2f} GiB; "
               f"remat {remat['views_per_s']:.1f} tile views/s, peak "
               f"{remat['peak_bytes'] / 2**30:.2f} GiB; card checks {checks}; ssl_train K1 "
               f"{cli_launches['K1']} in {steps} steps; HookNet b64 accum 2 first step "
               f"{1e3 * ft_s:.1f} ms")
    return {"ssl": ssl, "remat": remat, "checks": checks, "cli_launches": cli_launches,
            "ft_launches": ft_launches, "summary": summary}


# ---------------------------------------------------------------- distributed
# Phase "distributed" runs in child processes, each part with its own time
# limit: part (a) as ``python3 chip_smoke.py --distributed-part nccl
# ARGS_JSON``, which prints its readings as one ``DIST_RESULT {...}`` line;
# part (b) as two spawned ranks.
DIST_PART_TIMEOUT_S = {"nccl": 150, "gloo": 150}
DIST_SSL = dict(arch="resnet10", batch_size=8, scale=2, amp=False)
DIST_CASES = {  # name: (SSLConfig fields, --model-parallel)
    "ssl_accum1": ({}, 1),
    "ssl_accum2": ({"accum_steps": 2}, 1),
    "fused_adafactor_bf16": ({"inter_opt": "fused_adafactor", "inter_dtype": "bfloat16"}, 1),
    "model_parallel_2": ({}, 2),
    # the Gram products summed over the model group
    "model_parallel_2_fused": ({"inter_opt": "fused_adafactor"}, 2),
    # the main path's bf16 views and amp: K1 runs on half-precision views only
    "ssl_amp": ({"amp": True}, 1),
}


def _dist_ssl(extra: dict):
    """The SSL config and views' config of a DIST_CASES entry."""
    from msfwsi_tpu_torch.data.pipeline import AugConfig
    from msfwsi_tpu_torch.train.ssl import SSLConfig

    config = SSLConfig(**{**DIST_SSL, **extra})
    return config, AugConfig(grid=config.scale,
                             compute_dtype="bfloat16" if config.amp else "float32")
DIST_FT = dict(arch="resnet10", class_names=("a", "b", "c"), batch_size=8, amp=False)
DIST_VALID = (1, 1, 1, 0, 1, 1, 0, 0)  # 5 real tiles, wrap-padded per rank to 4 + 4


def _run_child(args: list, timeout: float) -> dict:
    """Run this script with ``args`` in its own process group, echo its
    output, kill the group at ``timeout``; returns its DIST_RESULT."""
    import signal

    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), *args],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        print(out[-4000:], flush=True)
        raise AssertionError(f"distributed part {args[1]} exceeded {timeout} s") from None
    result = None
    for line in out.splitlines():
        if line.startswith("DIST_RESULT "):
            result = json.loads(line[len("DIST_RESULT "):])
        else:
            print(f"    | {line}", flush=True)
    if proc.returncode != 0 or result is None:
        raise AssertionError(f"distributed part {args[1]} exited {proc.returncode}")
    return result


def _dist_part_nccl(root: str, logs: str) -> dict:
    """``ssl_train.main`` with the recipe's ``--multiprocessing-distributed
    --world-size 1 --rank 0`` (one card: a group of one, formed in this
    process over NCCL) and without them, resnet18 b32 scale 4 amp, 7 epochs
    of 1 step (the rate over the last 6); K1 counted over each run."""
    from msfwsi_tpu_torch import ssl_train
    from msfwsi_tpu_torch.diag import datapath as DP
    from msfwsi_tpu_torch.ops.cuda import colorops as K

    out = {}
    for name, extra in (("no_group", ()), ("recipe", ("--multiprocessing-distributed",
                                                      "--world-size", "1", "--rank", "0"))):
        K.LAUNCHES = 0  # the count to 0 just before the path
        res = ssl_train.main(DP.cli_argv(root, os.path.join(logs, name), epochs=7, extra=(
            "--steps-per-epoch", "1", *extra)))
        out[name] = {"launches": K.LAUNCHES, "steps": sum(e["steps"] for e in res["epochs"]),
                     "losses": [e["loss"] for e in res["epochs"]],
                     "group": res["process_group"], "views_per_s": DP.cli_rate(res, 32)}
        del res
    return out


def _factor_stats(state) -> dict:
    """``{weight name: {"v_row", "v_col"}}`` of the fused Adafactor's state
    on the CPU (empty without one), a split weight's factors gathered over
    the model group (a collective: every rank calls it)."""
    from msfwsi_tpu_torch.parallel import tp

    fused = getattr(state.optimizer, "optimizers", {}).get("fused_adafactor")
    if fused is None:
        return {}
    sd = tp.gather_optimizer_state(state.optimizer, state.model)["fused_adafactor"]
    names = {p: n for n, p in state.model.named_parameters()}
    params = [p for g in fused.param_groups for p in g["params"]]
    return {names[params[int(i)]]: {k: st[k].float().cpu() for k in ("v_row", "v_col")}
            for i, st in sd["state"].items()}


def _dist_worker(rank: int, store: str, tiles, masks, out_dir: str):
    """One of two ranks on the one card over gloo: the collectives gloo
    takes on CUDA tensors, this rank's half of the one-process references,
    then each case's fused step on this rank's rows (K1 counted per rank)
    and the fine-tuning step on its rows and pads. Each stage timed."""
    import torch
    import torch.distributed as dist

    from msfwsi_tpu_torch.data.pipeline import AugConfig
    from msfwsi_tpu_torch.models.hooknet import build_hooknet
    from msfwsi_tpu_torch.ops.cuda import colorops as K
    from msfwsi_tpu_torch.parallel import tp
    from msfwsi_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from msfwsi_tpu_torch.train import finetune as FT
    from msfwsi_tpu_torch.train import ssl as S

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=2)
    seconds = {"init": time.perf_counter() - t0}
    takes = {}
    x = torch.ones(4, device=dev)
    for op, call in (("all_reduce", lambda: dist.all_reduce(x.clone())),
                     ("broadcast", lambda: dist.broadcast(x.clone(), 0)),
                     ("all_gather", lambda: dist.all_gather([torch.empty_like(x) for _ in "ab"],
                                                            x))):
        try:
            call()
            torch.cuda.synchronize()
            takes[op] = True
        except (RuntimeError, ValueError) as e:
            takes[op] = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
    t1 = time.perf_counter()
    _dist_references(dev, tiles, masks, os.path.join(out_dir, f"one_rank{rank}.pt"),
                     [*DIST_CASES, "hooknet_trailing"][rank::2])
    seconds["references"] = time.perf_counter() - t1
    dist.barrier()
    out = {"takes": takes, "cases": {}, "seconds": seconds}
    t1 = time.perf_counter()
    for name, (extra, mp) in DIST_CASES.items():
        config, aug = _dist_ssl(extra)
        mesh = make_mesh(MeshSpec(model=mp))
        state = S.create_ssl_state(config, device=dev, mesh=mesh)
        step = S.make_fused_step(config, aug, device=dev, mesh=mesh)
        n = tiles.shape[0] // mesh.data
        part = torch.from_numpy(tiles[mesh.data_rank * n : (mesh.data_rank + 1) * n]).to(dev)
        K.LAUNCHES = 0  # this rank's count to 0 just before its step
        loss = float(step(state, part, torch.Generator(device=dev).manual_seed(7))["loss"])
        launches = K.LAUNCHES
        full = {k: v.cpu() for k, v in tp.full_state_dict(state.model).items()}
        factors = _factor_stats(state)
        if rank == 0:
            torch.save({"state": full, "factors": factors}, os.path.join(out_dir, f"{name}.pt"))
        out["cases"][name] = {"loss": loss, "launches": launches}
        del state, step, full
    config = FT.FinetuneConfig(**DIST_FT)
    mesh = make_mesh()
    model = build_hooknet(torch.Generator().manual_seed(0), arch=config.arch,
                          classes=config.num_classes)
    state = FT.create_finetune_state(config, device=dev, model=model, mesh=mesh)
    step = FT.make_fused_finetune_step(config, AugConfig(), device=dev, mesh=mesh)
    sl = slice(rank * 4, (rank + 1) * 4)
    valid = torch.tensor(DIST_VALID[sl], dtype=torch.bool)
    m = step(state, torch.from_numpy(tiles[sl]).to(dev), torch.from_numpy(masks[sl]).to(dev),
             torch.Generator(device=dev).manual_seed(7), valid=valid)
    out["cases"]["hooknet_trailing"] = {"loss": float(m["loss"]), "launches": 0}
    if rank == 0:
        torch.save({"state": {k: v.cpu() for k, v in state.model.state_dict().items()},
                    "factors": {}}, os.path.join(out_dir, "hooknet_trailing.pt"))
    seconds["cases"] = time.perf_counter() - t1
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def _dist_compare(name, one, two, lr, bf16=False, finetune=False, amp=False,
                  inter_opt="adam") -> dict:
    """Distances of the world-2 state ``two`` (``{"state", "factors"}``)
    from the one-process ``one`` under the CPU tests' bounds; raises beyond
    them. Adam-trained weights: within 2.05 lr, fewer than 1% of elements
    beyond 0.5 lr (``tests/test_torch_distributed.py``). Adafactor heads in
    fp32: within 0.05 lr (``tests/test_torch_tp.py``); on bf16 heads,
    within 10 lr with at most max(2, 0.5%) of a tensor's elements outside
    1e-2 + 1e-2 |ref| (``jax_suite_distances``' bf16 bounds). The fused
    Adafactor's ``v_row`` / ``v_col`` after the step (the mean squares of
    the global gradient) within rtol 1e-3, or 1e-2 (about one rounding
    step) in bf16. Under ``amp`` (bf16 activations) Adam's one-step bound
    alone, 2.05 lr, and the running stats within bf16's 2e-2; the share
    beyond 0.5 lr is reported, not gated."""
    worst = {"max_d_over_lr": 0.0, "loose_fraction": 0.0, "stats_max_abs": 0.0}
    total = loose = 0
    for k, v in one["state"].items():
        d = (two["state"][k].float() - v.float()).abs()
        if "running" in k:
            worst["stats_max_abs"] = max(worst["stats_max_abs"], float(d.max()))
            rtol, atol = (2e-2, 2e-2) if amp else (1e-3, 1e-5) if finetune else (1e-5, 1e-5)
            if not bool((d <= atol + rtol * v.float().abs()).all()):
                raise AssertionError(f"{name}: running stat {k} off by {float(d.max())}")
            continue
        if k.endswith("num_batches_tracked"):
            continue
        worst["max_d_over_lr"] = max(worst["max_d_over_lr"], float(d.max()) / lr)
        if inter_opt != "adam" and k.startswith("inter_"):
            limit = 10 * lr if bf16 else 0.05 * lr
            if bf16:
                out = int((d > 1e-2 + 1e-2 * v.float().abs()).sum())
                frac = out / d.numel()
                worst["inter_outside_fraction"] = max(worst.get("inter_outside_fraction", 0.0),
                                                      frac)
                if out > max(2, int(5e-3 * d.numel())):
                    raise AssertionError(f"{name}: {out} of {d.numel()} elements of {k} outside "
                                         "1e-2 + 1e-2 |ref|")
        elif finetune:
            limit = 2 * lr + 1e-6
            far = float((d > 1e-5 + 1e-3 * v.float().abs()).float().mean())
            worst["loose_fraction"] = max(worst["loose_fraction"], far)
            if far > 0.05:
                raise AssertionError(f"{name}: {far:.3f} of {k} outside rtol 1e-3")
        else:
            limit = 2.05 * lr
            loose += int((d > 0.5 * lr).sum())
            total += d.numel()
        if float(d.max()) > limit:
            raise AssertionError(f"{name}: {k} off by {float(d.max()) / lr:.3f} lr")
    if total:
        worst["loose_fraction"] = loose / total
        if loose / total >= 0.01 and not amp:
            raise AssertionError(f"{name}: {loose / total:.4f} of elements beyond 0.5 lr")
    if one["factors"].keys() != two["factors"].keys():
        raise AssertionError(f"{name}: factored weights {sorted(two['factors'])} vs one process "
                             f"{sorted(one['factors'])}")
    if one["factors"]:
        rtol = 1e-2 if bf16 else 1e-3
        rel = 0.0
        for k, f in one["factors"].items():
            for key, ref in f.items():
                r = float(((two["factors"][k][key] - ref).abs() / ref.abs().clamp_min(1e-30))
                          .max())
                rel = max(rel, r)
                if r > rtol:
                    raise AssertionError(f"{name}: {key} of {k} off by rel {r:.2e} > {rtol}")
        worst["factor_rel"] = rel
        worst["factored_weights"] = len(one["factors"])
    return worst


def _dist_references(dev, tiles, masks, out_path: str, names) -> None:
    """One process at the global batch on the card, for each of ``names``
    among DIST_CASES (the fused step) and ``hooknet_trailing`` (the HookNet
    step with the trailing batch's pads): losses, K1 counts, learning
    rates, states and fused-Adafactor factors."""
    import torch

    from msfwsi_tpu_torch.data.pipeline import AugConfig
    from msfwsi_tpu_torch.models.hooknet import build_hooknet
    from msfwsi_tpu_torch.ops.cuda import colorops as K
    from msfwsi_tpu_torch.train import finetune as FT
    from msfwsi_tpu_torch.train import ssl as S

    one = {}
    for name in names:
        if name == "hooknet_trailing":
            continue
        config, aug = _dist_ssl(DIST_CASES[name][0])
        state = S.create_ssl_state(config, device=dev)
        step = S.make_fused_step(config, aug, device=dev)
        K.LAUNCHES = 0
        loss = float(step(state, torch.from_numpy(tiles).to(dev),
                          torch.Generator(device=dev).manual_seed(7))["loss"])
        one[name] = {"loss": loss, "launches": K.LAUNCHES, "lr": config.init_lr,
                     "inter_opt": config.inter_opt,
                     "state": {k: v.cpu() for k, v in state.model.state_dict().items()},
                     "factors": _factor_stats(state)}
        del state, step
    if "hooknet_trailing" not in names:
        torch.save(one, out_path)
        return
    config = FT.FinetuneConfig(**DIST_FT)
    model = build_hooknet(torch.Generator().manual_seed(0), arch=config.arch,
                          classes=config.num_classes)
    state = FT.create_finetune_state(config, device=dev, model=model)
    step = FT.make_fused_finetune_step(config, AugConfig(), device=dev)
    m = step(state, torch.from_numpy(tiles).to(dev), torch.from_numpy(masks).to(dev),
             torch.Generator(device=dev).manual_seed(7),
             valid=torch.tensor(DIST_VALID, dtype=torch.bool))
    one["hooknet_trailing"] = {"loss": float(m["loss"]), "launches": 0, "lr": config.init_lr,
                               "inter_opt": "adam",
                               "state": {k: v.cpu() for k, v in state.model.state_dict().items()},
                               "factors": {}}
    torch.save(one, out_path)


def _dist_inputs():
    """The global batch of part (b): 8 uint8 tiles of 512 px and 4-class
    masks, the last of each rank's rows wrap-padded as DIST_VALID marks."""
    import numpy as np

    rng = np.random.default_rng(3)
    src = DIST_SSL["scale"] * 256
    tiles = rng.integers(0, 256, (8, src, src, 3), dtype=np.uint8)
    masks = rng.integers(0, 4, (8, src, src), dtype=np.uint8)
    for a, b in ((3, 0), (6, 4), (7, 5)):
        tiles[a], masks[a] = tiles[b], masks[b]
    return tiles, masks


def _dist_part_gloo(tmp: str, timeout: float) -> dict:
    """Two ranks on the one card over gloo, spawned from here and killed at
    ``timeout``; each rank first runs half of the one-process references.
    Each case's world-2 result against its reference under the CPU tests'
    bounds."""
    import torch
    import torch.multiprocessing as mp

    tiles, masks = _dist_inputs()
    t0 = time.perf_counter()
    ctx = mp.start_processes(_dist_worker, args=(os.path.join(tmp, "store"), tiles, masks, tmp),
                             nprocs=2, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=max(1.0, timeout - (time.perf_counter() - t0))):
            if time.perf_counter() - t0 > timeout:
                raise AssertionError(f"distributed part gloo exceeded {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
    world_s = time.perf_counter() - t0
    one = {}
    ranks = []
    for r in range(2):
        one.update(torch.load(os.path.join(tmp, f"one_rank{r}.pt"), weights_only=True))
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    out = {"takes": ranks[0]["takes"], "world_seconds": world_s,
           "rank_seconds": [r["seconds"] for r in ranks], "cases": {}}
    for name in [*DIST_CASES, "hooknet_trailing"]:
        ref = one[name]
        got = [r["cases"][name] for r in ranks]
        if got[0]["loss"] != got[1]["loss"]:
            raise AssertionError(f"{name}: the ranks' losses differ: {got}")
        bf16 = "bf16" in name
        amp = name == "ssl_amp"
        rel = abs(got[0]["loss"] - ref["loss"]) / max(abs(ref["loss"]), 1e-12)
        tol = 2e-2 * (1 + abs(ref["loss"])) if amp else (
            (5e-2 if bf16 else 1e-4) * abs(ref["loss"]) + 1e-5)
        if abs(got[0]["loss"] - ref["loss"]) > tol:
            raise AssertionError(f"{name}: loss {got[0]['loss']} vs one process {ref['loss']}")
        two = torch.load(os.path.join(tmp, f"{name}.pt"), weights_only=True)
        dist_ = _dist_compare(name, ref, two, ref["lr"], bf16=bf16,
                              finetune=name == "hooknet_trailing", amp=amp,
                              inter_opt=ref["inter_opt"])
        out["cases"][name] = {"loss": got[0]["loss"], "loss_one": ref["loss"], "loss_rel": rel,
                              "k1_per_rank": [g["launches"] for g in got],
                              "k1_one": ref["launches"], **dist_}
    return out


def phase_distributed(dev, root, tmp, slice_views_per_s, smi_line) -> dict:
    """(a) NCCL, one rank: the recipe's flags form a group of one on the
    card; K1 4 launches a step; the loss of the no-group run within bf16's
    2e-2; tile views/s beside phase slice's. (b) Two ranks on the one card
    over gloo (NCCL takes one rank a device) against one process at the
    global batch: the collectives gloo takes on CUDA tensors, then the SSL
    step at accum 1 and 2, the fused Adafactor on bf16 heads,
    ``--model-parallel 2`` with Adam and with the fused Adafactor, and a
    HookNet step with a wrap-padded trailing batch, within the CPU tests'
    bounds (fp32 views: no K1), and the SSL step under amp on bf16 views,
    K1 4 launches a rank. Each part in a child process with its own time
    limit."""
    t0 = time.perf_counter()
    logs = os.path.join(tmp, "dist_logs")
    a = _run_child(["--distributed-part", "nccl", json.dumps({"root": root, "logs": logs})],
                   DIST_PART_TIMEOUT_S["nccl"])
    rec, plain = a["recipe"], a["no_group"]
    log("distributed", f"(a) recipe flags: group {rec['group']}, losses {rec['losses']} vs no "
        f"group {plain['losses']}, K1 {rec['launches']} in {rec['steps']} steps; tile views/s "
        f"{rec['views_per_s']:.1f} (no group {plain['views_per_s']:.1f}, phase slice "
        f"{slice_views_per_s:.1f}) on {smi_line}")
    if rec["group"] != {"backend": "nccl", "world": 1, "rank": 0}:
        raise AssertionError(f"no NCCL group of one formed: {rec['group']}")
    if rec["launches"] != 4 * rec["steps"] or plain["launches"] != 4 * plain["steps"]:
        raise AssertionError(f"K1 launches {rec['launches']}/{plain['launches']}, want 4 a step")
    for x, y in zip(rec["losses"], plain["losses"]):
        if not (math.isfinite(x) and abs(x - y) <= 2e-2 * (1 + abs(y))):
            raise AssertionError(f"recipe-flag loss {x} vs no-group {y}")
    gdir = os.path.join(tmp, "dist_gloo")
    os.makedirs(gdir)
    b = _dist_part_gloo(gdir, DIST_PART_TIMEOUT_S["gloo"])
    log("distributed", f"(b) gloo on CUDA tensors takes: {b['takes']}; two ranks in "
        f"{b['world_seconds']:.1f} s (each rank's init, references, cases: "
        f"{[{k: round(v, 1) for k, v in r.items()} for r in b['rank_seconds']]})")
    for name, c in b["cases"].items():
        extra = "".join(f", {k} {c[k]:.3g}" for k in ("inter_outside_fraction", "factor_rel",
                                                       "factored_weights") if k in c)
        log("distributed", f"(b) {name}: loss {c['loss']:.7f} vs one process "
            f"{c['loss_one']:.7f} (rel {c['loss_rel']:.2e}), max |d| {c['max_d_over_lr']:.3f} "
            f"lr, beyond 0.5 lr {c['loose_fraction']:.4f}"
            f"{' (not gated)' if name == 'ssl_amp' else ''}, stats "
            f"{c['stats_max_abs']:.2e}{extra}; K1 per rank {c['k1_per_rank']} (one process "
            f"{c['k1_one']})")
        want = 4 if name == "ssl_amp" else 0  # fp32 views take no K1
        if c["k1_per_rank"] != [want, want] or c["k1_one"] != want:
            raise AssertionError(f"{name}: K1 {c['k1_per_rank']} a rank, {c['k1_one']} in one "
                                 f"process; want {want}")
    seconds = time.perf_counter() - t0
    log("distributed", f"passed in {seconds:.1f} s on {smi_line}")
    per_rank = sum(c["k1_per_rank"][0] for c in b["cases"].values())
    return {"nccl": a, "gloo": b, "seconds": seconds,
            "launches": {"recipe": {"K1": rec["launches"], "K2": 0, "probe": 0},
                         "rank0": {"K1": per_rank, "K2": 0, "probe": 0},
                         "rank1": {"K1": sum(c["k1_per_rank"][1] for c in b["cases"].values()),
                                   "K2": 0, "probe": 0}}}


def distributed_part(part: str, args: dict) -> int:
    """Entry of part (a)'s child process."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    faulthandler.dump_traceback_later(DIST_PART_TIMEOUT_S[part] - 10, exit=True)
    out = _dist_part_nccl(**args)
    print("DIST_RESULT " + json.dumps(out), flush=True)
    return 0


def kernels_line(rows, slice_out, blur_rows, blur_path, probe_launches, probe_rows, cli_out,
                 ft_out, ft_cli_out, other_paths):
    """One entry per kernel. K1's times are for its work in one main-path
    step: 2 launches at (32,224,224,3) and 2 at (32,1024,1024,3), bf16;
    ``launches`` is phase slice's count, ``launches_by_path`` adds the CLI's
    runs.
    K2's are for one launch of its path, (32,1024,1024,3) fp32. A probe's
    are the sums over its cases, one launch each. ``ms`` is the device's
    time, ``host_ms`` the time a caller sees, the wrapper's host cost
    included."""
    per_launch = {tuple(r["shape"]): r for r in rows
                  if r["dtype"] == "bfloat16" and "mix" not in r}

    def per_step(key):
        return sum(2 * per_launch[s][key] for s in MAIN_SHAPES)

    def finetune_paths(key):
        """The counts of the later paths: fine-tuning, inference, serving
        and the encoders' paths (0 but for K1 on the SSL runs among them:
        ``prepare_cli``, ``encoders_ssl``)."""
        return {"finetune": ft_out["launches"][key], "ft_cli": ft_cli_out["launches"][key],
                **{path: launches[key] for path, launches in other_paths.items()}}

    t_bytes_dominates = all(per_launch[s]["bound_by"] == "bytes" for s in MAIN_SHAPES)
    err = max(per_launch[s]["max_abs_err"] for s in MAIN_SHAPES)
    path = next(r for r in blur_rows
                if r["shape"] == blur_path["shape"] and r["dtype"] == "float32")
    probes = []
    for probe, script in (("P1", "mosaic_probe.py:12"), ("P2", "mosaic_probe2.py:12"),
                          ("P3", "mosaic_probe3.py:12")):
        mine = [r for r in probe_rows if r["probe"] == probe]
        total = {k: sum(r[k] for r in mine)
                 for k in ("ms", "host_ms", "plain_ms", "library_ms", "bound_ms")}
        perr = max(r["max_abs_err"] for r in mine)
        probes.append({
            "name": f"layout_probe {probe}", "route": "cuda",
            "source": "msfwsi_tpu_torch/csrc/layout_probe.cu",
            "replaces": f"tools/diag/{script}",
            "launches": probe_launches[probe], "launches_per_step": 0,
            "launches_by_path": {"probe": probe_launches[probe], **finetune_paths("probe")},
            "max_abs_err": perr, "max_abs_diff": perr,
            "ms": total["ms"], "kernel_ms": total["ms"], "host_ms": total["host_ms"],
            "plain_ms": total["plain_ms"],
            "bound_ms": total["bound_ms"], "bound_by": "bytes",
            "library_ms": total["library_ms"], "checks": mine,
        })
    return {"kernels": [{
        "name": "blur_or_sharpen_fused",
        "route": "cuda",
        "source": "msfwsi_tpu_torch/csrc/colorops.cu",
        "replaces": "msfwsi_tpu/ops/pallas/colorops.py:104",
        "launches": slice_out["launches"],
        "launches_by_path": {"slice": slice_out["launches"], "cli_png": cli_out["launches_png"],
                             "cli_pack": cli_out["launches_pack"], **finetune_paths("K1")},
        "launches_per_step": slice_out["launches"] // slice_out["steps"],
        "max_abs_err": err,
        "max_abs_diff": err,
        "ms": per_step("ms"),
        "kernel_ms": per_step("ms"),
        "host_ms": per_step("host_ms"),
        "plain_ms": per_step("plain_ms"),
        "bound_ms": per_step("bound_ms"),
        "bound_by": "bytes" if t_bytes_dominates else "operations",
        "library_ms": None,  # no single PyTorch call selects blur/sharpen/none per sample
        "checks": rows,
    }, {
        "name": "separable_blur_nhwc",
        "route": "cuda",
        "source": "msfwsi_tpu_torch/csrc/blur.cu",
        "replaces": "msfwsi_tpu/ops/pallas/blur.py:89",
        "launches": blur_path["launches"],
        "launches_per_step": 0,
        "launches_by_path": {"blur": blur_path["launches"], **finetune_paths("K2")},
        "max_abs_err": path["max_abs_err"],
        "max_abs_diff": path["max_abs_err"],
        "ms": path["ms"],
        "kernel_ms": path["ms"],
        "host_ms": path["host_ms"],
        "plain_ms": path["plain_ms"],
        "bound_ms": path["bound_ms"],
        "bound_by": path["bound_by"],
        "library_ms": path["library_ms"],  # F.pad(reflect) + 2 x depthwise F.conv2d
        "checks": blur_rows,
    }] + probes}


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if len(sys.argv) == 4 and sys.argv[1] == "--distributed-part":
        return distributed_part(sys.argv[2], json.loads(sys.argv[3]))
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import msfwsi_tpu_torch  # noqa: F401  (fails here, before any output, outside a checkout)

    dev = torch.device("cuda", 0)
    name, smi_line = phase_device()
    phase_build()
    rows = phase_kernel(dev)
    phase_small(dev)
    slice_out = phase_slice(dev)
    blur_rows, blur_path = phase_blur(dev)
    probe_launches, probe_rows = phase_probe(dev)
    phase_edges(dev)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        root, _ = phase_datapath(dev, tmp)
        cli_out = phase_cli(dev, root, tmp, slice_out["views_per_s"])
        phase_bench(dev)
        ft_out = phase_finetune(dev)
        packed_out = phase_packed(dev, smi_line, ft_out)
        ft_cli_out = phase_ft_cli(dev, root, tmp, cli_out["ckpt_dir"], ft_out["pairs_per_s"])
        eval_out = phase_eval_cli(dev, root, tmp, ft_cli_out, smi_line)
        pred_out = phase_predict(dev, root, tmp, ft_cli_out, eval_out, smi_line)
        feat_out = phase_features(dev, root, tmp, cli_out["ckpt_dir"], smi_line)
        bench_eval = phase_bench_eval(dev)
        prep_out = phase_prepare(dev, tmp, smi_line)
        serve_out = phase_serving(dev, root, tmp, ft_cli_out, smi_line)
        enc_out = phase_encoders(dev, smi_line)
        mem_out = phase_memory(dev, root, tmp, smi_line)
        dist_out = phase_distributed(dev, root, tmp, slice_out["views_per_s"], smi_line)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    other_paths = {**packed_out["launches"], "eval_cli": eval_out["launches"],
                   "eval_cli_device": eval_out["launches_device"],
                   "predict": pred_out["launches"], "features": feat_out["launches"],
                   "bench_eval_e2e": bench_eval["launches"], "prepare_cli": prep_out["launches"],
                   "serving": serve_out["launches"], "encoders_ssl": enc_out["ssl_launches"],
                   "encoders_ft": enc_out["ft_launches"],
                   "memory_ssl": mem_out["ssl"]["launches"],
                   "memory_remat": mem_out["remat"]["launches"],
                   "memory_cli": mem_out["cli_launches"], "memory_ft": mem_out["ft_launches"],
                   "distributed_recipe_nccl": dist_out["launches"]["recipe"],
                   "distributed_gloo_rank0": dist_out["launches"]["rank0"],
                   "distributed_gloo_rank1": dist_out["launches"]["rank1"]}
    line = kernels_line(rows, slice_out, blur_rows, blur_path, probe_launches, probe_rows,
                        cli_out, ft_out, ft_cli_out, other_paths)
    # Repeated here so that the end of the output, which may be all a caller
    # keeps, carries the memory path's readings.
    log("memory", f"summary: {mem_out['summary']} on {smi_line}")
    print(json.dumps(line), flush=True)
    log("done", f"all phases passed in {time.perf_counter() - T0:.1f} s on {smi_line}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
