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
   card against the same inputs, view parameters and weights on the CPU,
   and the decoder's convolutions taking bf16 under autocast; then the
   fused fine-tuning step at full width (resnet18 HookNet, b64, 256 px
   context and target views from (64,1024,1024,3) uint8 tiles and
   (64,1024,1024) masks in 6 classes, bf16 amp, Dice lam 1, Adam) for 2
   warm-up and 5 timed steps: finite loss, no kernel launch (the seg views
   draw no blur or sharpen), pairs/s (B*steps/seconds), ms/step and peak
   memory; then 3 steps traced by ``torch.profiler``;
13. ft_cli: ``ssl_finetune.main`` in-process on the datapath's tiles, which
   gain grey mask PNGs and a validation slide of 16 tiles: from phase
   "cli"'s ``checkpoint_0001.pth.tar``, the branch encoders equal the
   checkpoint's bit for bit before any step; then resnet18, amp, b16, 2
   epochs of 2 steps, a validation each epoch: finite losses, scores in
   [0, 1], a ``best_ft_model.pth.tar`` equal to the model saved; a run with
   ``--val-views device``; host and device views on one model scoring
   alike; the CLI's pairs/s (from each epoch's first batch in hand, the
   fill apart) beside phase "finetune"'s;
14. the kernels JSON line, then the result line.

Any failed phase ends the run with a non-zero exit and no result line. A
watchdog dumps the stacks and exits if the run hangs. Without a CUDA device
the script exits non-zero at once.
"""

from __future__ import annotations

import faulthandler
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

# A hang must end in a traceback well before any outer time limit: the
# whole run, build and profile included, takes about two minutes on an H100.
WATCHDOG_S = 480
T0 = time.perf_counter()

MAIN_SHAPES = ((32, 224, 224, 3), (32, 1024, 1024, 3))
EDGE_SHAPES = {
    "blur_or_sharpen_fused": ((1, 16, 16, 3), (3, 17, 23, 3), (3, 40, 72, 3), (2, 1000, 1016, 3)),
    "separable_blur_nhwc": ((1, 12, 12, 3), (2, 13, 29, 3), (3, 40, 72, 3), (2, 1000, 1016, 3)),
}
TOLERANCE = {"float32": 1e-5, "bfloat16": 2e-2, "float16": 2e-2}


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


def profile_steps(step, steps):
    """Trace ``steps`` calls of ``step`` with torch.profiler and log the
    wall time per step, the device's busy share (the union of kernel
    intervals over the traced wall time) and the CUDA time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            metrics = step()
        float(metrics["loss"])
        wall_s = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        raise AssertionError("the profiler recorded no device events")
    busy_s = _busy_us(kernels) * 1e-6
    log("profile", f"{1e3 * wall_s / steps:.1f} ms/step over {steps} traced steps, device busy "
        f"{100 * busy_s / wall_s:.1f}% ({1e3 * busy_s / steps:.1f} ms/step of kernels)")
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    total = sum(by_name.values())
    mma_names = ("conv", "xmma", "gemm", "gemv", "cutlass", "cudnn")
    mma = sum(us for name, us in by_name.items() if any(k in name.lower() for k in mma_names))
    log("profile", f"convolution and matmul kernels (cuDNN, cuBLAS): {mma / 1e3 / steps:.3f} "
        f"ms/step ({100 * mma / total:.2f}% of the kernels' time)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:25]:
        log("profile", f"{us / 1e3 / steps:9.3f} ms/step {100 * us / total:6.2f}%  {name[:110]}")


def phase_slice(dev, batch=32, arch="resnet18", scale=4, warmup=2, steps=5, traced=3):
    """The main path: ``make_fused_step`` at full width, then ``traced``
    steps under the profiler. Returns its numbers."""
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
    log("slice", f"views ok: {', '.join(f'{k} {s}' for k, s in want.items())}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.LAUNCHES = 0  # every kernel count to 0 just before the main path
    t_start = time.perf_counter()
    for i in range(warmup):
        loss = float(step(state, tiles, gen)["loss"])
        log("slice", f"warm-up step {i + 1}: loss {loss:.6f}")
    t0 = time.perf_counter()
    for _ in range(steps):
        metrics = step(state, tiles, gen)
    loss = float(metrics["loss"])  # synchronizes
    dt = time.perf_counter() - t0
    launches = K.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    total = warmup + steps
    views_per_s = batch * steps * (2 + 2 * K_tiles) / dt
    log("slice", f"{steps} timed steps in {dt:.3f} s ({1e3 * dt / steps:.1f} ms/step, "
        f"{total} steps {time.perf_counter() - t_start:.1f} s): loss {loss:.6f}, "
        f"{views_per_s:.1f} tile views/s/device, peak memory {peak / 2**30:.2f} GiB, "
        f"blur_or_sharpen_fused launches {launches}")
    if not math.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    if launches != 4 * total:
        raise AssertionError(f"{launches} kernel launches in {total} steps, want 4 per step")
    profile_steps(lambda: step(state, tiles, gen), traced)
    return {"launches": launches, "steps": total, "loss": loss, "views_per_s": views_per_s,
            "step_ms": 1e3 * dt / steps, "peak_bytes": peak}


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


def _state_equal(state, payload) -> bool:
    """Whether a train state holds the model and Adam state of a saved
    checkpoint payload, bit for bit."""
    import torch

    sd = state.model.state_dict()
    model_ok = sd.keys() == {k.removeprefix("module.") for k in payload["state_dict"]} and all(
        torch.equal(sd[k.removeprefix("module.")].cpu(), v.cpu())
        for k, v in payload["state_dict"].items())
    got, want = state.optimizer.state_dict()["state"], payload["optimizer"]["state"]
    opt_ok = got.keys() == want.keys() and all(
        got[i].keys() == want[i].keys() and all(torch.equal(got[i][k].cpu(), want[i][k].cpu())
                                                for k in want[i])
        for i in want)
    return model_ok and opt_ok


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


def phase_finetune(dev, batch=64, arch="resnet18", warmup=2, steps=5, traced=3):
    """The fine-tuning step: a small fp32 step on the card against the CPU,
    then the fused step at full width and under the profiler. Returns its
    numbers."""
    import copy

    import numpy as np
    import torch

    from msfwsi_tpu_torch.data.pipeline import AugConfig, sample_seg_train_views
    from msfwsi_tpu_torch.train import finetune as FT

    # a small step, card against CPU (TF32 off)
    config = FT.FinetuneConfig(arch="resnet10", batch_size=4, amp=False)
    aug = AugConfig(seg_size=64)
    rng = np.random.default_rng(2)
    imgs = torch.from_numpy(rng.integers(0, 256, (4, 256, 256, 3), np.uint8))
    masks = torch.from_numpy(rng.integers(0, config.num_classes, (4, 256, 256), np.uint8))
    params = sample_seg_train_views(torch.Generator().manual_seed(2), 4, aug)
    cpu_state = FT.create_finetune_state(config, device="cpu")
    dev_state = FT.create_finetune_state(config, device=dev, model=copy.deepcopy(cpu_state.model))
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
    moved = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        dev_state.model.state_dict().values(), cpu_state.model.state_dict().values()))
    log("finetune", f"fp32 step, resnet10 b4 64 px: loss card {loss_dev:.8f}, cpu {loss_cpu:.8f}; "
        f"weights and stats after it differ by at most {moved:.3g} "
        f"(2 lr = {2 * config.init_lr:.3g})")
    if not (math.isfinite(loss_dev) and math.isclose(loss_dev, loss_cpu, rel_tol=1e-3)):
        raise AssertionError(f"fine-tuning loss on the card {loss_dev} vs the CPU {loss_cpu}")
    if not moved <= 2 * config.init_lr + 1e-4:
        raise AssertionError(f"weights after one step differ by {moved} between card and CPU")
    # under amp every decoder convolution takes bf16, as at dtype bf16 in JAX
    seen = []
    model = dev_state.model
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
    del cpu_state, dev_state, model

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
    from msfwsi_tpu_torch.models.hooknet import HookNet
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
    out.update(pairs_per_s=rates, fill_s=fills, val_s=[e["val_seconds"] for e in epochs])

    # one model, both kinds of evaluation views
    model = res["state"].model
    aug = AugConfig(seg_size=256, compute_dtype="bfloat16")
    slide = load_slide_arrays(root, groups[0])
    classes = ssl_finetune.CLASS_NAMES["bcss"]
    by_views = {}
    for views in ("host", "device"):
        stats = EV.make_chunk_stats_for_views(model, len(classes), views, aug, amp=True)
        item = make_seg_val_views_host(*slide, aug) if views == "host" else slide
        by_views[views] = EV.validate_slides(stats, [item], views, classes, device=dev).summary()
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


def kernels_line(rows, slice_out, blur_rows, blur_path, probe_launches, probe_rows, cli_out,
                 ft_out, ft_cli_out):
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
        return {"finetune": ft_out["launches"][key], "ft_cli": ft_cli_out["launches"][key]}

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
        ft_cli_out = phase_ft_cli(dev, root, tmp, cli_out["ckpt_dir"], ft_out["pairs_per_s"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    line = kernels_line(rows, slice_out, blur_rows, blur_path, probe_launches, probe_rows,
                        cli_out, ft_out, ft_cli_out)
    print(json.dumps(line), flush=True)
    log("done", f"all phases passed in {time.perf_counter() - T0:.1f} s on {smi_line}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
