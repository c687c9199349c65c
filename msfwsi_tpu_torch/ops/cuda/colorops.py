"""Fused per-sample blur-OR-sharpen-OR-passthrough: CUDA kernel + plain version.

Replaces the Pallas TPU kernel ``msfwsi_tpu/ops/pallas/colorops.py``
(``blur_or_sharpen_fused``; body ``_kernel``, launcher ``_call``). The
kernel is ``csrc/colorops.cu``; its note says what bounds it on an H100
(memory: one read and one write of the image) and how the design keeps the
blur's intermediate and the reflect-101 halo out of device memory.
:func:`launch_plan` picks the kernel's 16-byte row path.

:func:`blur_or_sharpen_fused` picks by the device of the image: a CPU
tensor goes through :func:`blur_or_sharpen_fused_ref`, a CUDA tensor
launches the kernel (or raises). There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from ..geometry import reflect_pad_hw
from . import stencil

__all__ = ["KMAX17", "HALF", "LAUNCHES", "blur_or_sharpen_fused", "blur_or_sharpen_fused_ref",
           "launch_plan"]

KMAX17 = 17
HALF = KMAX17 // 2

# Kernel launches since the count was last set to 0 (chip_smoke.py reads it
# to prove the main path went through the kernel).
LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check(img, blur_kern, sharp_kern, op_select):
    if img.dim() != 4 or img.shape[-1] != 3:
        raise ValueError(f"img must be (N, H, W, 3), got {tuple(img.shape)}")
    N, H, W, _ = img.shape
    if H <= HALF or W <= HALF:
        raise ValueError(f"H and W must exceed {HALF} for the reflect-101 halo, got {H}x{W}")
    if img.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported image dtype {img.dtype}")
    expect = (
        ("blur_kern", blur_kern, (N, KMAX17), torch.float32),
        ("sharp_kern", sharp_kern, (N, 3, 3), torch.float32),
        ("op_select", op_select, (N,), torch.int32),
    )
    for name, t, shape, dtype in expect:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
        if t.device != img.device:
            raise ValueError(f"{name} is on {t.device}, img on {img.device}")
    for name, t in (("img", img), ("blur_kern", blur_kern), ("sharp_kern", sharp_kern),
                    ("op_select", op_select)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def blur_or_sharpen_fused_ref(img, blur_kern, sharp_kern, op_select):
    """Plain PyTorch version of the kernel: shifted FMAs in fp32 on the
    samples that drew each op, cast back to the input dtype at the end."""
    _check(img, blur_kern, sharp_kern, op_select)
    N, H, W, C = img.shape
    x = img.float()
    out = x.clone()
    blur = (op_select == 1).nonzero().flatten()
    if blur.numel():
        k = blur_kern[blur]
        pad = reflect_pad_hw(x[blur], HALF)
        rows = torch.zeros((blur.numel(), H, W + 2 * HALF, C), device=img.device)
        for t in range(KMAX17):
            rows += k[:, t, None, None, None] * pad[:, t : t + H]
        acc = torch.zeros((blur.numel(), H, W, C), device=img.device)
        for t in range(KMAX17):
            acc += k[:, t, None, None, None] * rows[:, :, t : t + W]
        out[blur] = acc
    sharp = (op_select == 2).nonzero().flatten()
    if sharp.numel():
        k = sharp_kern[sharp]
        pad = reflect_pad_hw(x[sharp], 1)
        acc = torch.zeros((sharp.numel(), H, W, C), device=img.device)
        for dy in range(3):
            for dx in range(3):
                acc += k[:, dy, dx, None, None, None] * pad[:, dy : dy + H, dx : dx + W]
        out[sharp] = acc.clamp(0.0, 1.0)
    return out.to(img.dtype)


def launch_plan(shape, itemsize: int, *ptrs: int) -> int:
    """The kernel's ``vec`` argument for an (N, H, W, 3) image of
    ``itemsize``-byte elements at the addresses ``ptrs`` (input and output):
    1 for the 16-byte rows (``stencil.vector_rows``), else 0."""
    return int(stencil.vector_rows(shape[2], itemsize, *ptrs))


def blur_or_sharpen_fused(img, blur_kern, sharp_kern, op_select):
    """Apply per sample a 17-tap separable blur (``op_select == 1``), a 3x3
    clipped sharpen (``== 2``) or nothing (any other value).

    Args:
      img: (N, H, W, 3) float32 / bfloat16 / float16, contiguous, H, W > 8.
      blur_kern: (N, 17) float32 normalized taps (zero beyond the sampled ksize).
      sharp_kern: (N, 3, 3) float32.
      op_select: (N,) int32.
    """
    if img.device.type == "cpu":
        return blur_or_sharpen_fused_ref(img, blur_kern, sharp_kern, op_select)
    if img.device.type != "cuda":
        raise ValueError(f"no kernel for device {img.device}")
    _check(img, blur_kern, sharp_kern, op_select)
    if img.shape[0] > 65535:
        raise ValueError(f"batch {img.shape[0]} exceeds the kernel's grid limit of 65535")
    out = torch.empty_like(img)
    vec = launch_plan(img.shape, img.element_size(), img.data_ptr(), out.data_ptr())
    return _launch(img, blur_kern, sharp_kern, op_select, out, vec)


def _launch(img, blur_kern, sharp_kern, op_select, out, vec):
    """Launch the kernel on checked CUDA tensors with the row path ``vec``;
    count the launch."""
    global LAUNCHES
    N, H, W, _ = img.shape
    lib = _build.load("colorops")
    fn = lib.msfwsi_blur_or_sharpen_fused
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(img.data_ptr(), out.data_ptr(), blur_kern.data_ptr(), sharp_kern.data_ptr(),
                op_select.data_ptr(), N, H, W, _DTYPE_CODES[img.dtype], vec, stream)
    if rc != 0:
        raise RuntimeError(f"blur_or_sharpen_fused: kernel launch failed with CUDA error {rc}")
    LAUNCHES += 1
    return out
