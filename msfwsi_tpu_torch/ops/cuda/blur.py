"""Standalone separable per-sample 23-tap Gaussian blur: CUDA kernel + plain version.

Replaces the Pallas TPU kernel ``msfwsi_tpu/ops/pallas/blur.py``
(``separable_blur_nhwc``; launcher ``_vblur``, body ``_vblur_kernel``),
which makes a vertical pass, transposes H and W in device memory, makes a
second vertical pass and transposes back. The kernel is ``csrc/blur.cu``;
it makes both passes in one launch, and its note says what bounds it on an
H100 and what the design does about that.

:func:`separable_blur_nhwc` picks by the device of the image: a CPU tensor
goes through :func:`separable_blur_nhwc_ref`, a CUDA tensor launches the
kernel (or raises). There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from ..geometry import reflect_index

__all__ = ["KMAX", "HALF", "LAUNCHES", "blur_supported", "separable_blur_nhwc",
           "separable_blur_nhwc_ref"]

KMAX = 23
HALF = KMAX // 2

# Kernel launches since the count was last set to 0 (chip_smoke.py reads it
# to prove the blur path went through the kernel).
LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def blur_supported(shape) -> bool:
    """The JAX op's rule: C = 3, H and W 8-aligned and larger than the
    11-pixel reflect-101 overhang. The kernel itself needs only C = 3 and
    H, W > 11; the 8-alignment is the TPU's and the op keeps it."""
    _, H, W, C = shape
    return C == 3 and H % 8 == 0 and W % 8 == 0 and H > HALF and W > HALF


def _check(img, kern):
    if img.dim() != 4 or img.shape[-1] != 3:
        raise ValueError(f"img must be (N, H, W, 3), got {tuple(img.shape)}")
    N, H, W, _ = img.shape
    if H <= HALF or W <= HALF:
        raise ValueError(f"H and W must exceed {HALF} for the reflect-101 halo, got {H}x{W}")
    if img.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported image dtype {img.dtype}")
    if tuple(kern.shape) != (N, KMAX) or kern.dtype != torch.float32:
        raise ValueError(f"kern must be ({N}, {KMAX}) float32, got {tuple(kern.shape)} "
                         f"{kern.dtype}")
    if kern.device != img.device:
        raise ValueError(f"kern is on {kern.device}, img on {img.device}")
    for name, t in (("img", img), ("kern", kern)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _pass(x, kern, axis: int):
    """One 23-tap pass along ``axis`` (1 = H, 2 = W) of the fp32 tensor
    ``x``, reflect-101; fp32 sums in tap order."""
    n = x.shape[axis]
    pad = x.index_select(axis, reflect_index(n, HALF, x.device))
    acc = torch.zeros_like(x)
    for t in range(KMAX):
        acc += kern[:, t, None, None, None] * pad.narrow(axis, t, n)
    return acc


def separable_blur_nhwc_ref(img, kern):
    """Plain PyTorch version, computed as the Pallas function computes it:
    a vertical pass in fp32 rounded to the image dtype (``_vblur`` returns
    the input dtype), then a horizontal pass in fp32 rounded again."""
    _check(img, kern)
    v = _pass(img.float(), kern, axis=1).to(img.dtype)
    return _pass(v.float(), kern, axis=2).to(img.dtype)


def separable_blur_nhwc(img, kern):
    """Blur (N, H, W, 3) images with per-sample 1-D taps, reflect-101.

    Args:
      img: (N, H, W, 3) float32 / bfloat16 / float16, contiguous, H, W > 11.
      kern: (N, 23) float32 normalized taps; taps beyond a sample's kernel
        size must be zero.
    Returns the blurred images in the input dtype (fp32 sums).
    """
    global LAUNCHES
    if img.device.type == "cpu":
        return separable_blur_nhwc_ref(img, kern)
    if img.device.type != "cuda":
        raise ValueError(f"no kernel for device {img.device}")
    _check(img, kern)
    N, H, W, _ = img.shape
    if N > 65535:
        raise ValueError(f"batch {N} exceeds the kernel's grid limit of 65535")
    lib = _build.load("blur")
    fn = lib.msfwsi_separable_blur_nhwc
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(img)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(img.data_ptr(), out.data_ptr(), kern.data_ptr(), N, H, W,
                _DTYPE_CODES[img.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"separable_blur_nhwc: kernel launch failed with CUDA error {rc}")
    LAUNCHES += 1
    return out
