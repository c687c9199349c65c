"""Standalone separable per-sample 23-tap Gaussian blur: CUDA kernel + plain version.

Replaces the Pallas TPU kernel ``msfwsi_tpu/ops/pallas/blur.py``
(``separable_blur_nhwc``; launcher ``_vblur``, body ``_vblur_kernel``),
which makes a vertical pass, transposes H and W in device memory, makes a
second vertical pass and transposes back. The kernel is ``csrc/blur.cu``;
it makes both passes in one launch, and its note says what bounds it on an
H100 and what the design does about that. :func:`launch_plan` picks the
height of the kernel's strips and its 16-byte row path.

:func:`separable_blur_nhwc` picks by the device of the image: a CPU tensor
goes through :func:`separable_blur_nhwc_ref`, a CUDA tensor launches the
kernel (or raises). There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from ..geometry import reflect_index
from . import stencil

__all__ = ["KMAX", "HALF", "LAUNCHES", "blur_supported", "launch_plan", "separable_blur_nhwc",
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


# A block's strip: SW output pixels across (csrc/blur.cu), walked down in
# chunks of KMAX rows; a launch makes strips of STRIP_CHUNKS chunks where
# that still gives the card at least BLOCKS_PER_SM blocks per
# multiprocessor, else of FEW_CHUNKS (a 224 px image has too few rows for
# tall strips).
SW = 80
STRIP_CHUNKS, FEW_CHUNKS = 6, 3
BLOCKS_PER_SM = 8


def launch_plan(shape, itemsize: int, *ptrs: int, sms: int) -> tuple[int, int]:
    """(chunks, vec) of the launch for an (N, H, W, 3) image of
    ``itemsize``-byte elements at the addresses ``ptrs`` (input and output)
    on a card of ``sms`` multiprocessors: the strip's height in chunks of
    KMAX rows, and 1 for the 16-byte rows (``stencil.vector_rows``), else 0."""
    N, H, W, _ = shape
    blocks = N * -(-W // SW) * -(-H // (KMAX * STRIP_CHUNKS))
    chunks = STRIP_CHUNKS if blocks >= BLOCKS_PER_SM * sms else FEW_CHUNKS
    return chunks, int(stencil.vector_rows(W, itemsize, *ptrs))


def separable_blur_nhwc(img, kern):
    """Blur (N, H, W, 3) images with per-sample 1-D taps, reflect-101.

    Args:
      img: (N, H, W, 3) float32 / bfloat16 / float16, contiguous, H, W > 11.
      kern: (N, 23) float32 normalized taps; taps beyond a sample's kernel
        size must be zero.
    Returns the blurred images in the input dtype (fp32 sums).
    """
    if img.device.type == "cpu":
        return separable_blur_nhwc_ref(img, kern)
    if img.device.type != "cuda":
        raise ValueError(f"no kernel for device {img.device}")
    _check(img, kern)
    if img.shape[0] > 65535:
        raise ValueError(f"batch {img.shape[0]} exceeds the kernel's grid limit of 65535")
    out = torch.empty_like(img)
    sms = torch.cuda.get_device_properties(img.device).multi_processor_count
    plan = launch_plan(img.shape, img.element_size(), img.data_ptr(), out.data_ptr(), sms=sms)
    return _launch(img, kern, out, plan)


def _launch(img, kern, out, plan):
    """Launch the kernel with ``plan`` = (chunks, vec) on checked CUDA
    tensors; count the launch."""
    global LAUNCHES
    N, H, W, _ = img.shape
    lib = _build.load("blur")
    fn = lib.msfwsi_separable_blur_nhwc
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(img.data_ptr(), out.data_ptr(), kern.data_ptr(), N, H, W,
                _DTYPE_CODES[img.dtype], *plan, stream)
    if rc != 0:
        raise RuntimeError(f"separable_blur_nhwc: kernel launch failed with CUDA error {rc}")
    LAUNCHES += 1
    return out
