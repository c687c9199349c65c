"""Batched on-device image augmentation (the SSL subset), NHWC, in PyTorch.

Port of ``msfwsi_tpu/ops/augment.py``. Images are float in [0, 1], NHWC.
Every random op is split in two: ``sample_*`` draws its parameters from an
explicit ``torch.Generator`` (on the device the parameters are wanted on),
and an apply function takes them. The apply functions are deterministic, so
the tests feed them the parameters that the JAX samplers drew and compare
outputs; the samplers themselves are held to the JAX samplers'
distributions. Where a JAX sampler turns uniform draws into parameters with
some logic (RandomResizedCrop boxes, blur taps, sharpen kernels), that logic
is a ``*_from_draws`` function of its own, so it too can be compared exactly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from .cuda import blur as _blur
from .cuda.colorops import HALF as _FUSED_HALF
from .cuda.colorops import KMAX17, blur_or_sharpen_fused
from .geometry import reflect_pad_hw

__all__ = [
    "ColorJitterConfig",
    "rgb_to_grayscale",
    "sample_jitter_params",
    "color_jitter",
    "apply_color_jitter",
    "sample_to_gray",
    "apply_to_gray",
    "to_gray",
    "blur_kmax",
    "blur_taps_from_draws",
    "sample_blur_taps",
    "sharpen_kern_from_draws",
    "sample_sharpen_kern",
    "apply_gaussian_blur",
    "gaussian_blur",
    "apply_sharpen",
    "sample_blur_or_sharpen",
    "apply_blur_or_sharpen",
    "blur_or_sharpen",
    "normalize",
    "rrc_boxes_from_draws",
    "sample_rrc_boxes",
    "crop_and_resize_mxu",
    "random_resized_crop",
]

_HALF_DTYPES = (torch.bfloat16, torch.float16)


def _uniform(gen, shape, lo: float, hi: float):
    """U[lo, hi) float32 on the generator's device."""
    return torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) + lo


# --------------------------------------------------------------------------
# Color ops
# --------------------------------------------------------------------------

_GRAY_WEIGHTS = (0.299, 0.587, 0.114)


def rgb_to_grayscale(img):
    """(..., 3) -> (..., 1) luma."""
    w = torch.tensor(_GRAY_WEIGHTS, dtype=img.dtype, device=img.device)
    return torch.tensordot(img, w, dims=([-1], [0]))[..., None]


def _rgb_to_hsv(img):
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = img.amax(dim=-1)
    minc = img.amin(dim=-1)
    v = maxc
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / maxc.clamp_min(1e-12), 0.0)
    safe = delta.clamp_min(1e-12)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(
        maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc)
    )
    h = torch.where(delta > 0, (h / 6.0) % 1.0, 0.0)
    return torch.stack([h, s, v], dim=-1)


def _hsv_to_rgb(hsv):
    """Branchless, continuous HSV->RGB (the "K-formula"): each channel is
    ``v - v*s*clip(min(k, 4-k), 0, 1)`` with ``k = (n + 6h) mod 6``."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    h6 = h * 6.0

    def chan(n):
        k = (n + h6) % 6.0
        w = torch.minimum(k, 4.0 - k).clamp(0.0, 1.0)
        return v - v * s * w

    return torch.stack([chan(5.0), chan(3.0), chan(1.0)], dim=-1)


@dataclasses.dataclass(frozen=True)
class ColorJitterConfig:
    brightness: float = 0.4
    contrast: float = 0.4
    saturation: float = 0.4
    hue: float = 0.1
    p: float = 0.8


def sample_jitter_params(gen, B: int, cfg: ColorJitterConfig, dtype):
    """Per-sample ColorJitter parameters ``(fb, fc, fs, fh, perm, apply)``:
    factors (B,1,1,1) (hue shift (B,1,1)) in ``dtype``, op order ``perm``
    (B, 4) with ids 0=brightness 1=contrast 2=saturation 3=hue, and
    ``apply`` (B,1,1,1) bool with probability ``cfg.p``."""
    fb = _uniform(gen, (B, 1, 1, 1), max(0.0, 1 - cfg.brightness), 1 + cfg.brightness).to(dtype)
    fc = _uniform(gen, (B, 1, 1, 1), max(0.0, 1 - cfg.contrast), 1 + cfg.contrast).to(dtype)
    fs = _uniform(gen, (B, 1, 1, 1), max(0.0, 1 - cfg.saturation), 1 + cfg.saturation).to(dtype)
    fh = _uniform(gen, (B, 1, 1), -cfg.hue, cfg.hue).to(dtype)
    perm = torch.rand((B, 4), generator=gen, device=gen.device).argsort(dim=1)
    apply = torch.rand((B, 1, 1, 1), generator=gen, device=gen.device) < cfg.p
    return fb, fc, fs, fh, perm, apply


def _apply_hue(x, fh):
    hsv = _rgb_to_hsv(x)
    h = (hsv[..., 0] + fh) % 1.0
    return _hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1))


def apply_color_jitter(img, fb, fc, fs, fh, perm, apply):
    """ColorJitter with given parameters, in the fused form of the JAX
    package: brightness, contrast and saturation compose to one affine map
    ``a*x + b*gray(x) + c`` on each side of the hue op, with the clip
    deferred to the end of each side."""
    B = img.shape[0]
    dt = img.dtype
    dev = img.device

    def compose_affine(active, a, b, c, mg):
        a2b, b2b = fb * a, fb * b
        c2b = fb * c
        a2s = fs * a
        b2s = fs * b + (1.0 - fs) * (a + b)
        c2s = c
        mean_cur = (a + b) * mg + c
        a2c, b2c = fc * a, fc * b
        c2c = fc * c + (1.0 - fc) * mean_cur

        def sel(op_id, vb, vs, vc, orig):
            out = orig  # hue or inactive: affine unchanged
            out = torch.where(active & (op_id == 0), vb, out)
            out = torch.where(active & (op_id == 1), vc, out)
            out = torch.where(active & (op_id == 2), vs, out)
            return out

        return sel, (a2b, a2s, a2c), (b2b, b2s, b2c), (c2b, c2s, c2c)

    def gray_mean(g):
        return g.float().mean(dim=(1, 2, 3), keepdim=True).to(dt)

    hue_pos = (perm == 3).int().argmax(dim=1)[:, None, None, None]

    def run_segment(before: bool, mg_seg):
        a = torch.ones((B, 1, 1, 1), dtype=dt, device=dev)
        b = torch.zeros((B, 1, 1, 1), dtype=dt, device=dev)
        c = torch.zeros((B, 1, 1, 1), dtype=dt, device=dev)
        for r in range(4):
            op_id = perm[:, r][:, None, None, None]
            active = (r < hue_pos) if before else (r > hue_pos)
            sel, aa, bb, cc = compose_affine(active, a, b, c, mg_seg)
            a = sel(op_id, aa[0], aa[1], aa[2], a)
            b = sel(op_id, bb[0], bb[1], bb[2], b)
            c = sel(op_id, cc[0], cc[1], cc[2], c)
        return a, b, c

    g = rgb_to_grayscale(img)
    a1, b1, c1 = run_segment(True, gray_mean(g))
    y = a1 * img + b1 * g + c1
    z = _apply_hue(y.clamp(0.0, 1.0), fh)
    g2 = rgb_to_grayscale(z)
    a2, b2, c2 = run_segment(False, gray_mean(g2))
    out = (a2 * z + b2 * g2 + c2).clamp(0.0, 1.0)
    return torch.where(apply, out, img)


def color_jitter(gen, img, cfg: ColorJitterConfig = ColorJitterConfig()):
    """Per-sample ColorJitter in random op order, applied with prob ``cfg.p``."""
    return apply_color_jitter(img, *sample_jitter_params(gen, img.shape[0], cfg, img.dtype))


def sample_to_gray(gen, B: int, p: float = 0.2):
    return torch.rand((B, 1, 1, 1), generator=gen, device=gen.device) < p


def apply_to_gray(img, apply):
    return torch.where(apply, rgb_to_grayscale(img).expand(img.shape), img)


def to_gray(gen, img, p: float = 0.2):
    """albu ToGray(p): replace with 3-channel grayscale per sample."""
    return apply_to_gray(img, sample_to_gray(gen, img.shape[0], p))


# --------------------------------------------------------------------------
# Blur / sharpen
# --------------------------------------------------------------------------

_BLUR_LIMIT = (19, 23)
_SIGMA_LIMIT = (0.1, 2.0)


def blur_kmax(dtype, blur_limit=_BLUR_LIMIT, sigma_limit=_SIGMA_LIMIT) -> int:
    """Static tap budget: half-precision images cannot show the outermost
    taps, so the window is cut where a tap at sigma_max falls below bf16
    resolution (~2e-3); for sigma <= 2 that is 17 taps."""
    kmax = blur_limit[1]
    if dtype in _HALF_DTYPES:
        t_needed = int(math.ceil(sigma_limit[1] * math.sqrt(2.0 * math.log(1.0 / 2e-3))))
        kmax = min(kmax, 2 * t_needed + 1)
    return kmax


def blur_taps_from_draws(ksize, sigma, kmax: int):
    """(B, kmax) float32 normalized Gaussian taps for odd ``ksize`` (B,) and
    ``sigma`` (B,); taps beyond ``ksize`` are zero."""
    half = kmax // 2
    taps = torch.arange(-half, half + 1, dtype=torch.float32, device=sigma.device)
    kern = torch.exp(-0.5 * (taps[None, :] / sigma[:, None]) ** 2)
    mask = taps[None, :].abs() <= (ksize[:, None] // 2)
    kern = torch.where(mask, kern, 0.0)
    return kern / kern.sum(dim=1, keepdim=True)


def sample_blur_taps(gen, B: int, blur_limit=_BLUR_LIMIT, sigma_limit=_SIGMA_LIMIT,
                     kmax: int | None = None):
    """albu GaussianBlur draws: odd ksize uniform in ``blur_limit``, sigma
    uniform in ``sigma_limit``."""
    n_sizes = (blur_limit[1] - blur_limit[0]) // 2 + 1
    ksize = blur_limit[0] + 2 * torch.randint(0, n_sizes, (B,), generator=gen, device=gen.device)
    sigma = _uniform(gen, (B,), *sigma_limit)
    return blur_taps_from_draws(ksize, sigma, kmax or blur_limit[1])


def sharpen_kern_from_draws(alpha, lightness):
    """albu Sharpen 3x3 kernels (B, 3, 3) float32:
    ``(1-a)*identity + a*effect(lightness)``."""
    a = alpha[:, None, None]
    ident = torch.zeros((3, 3), device=alpha.device)
    ident[1, 1] = 1.0
    effect = torch.full((alpha.shape[0], 3, 3), -1.0, device=alpha.device)
    effect[:, 1, 1] = 8.0 + lightness
    return (1.0 - a) * ident[None] + a * effect


def sample_sharpen_kern(gen, B: int, alpha=(0.2, 0.5), lightness=(0.5, 1.0)):
    a = _uniform(gen, (B,), *alpha)
    li = _uniform(gen, (B,), *lightness)
    return sharpen_kern_from_draws(a, li)


def apply_gaussian_blur(img, kern):
    """Separable per-sample blur with taps ``kern`` (B, kmax) as kmax
    shifted FMAs per axis in the image dtype, reflect-101 borders."""
    B, H, W, C = img.shape
    kern = kern.to(img.dtype)
    kmax = kern.shape[1]
    half = kmax // 2
    padded = reflect_pad_hw(img, half)
    rows = torch.zeros((B, H, W + 2 * half, C), dtype=img.dtype, device=img.device)
    for t in range(kmax):
        rows = rows + kern[:, t, None, None, None] * padded[:, t : t + H]
    out = torch.zeros((B, H, W, C), dtype=img.dtype, device=img.device)
    for t in range(kmax):
        out = out + kern[:, t, None, None, None] * rows[:, :, t : t + W]
    return out


def gaussian_blur(gen, img, blur_limit=_BLUR_LIMIT, sigma_limit=_SIGMA_LIMIT,
                  use_kernel: bool = False):
    """albu GaussianBlur: per sample a random odd kernel size in
    ``blur_limit`` and sigma in ``sigma_limit``, separable taps at the tap
    budget of the image's dtype. By default the shifted-FMA formulation
    (:func:`apply_gaussian_blur`); ``use_kernel=True`` is the standalone
    blur of ``ops/cuda/blur.py``, which takes only the 23-tap budget (so
    not bf16 / fp16 images), C = 3 and 8-aligned H, W, and raises
    ``ValueError`` otherwise."""
    kmax = blur_kmax(img.dtype, blur_limit, sigma_limit)
    taps = sample_blur_taps(gen, img.shape[0], blur_limit, sigma_limit, kmax=kmax)
    if use_kernel:
        if kmax != _blur.KMAX or not _blur.blur_supported(img.shape):
            raise ValueError("the standalone blur kernel requires a 23-tap budget and C=3, "
                             "8-aligned H/W")
        return _blur.separable_blur_nhwc(img.contiguous(), taps)
    return apply_gaussian_blur(img, taps)


def apply_sharpen(img, kern):
    """3x3 per-sample sharpen ``kern`` (B, 3, 3), reflect-101, clipped."""
    B, H, W, C = img.shape
    kern = kern.to(img.dtype)
    padded = reflect_pad_hw(img, 1)
    out = torch.zeros((B, H, W, C), dtype=img.dtype, device=img.device)
    for dy in range(3):
        for dx in range(3):
            out = out + kern[:, dy, dx, None, None, None] * padded[:, dy : dy + H, dx : dx + W]
    return out.clamp(0.0, 1.0)


def sample_blur_or_sharpen(gen, B: int, dtype, p: float = 0.5):
    """Draws of albu ``OneOf([GaussianBlur, Sharpen], p)``: whether to apply,
    blur-vs-sharpen, taps (at the tap budget of ``dtype``) and kernels."""
    return {
        "apply": torch.rand((B, 1, 1, 1), generator=gen, device=gen.device) < p,
        "pick_blur": torch.rand((B, 1, 1, 1), generator=gen, device=gen.device) < 0.5,
        "taps": sample_blur_taps(gen, B, kmax=blur_kmax(dtype)),
        "sharp": sample_sharpen_kern(gen, B),
    }


def _use_fused(img) -> bool:
    _, H, W, C = img.shape
    return (
        img.dtype in _HALF_DTYPES
        and C == 3
        and H % 8 == 0
        and W % 8 == 0
        and H > _FUSED_HALF
        and W > _FUSED_HALF
        and blur_kmax(img.dtype) == KMAX17
    )


def apply_blur_or_sharpen(img, params):
    """Apply drawn blur-or-sharpen parameters. Half-precision C=3 images with
    8-aligned H, W go through the fused kernel (only the drawn op is
    computed per sample); everything else computes both ops and selects."""
    apply, pick_blur = params["apply"], params["pick_blur"]
    if _use_fused(img):
        sel = torch.where(
            apply[:, 0, 0, 0], torch.where(pick_blur[:, 0, 0, 0], 1, 2), 0
        ).to(torch.int32)
        return blur_or_sharpen_fused(
            img.contiguous(),
            params["taps"].float().contiguous(),
            params["sharp"].float().contiguous(),
            sel.contiguous(),
        )
    blurred = apply_gaussian_blur(img, params["taps"])
    sharped = apply_sharpen(img, params["sharp"])
    return torch.where(apply, torch.where(pick_blur, blurred, sharped), img)


def blur_or_sharpen(gen, img, p: float = 0.5):
    """albu OneOf([GaussianBlur(p=.5), Sharpen(p=.5)], p=0.5)."""
    return apply_blur_or_sharpen(img, sample_blur_or_sharpen(gen, img.shape[0], img.dtype, p))


def normalize(img, mean: Sequence[float], std: Sequence[float]):
    """(x - mean) / std on [0,1] images == albu Normalize(max_pixel_value=255)."""
    mean = torch.tensor(mean, dtype=img.dtype, device=img.device)
    std = torch.tensor(std, dtype=img.dtype, device=img.device)
    return (img - mean) / std


# --------------------------------------------------------------------------
# Spatial ops
# --------------------------------------------------------------------------


def rrc_boxes_from_draws(area_frac, log_ratio, u_i, u_j, src_hw: tuple[int, int],
                         ratio: tuple[float, float] = (3 / 4, 4 / 3)):
    """torchvision RandomResizedCrop box choice from its uniform draws:
    ``area_frac``/``log_ratio`` (B, attempts) candidates, the first valid
    one wins, else the aspect-clamped centre crop; ``u_i``/``u_j`` (B,)
    place the box. Returns (top, left, height, width), each (B,) int32."""
    H, W = src_hw
    target_area = area_frac * (H * W)
    aspect = torch.exp(log_ratio)
    w = torch.round(torch.sqrt(target_area * aspect)).to(torch.int32)
    h = torch.round(torch.sqrt(target_area / aspect)).to(torch.int32)
    valid = (w > 0) & (w <= W) & (h > 0) & (h <= H)

    any_valid = valid.any(dim=1)
    first = valid.int().argmax(dim=1, keepdim=True)  # first True (0 if none)
    w_sel = w.gather(1, first)[:, 0]
    h_sel = h.gather(1, first)[:, 0]

    in_ratio = W / H
    if in_ratio < ratio[0]:
        fw, fh = W, int(round(W / ratio[0]))
    elif in_ratio > ratio[1]:
        fh, fw = H, int(round(H * ratio[1]))
    else:
        fw, fh = W, H
    w_sel = torch.where(any_valid, w_sel, fw)
    h_sel = torch.where(any_valid, h_sel, fh)

    top = torch.floor(u_i * (H - h_sel + 1).float()).to(torch.int32)
    left = torch.floor(u_j * (W - w_sel + 1).float()).to(torch.int32)
    top = torch.where(any_valid, top, (H - h_sel) // 2)
    left = torch.where(any_valid, left, (W - w_sel) // 2)
    return top, left, h_sel, w_sel


def sample_rrc_boxes(gen, batch: int, src_hw: tuple[int, int],
                     scale: tuple[float, float] = (0.5, 1.0),
                     ratio: tuple[float, float] = (3 / 4, 4 / 3), attempts: int = 10):
    """Vectorized RandomResizedCrop box sampling: all ``attempts``
    candidates drawn at once (see :func:`rrc_boxes_from_draws`)."""
    area_frac = _uniform(gen, (batch, attempts), *scale)
    log_ratio = _uniform(gen, (batch, attempts), math.log(ratio[0]), math.log(ratio[1]))
    u_i = torch.rand((batch,), generator=gen, device=gen.device)
    u_j = torch.rand((batch,), generator=gen, device=gen.device)
    return rrc_boxes_from_draws(area_frac, log_ratio, u_i, u_j, src_hw, ratio)


def _axis_resample_indices(start, size, src_len: int, out_len: int, flip=None):
    """2-tap bilinear sampling indices/weights along one axis (cv2
    half-pixel convention, clamped to the crop box). ``flip`` (B,) bool
    mirrors the grid about the crop centre: a horizontal flip for free."""
    startf = start.float()[:, None]
    sizef = size.float()[:, None]
    scalef = sizef / out_len
    coords = (torch.arange(out_len, dtype=torch.float32, device=start.device)[None, :] + 0.5) * scalef - 0.5 + startf
    if flip is not None:
        mirrored = 2.0 * startf + sizef - 1.0 - coords
        coords = torch.where(flip[:, None], mirrored, coords)
    coords = torch.minimum(torch.maximum(coords, startf), startf + sizef - 1.0)
    coords = coords.clamp(0.0, src_len - 1.0)
    lo = torch.floor(coords)
    frac = coords - lo
    lo_i = lo.long()
    hi_i = (lo_i + 1).clamp_max(src_len - 1)
    return lo_i, hi_i, frac


def _resize_matrix(start, size, src_len: int, out_len: int, dtype, flip=None):
    """Per-sample (out_len, src_len) 2-tap interpolation matrices."""
    lo, hi, frac = _axis_resample_indices(start, size, src_len, out_len, flip=flip)
    s = torch.arange(src_len, device=start.device)
    onehot_lo = (s[None, None, :] == lo[:, :, None]).to(dtype)
    onehot_hi = (s[None, None, :] == hi[:, :, None]).to(dtype)
    frac = frac[:, :, None].to(dtype)
    return onehot_lo * (1.0 - frac) + onehot_hi * frac  # (B, out, src)


def crop_and_resize_mxu(img, boxes, out_size: int, flip=None):
    """Per-sample crop (top, left, h, w) + bilinear resize to (out, out), as
    two batched interpolation matmuls (rows, then columns) in the image's
    dtype; ``flip`` (B,) folds a horizontal flip into the column matrix."""
    top, left, h, w = boxes
    _, H, W, _ = img.shape
    Rm = _resize_matrix(top, h, H, out_size, img.dtype)
    Cm = _resize_matrix(left, w, W, out_size, img.dtype, flip=flip)
    rows = torch.einsum("boh,bhwc->bowc", Rm, img)
    return torch.einsum("btw,bowc->botc", Cm, rows).contiguous()


def random_resized_crop(gen, img, out_size: int, scale=(0.5, 1.0), ratio=(3 / 4, 4 / 3),
                        flip=None):
    """albu RandomResizedCrop(out, out, scale=scale) via the matmul resampler."""
    B, H, W, _ = img.shape
    boxes = sample_rrc_boxes(gen, B, (H, W), scale, ratio)
    return crop_and_resize_mxu(img, boxes, out_size, flip=flip)
