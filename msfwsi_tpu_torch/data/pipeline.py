"""View construction on the device: raw uint8 tiles -> the train batch.

Port of ``msfwsi_tpu/data/pipeline.py``.

  * SSL: two context views (RRC 224 + color aug) and two target view
    stacks (full-res color aug -> grid x grid blockshape -> per-tile RRC
    224 -> jigsaw shuffle), plus the inverse permutations.
  * Fine-tuning: a Resize(256) context view and a CenterCrop(256) target
    view of each 1024 px tile, both flipped together and color-jittered
    with the same draws, with their masks (nearest / cropped).
  * Evaluation: the same two views without flip or jitter, built on the
    device, or on the host as uint8 (:func:`make_seg_val_views_host`).

Each view's random parameters are drawn by ``sample_*`` and applied by
``apply_*``; ``make_*`` does both, or applies parameters it is given.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np
import torch

from ..ops import augment as A
from ..ops.geometry import batched_blockshaped

__all__ = [
    "AugConfig",
    "target_keys",
    "sample_context_view",
    "apply_context_view",
    "sample_target_view",
    "apply_target_view",
    "sample_ssl_views",
    "make_ssl_views",
    "sample_seg_train_views",
    "apply_seg_train_views",
    "make_seg_train_views",
    "make_seg_val_views",
    "make_seg_val_views_host",
]


@dataclasses.dataclass(frozen=True)
class AugConfig:
    mean: Sequence[float] = (0.485, 0.456, 0.406)
    std: Sequence[float] = (0.229, 0.224, 0.225)
    img_size: int = 224  # SSL view size (--img-sz)
    grid: int = 4  # sqrt(K): 4x4 target tiles
    tile_px: int = 256  # sub-tile size before the per-tile RRC
    seg_size: int = 256  # fine-tuning / evaluation view size
    rrc_scale: tuple[float, float] = (0.5, 1.0)
    # Augmentation compute dtype; bf16 under --amp (halves the traffic of
    # the full-resolution color ops and sends blur/sharpen to the kernel).
    compute_dtype: str = "float32"

    @property
    def dtype(self):
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32


def target_keys(views_shuffled: bool) -> tuple:
    """Batch keys of the two target view stacks: ``target{1,2}`` hold
    jigsaw-shuffled stacks, ``target{1,2}_spatial`` spatial-order ones, so a
    batch fed to a model of the other jigsaw mode raises a KeyError."""
    return ("target1", "target2") if views_shuffled else ("target1_spatial", "target2_spatial")


def _to_float(img, dtype=torch.float32):
    if img.dtype == torch.uint8:
        return img.to(dtype) / 255.0
    return img.to(dtype)


def sample_context_view(gen, B: int, src_hw: tuple[int, int], cfg: AugConfig):
    """Draws of the context pipeline: RRC box + folded HFlip, ColorJitter,
    ToGray, blur-or-sharpen."""
    return {
        "flip": torch.rand((B,), generator=gen, device=gen.device) < 0.5,
        "boxes": A.sample_rrc_boxes(gen, B, src_hw, scale=cfg.rrc_scale),
        "jitter": A.sample_jitter_params(gen, B, A.ColorJitterConfig(), cfg.dtype),
        "gray": A.sample_to_gray(gen, B),
        "blur_or_sharpen": A.sample_blur_or_sharpen(gen, B, cfg.dtype),
    }


def apply_context_view(x, p, cfg: AugConfig):
    """context_aug: RRC -> ColorJitter -> ToGray -> OneOf(blur/sharpen) ->
    HFlip -> Normalize, the flip folded into the RRC sampling grid (it
    commutes with the pixelwise ops and the symmetric kernels between)."""
    v = A.crop_and_resize_mxu(x, p["boxes"], cfg.img_size, flip=p["flip"])
    v = A.apply_color_jitter(v, *p["jitter"])
    v = A.apply_to_gray(v, p["gray"])
    v = A.apply_blur_or_sharpen(v, p["blur_or_sharpen"])
    return A.normalize(v, cfg.mean, cfg.std)


def sample_target_view(gen, B: int, cfg: AugConfig):
    """Draws of the target pipeline: full-res ColorJitter, ToGray,
    blur-or-sharpen, the (B, K) jigsaw permutation, and one RRC box + flip
    per tile."""
    K = cfg.grid**2
    return {
        "jitter": A.sample_jitter_params(gen, B, A.ColorJitterConfig(), cfg.dtype),
        "gray": A.sample_to_gray(gen, B),
        "blur_or_sharpen": A.sample_blur_or_sharpen(gen, B, cfg.dtype),
        "perm": torch.rand((B, K), generator=gen, device=gen.device).argsort(dim=1),
        "boxes": A.sample_rrc_boxes(gen, B * K, (cfg.tile_px, cfg.tile_px), scale=cfg.rrc_scale),
        "flip": torch.rand((B * K,), generator=gen, device=gen.device) < 0.5,
    }


def apply_target_view(x, p, cfg: AugConfig, shuffle: bool = True):
    """target_aug (color only, full res) + blockshape + per-tile RRC/HFlip +
    Normalize, then the jigsaw shuffle (iid per tile, so shuffling after the
    per-tile aug has the reference's distribution and moves 224 px views
    instead of 256 px tiles). Returns (views (B*K, s, s, 3), reverse (B, K));
    ``shuffle=False`` keeps spatial order and leaves the permutation to the
    model (``MSFWSI(views_shuffled=False)``)."""
    B = x.shape[0]
    K = cfg.grid**2
    t = A.apply_color_jitter(x, *p["jitter"])
    t = A.apply_to_gray(t, p["gray"])
    t = A.apply_blur_or_sharpen(t, p["blur_or_sharpen"])

    tiles = batched_blockshaped(t, cfg.tile_px, cfg.tile_px)  # (B, K, s, s, 3)
    flat = tiles.reshape(B * K, cfg.tile_px, cfg.tile_px, 3)
    v = A.crop_and_resize_mxu(flat, p["boxes"], cfg.img_size, flip=p["flip"])
    v = A.normalize(v, cfg.mean, cfg.std)

    perm = p["perm"]
    if shuffle:
        s = cfg.img_size
        v = v.reshape(B, K, s, s, 3)
        v = v[torch.arange(B, device=v.device)[:, None], perm]
        v = v.reshape(B * K, s, s, 3)
    return v, perm.argsort(dim=1)


def sample_ssl_views(gen, B: int, src_hw: tuple[int, int], cfg: AugConfig):
    """Parameters of all four views of :func:`make_ssl_views`."""
    return {
        "context1": sample_context_view(gen, B, src_hw, cfg),
        "context2": sample_context_view(gen, B, src_hw, cfg),
        "target1": sample_target_view(gen, B, cfg),
        "target2": sample_target_view(gen, B, cfg),
    }


def make_ssl_views(tiles_u8, cfg: AugConfig = AugConfig(), generator=None,
                   shuffle_views: bool = True, params=None):
    """Full SSL batch from raw uint8 tiles (B, grid*tile_px, grid*tile_px, 3).

    Draws the view parameters from ``generator`` (on the tiles' device), or
    applies ``params`` as :func:`sample_ssl_views` returns them. Returns the
    train-step batch dict: two context views (B, s, s, 3), two flattened
    target view stacks (B*K, s, s, 3) under :func:`target_keys`, and two
    (B, K) inverse jigsaw permutations.
    """
    B, H, W, _ = tiles_u8.shape
    if params is None:
        if generator is None:
            raise ValueError("make_ssl_views needs a generator or drawn params")
        params = sample_ssl_views(generator, B, (H, W), cfg)
    x = _to_float(tiles_u8, cfg.dtype)
    ctx1 = apply_context_view(x, params["context1"], cfg)
    ctx2 = apply_context_view(x, params["context2"], cfg)
    tgt1, rev1 = apply_target_view(x, params["target1"], cfg, shuffle=shuffle_views)
    tgt2, rev2 = apply_target_view(x, params["target2"], cfg, shuffle=shuffle_views)
    t1, t2 = target_keys(shuffle_views)
    return {
        "context1": ctx1,
        "context2": ctx2,
        t1: tgt1,
        t2: tgt2,
        "rev1": rev1,
        "rev2": rev2,
    }


def sample_seg_train_views(gen, B: int, cfg: AugConfig):
    """Draws of the fine-tuning views: a per-sample horizontal flip and one
    ColorJitter draw per sample, shared by its context and target views."""
    return {
        "flip": torch.rand((B,), generator=gen, device=gen.device) < 0.5,
        "jitter": A.sample_jitter_params(gen, B, A.ColorJitterConfig(), cfg.dtype),
    }


def apply_seg_train_views(imgs_u8, masks, p, cfg: AugConfig):
    """Fine-tuning batch from (B, H, W, 3) uint8 tiles and (B, H, W) masks
    with drawn parameters ``p``, as the JAX package builds it: views first,
    then ColorJitter at ``seg_size``.

      * context: Resize(seg_size), the flip folded into the column matrix;
        its mask nearest-resized with the flip folded into the indices;
      * target: CenterCrop(seg_size) with the flip as the mirrored column
        matrix of an identity-scale resample of the crop (one-hot rows, so
        exact); its mask cropped and mirrored by a column gather;
      * ColorJitter on both with the same draws, the target taking the
        context's gray means (the reference jitters the full source, whose
        statistics the resized view carries), then Normalize.

    Returns ((context, target) images, (context, target) int32 masks), all
    (B, seg_size, seg_size[, 3])."""
    S = cfg.seg_size
    flip = p["flip"]
    x = _to_float(imgs_u8, cfg.dtype)
    B = x.shape[0]
    zeros = torch.zeros((B,), dtype=torch.int32, device=x.device)
    full = torch.full_like(zeros, S)
    # Rows and columns outside the centre crop meet only zero weights in the
    # JAX package's full-tile resample matrices: cropping first is exact.
    tgt = A.crop_and_resize_mxu(A.center_crop(x, S), (zeros, zeros, full, full), S, flip=flip)
    ctx = A.resize_bilinear(x, S, flip=flip)
    ctx_mask = A.resize_nearest(masks, S, flip=flip)

    ctx, means = A.apply_color_jitter(ctx, *p["jitter"], return_means=True)
    tgt = A.apply_color_jitter(tgt, *p["jitter"], means=means)

    ar = torch.arange(S, device=masks.device)
    cols = torch.where(flip[:, None], S - 1 - ar, ar)  # (B, S)
    tgt_mask = A.center_crop(masks, S).gather(2, cols[:, None, :].expand(B, S, S))

    ctx = A.normalize(ctx, cfg.mean, cfg.std)
    tgt = A.normalize(tgt, cfg.mean, cfg.std)
    return (ctx, tgt), (ctx_mask.to(torch.int32), tgt_mask.to(torch.int32))


def make_seg_train_views(imgs_u8, masks, cfg: AugConfig = AugConfig(), generator=None,
                         params=None):
    """:func:`apply_seg_train_views` with parameters drawn from
    ``generator`` (on the tiles' device) or given as ``params``."""
    if params is None:
        if generator is None:
            raise ValueError("make_seg_train_views needs a generator or drawn params")
        params = sample_seg_train_views(generator, imgs_u8.shape[0], cfg)
    return apply_seg_train_views(imgs_u8, masks, params, cfg)


def make_seg_val_views(imgs_u8, masks, cfg: AugConfig = AugConfig()):
    """Evaluation batch on the device: Resize(seg_size) + Normalize context
    and CenterCrop(seg_size) + Normalize target (``evaluate.py:151-178``),
    with their int32 masks."""
    x = _to_float(imgs_u8, cfg.dtype)
    ctx = A.normalize(A.resize_bilinear(x, cfg.seg_size), cfg.mean, cfg.std)
    ctx_mask = A.resize_nearest(masks, cfg.seg_size)
    tgt = A.normalize(A.center_crop(x, cfg.seg_size), cfg.mean, cfg.std)
    tgt_mask = A.center_crop(masks, cfg.seg_size)
    return (ctx, tgt), (ctx_mask.to(torch.int32), tgt_mask.to(torch.int32))


def _resize_u8_host_np(img: np.ndarray, out: int) -> np.ndarray:
    """Bilinear resize of one (H, W, C) uint8 image to (out, out): the
    2-tap half-pixel sampling of :func:`~..ops.augment.resize_bilinear` in
    fp32, rounded half up as cv2's fixed-point uint8 path rounds (the JAX
    package's numpy path, ``pipeline.py:221``)."""

    def taps(src, dst):
        x = (np.arange(dst) + 0.5) * src / dst - 0.5
        lo = np.clip(np.floor(x).astype(np.int64), 0, src - 1)
        hi = np.clip(lo + 1, 0, src - 1)
        return lo, hi, (x - np.floor(x)).astype(np.float32)

    H, W = img.shape[0], img.shape[1]
    ylo, yhi, yf = taps(H, out)
    xlo, xhi, xf = taps(W, out)
    x = img.astype(np.float32)
    rows = x[ylo] * (1.0 - yf)[:, None, None] + x[yhi] * yf[:, None, None]
    cols = rows[:, xlo] * (1.0 - xf)[None, :, None] + rows[:, xhi] * xf[None, :, None]
    return np.clip(np.floor(cols + 0.5), 0, 255).astype(np.uint8)


def make_seg_val_views_host(imgs_u8, masks, cfg: AugConfig = AugConfig(), num_threads: int = 8):
    """Evaluation views built on the host as uint8, the reference's split of
    work (albu Resize / CenterCrop on uint8, then Normalize on the device):
    ``(ctx_u8 (T,s,s,3), tgt_u8 (T,s,s,3), tgt_mask (T,s,s) int32)`` numpy
    arrays, the resizes on a thread pool (numpy releases the GIL)."""
    imgs_u8 = np.ascontiguousarray(imgs_u8)
    masks = np.ascontiguousarray(masks)
    S = cfg.seg_size
    with ThreadPoolExecutor(num_threads) as pool:
        ctx = np.stack(list(pool.map(lambda im: _resize_u8_host_np(im, S), imgs_u8)))
    H, W = imgs_u8.shape[1], imgs_u8.shape[2]
    y0, x0 = (H - S) // 2, (W - S) // 2
    tgt = imgs_u8[:, y0 : y0 + S, x0 : x0 + S]
    tmask = masks[:, y0 : y0 + S, x0 : x0 + S].astype(np.int32)
    return ctx, tgt, tmask
