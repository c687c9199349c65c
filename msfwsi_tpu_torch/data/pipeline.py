"""SSL view construction on the device: raw uint8 tiles -> the train batch.

Port of the SSL part of ``msfwsi_tpu/data/pipeline.py``: two context views
(RRC 224 + color aug) and two target view stacks (full-res color aug ->
grid x grid blockshape -> per-tile RRC 224 -> jigsaw shuffle), plus the
inverse permutations. Each view's random parameters are drawn by
``sample_*`` and applied by ``apply_*``; :func:`make_ssl_views` does both,
or applies parameters it is given.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

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
]


@dataclasses.dataclass(frozen=True)
class AugConfig:
    mean: Sequence[float] = (0.485, 0.456, 0.406)
    std: Sequence[float] = (0.229, 0.224, 0.225)
    img_size: int = 224  # SSL view size (--img-sz)
    grid: int = 4  # sqrt(K): 4x4 target tiles
    tile_px: int = 256  # sub-tile size before the per-tile RRC
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
