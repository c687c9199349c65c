"""Tile embeddings from a pretrained MSFWSI SSL model (port of
``msfwsi_tpu/train/features.py``).

Per source tile, through the SSL model's own two branches:

* ``"context"``: the whole tile resized to the SSL input size through the
  context encoder: its 4 pooled stage features (B, C_i);
* ``"target"``: the tile cut into K = scale^2 sub-tiles (``blockshaped``'s
  grid, spatial row-major order, no jigsaw), each resized through the
  target encoder: (B, K, C_i) per stage.

The views are deterministic (bilinear resize and Normalize, in
``cfg.dtype``), built on the device before the eval-mode forward, which
runs under bf16 autocast when ``amp`` is set. Features leave the device in
``out_dtype`` (float16 by default) through
:func:`.predict.predict_slide`.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..data.pipeline import AugConfig, _to_float
from ..models.backbone import MSFWSI
from ..models.resnet import feature_dims
from ..ops import augment as A
from ..ops.geometry import batched_blockshaped
from .evaluate import _eval_forward

__all__ = ["BRANCHES", "feature_spec", "make_chunk_features"]

BRANCHES = ("context", "target")


def _check(branches, scales) -> tuple[tuple, tuple]:
    branches = tuple(branches)
    scales = tuple(int(s) for s in scales)
    if not branches or any(b not in BRANCHES for b in branches):
        raise ValueError(f"branches must be a non-empty subset of {BRANCHES}, got {branches!r}")
    if not scales or any(s not in (1, 2, 3, 4) for s in scales):
        raise ValueError(f"scales are 1-indexed encoder stages in 1..4, got {scales!r}")
    return branches, scales


def feature_spec(model: MSFWSI, branches=BRANCHES, scales=(1, 2, 3, 4)) -> list[tuple]:
    """The output layout of :func:`make_chunk_features`: ``(branch, stage,
    channels)`` in output order (branch-major, stages ascending)."""
    branches, scales = _check(branches, scales)
    dims = feature_dims(model.arch)
    return [(b, s, dims[s - 1]) for b in branches for s in scales]


def make_chunk_features(model: MSFWSI, cfg: AugConfig = AugConfig(),
                        branches: Sequence[str] = BRANCHES, scales: Sequence[int] = (1, 2, 3, 4),
                        out_dtype=torch.float16, amp: bool = False) -> Callable:
    """``features(tiles_u8 (B, T, T, 3)) -> tuple`` of feature tensors in
    :func:`feature_spec` order: (B, C_i) for context entries, (B, K, C_i)
    for target entries. Only the requested branches' encoders run; the SSL
    heads are never touched."""
    branches, scales = _check(branches, scales)
    K = model.scale**2

    def features(tiles_u8):
        B, H, W = tiles_u8.shape[:3]
        if "target" in branches and (H % model.scale or W % model.scale):
            raise ValueError(f"tile size {H}x{W} is not divisible by --scale {model.scale} "
                             "(sub-tile grid)")
        with torch.no_grad():
            x = _to_float(tiles_u8, cfg.dtype)
            ctx = tgt = None
            if "context" in branches:
                ctx = A.normalize(A.resize_bilinear(x, cfg.img_size), cfg.mean, cfg.std)
            if "target" in branches:
                sub = batched_blockshaped(x, H // model.scale, W // model.scale)
                sub = sub.reshape(B * K, *sub.shape[2:])
                tgt = A.normalize(A.resize_bilinear(sub, cfg.img_size), cfg.mean, cfg.std)
        out = []
        with _eval_forward(model, tiles_u8.device.type, amp):
            if ctx is not None:
                feats = model.encode_context(ctx)
                out += [feats[s - 1].to(out_dtype) for s in scales]
            if tgt is not None:
                feats = model.encode_target(tgt)
                out += [feats[s - 1].reshape(B, K, -1).to(out_dtype) for s in scales]
        return tuple(out)

    return features
