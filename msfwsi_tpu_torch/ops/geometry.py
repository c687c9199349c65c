"""Jigsaw geometry of MSF-WSI as pure index math on tensors.

Port of the SSL subset of ``msfwsi_tpu/ops/geometry.py``; image layout is
NHWC, as there.
"""

from __future__ import annotations

import torch

__all__ = ["batched_blockshaped", "invert_permutation", "unshuffle_features", "reflect_pad_hw"]


def batched_blockshaped(arr, nrows: int, ncols: int):
    """(B, H, W, C) -> (B, n, nrows, ncols, C): a row-major grid of blocks
    per image, block i covering rows ``(i // (W//ncols)) * nrows`` onward."""
    b, h, w, c = arr.shape
    if h % nrows != 0:
        raise ValueError(f"{h} rows is not evenly divisible by {nrows}")
    if w % ncols != 0:
        raise ValueError(f"{w} cols is not evenly divisible by {ncols}")
    return (
        arr.reshape(b, h // nrows, nrows, w // ncols, ncols, c)
        .transpose(2, 3)
        .reshape(b, -1, nrows, ncols, c)
    )


def invert_permutation(perm):
    """Inverse of each (..., K) permutation along the last axis."""
    return perm.argsort(dim=-1)


def unshuffle_features(feats, jigsaw_reverse_idx):
    """Restore spatial tile order: ``feats`` (B, K, C) of jigsaw-shuffled
    tiles gathered per sample by the (B, K) inverse permutations."""
    idx = jigsaw_reverse_idx.long()[:, :, None].expand(-1, -1, feats.shape[-1])
    return feats.gather(1, idx)


def reflect_pad_hw(img, pad: int):
    """REFLECT_101 padding (cv2's default border, numpy's "reflect") of an
    NHWC tensor on H and W; needs H, W > ``pad``."""
    _, H, W, _ = img.shape

    def index(n):
        i = torch.arange(-pad, n + pad, device=img.device).abs()
        return torch.where(i > n - 1, 2 * (n - 1) - i, i)

    return img.index_select(1, index(H)).index_select(2, index(W))
