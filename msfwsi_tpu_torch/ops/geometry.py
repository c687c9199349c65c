"""Jigsaw geometry of MSF-WSI as pure index math on tensors, the prep
grid's tile geometry and the BCSS label remap.

Port of ``msfwsi_tpu/ops/geometry.py`` (the jigsaw, :class:`TileGrid` and
:func:`remap_bcss_labels`); image layout is NHWC, as there.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "BCSS_CLASS_REMAP",
    "TileGrid",
    "batched_blockshaped",
    "invert_permutation",
    "unshuffle_features",
    "reflect_index",
    "reflect_pad_hw",
    "remap_bcss_labels",
]


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


def reflect_index(n: int, pad: int, device=None):
    """Source index of each of the ``n + 2 * pad`` positions of an axis of
    length ``n`` padded by REFLECT_101 (cv2's default border, numpy's
    "reflect"); needs ``n > pad``."""
    i = torch.arange(-pad, n + pad, device=device).abs()
    return torch.where(i > n - 1, 2 * (n - 1) - i, i)


def reflect_pad_hw(img, pad: int):
    """REFLECT_101 padding of an NHWC tensor on H and W; needs H, W > ``pad``."""
    _, H, W, _ = img.shape
    return img.index_select(1, reflect_index(H, pad, img.device)).index_select(
        2, reflect_index(W, pad, img.device)
    )


@dataclasses.dataclass(frozen=True)
class TileGrid:
    """Grid geometry for cutting a (height, width) slide into fixed tiles
    (``tools/bcss_prepare.py:36-69``): tiles of ``tile_size`` start at
    ``(i_h * tile_size + shift_h, i_w * tile_size + shift_w)``; the slide
    is taken as zero-padded on the bottom and right so that every tile is
    whole; a shift drops the last row or column when the remainder cannot
    hold it."""

    height: int
    width: int
    tile_size: int
    shift_h: int = 0
    shift_w: int = 0

    @property
    def num_h(self) -> int:
        # pad_h is always in [1, tile_size]; num_h = (h + pad_h) // tile_size
        n = (self.height + self.pad_h) // self.tile_size
        if self.height % self.tile_size < self.shift_h:
            n -= 1
        return n

    @property
    def num_w(self) -> int:
        n = (self.width + self.pad_w) // self.tile_size
        if self.width % self.tile_size < self.shift_w:
            n -= 1
        return n

    @property
    def pad_h(self) -> int:
        return self.tile_size - self.height % self.tile_size

    @property
    def pad_w(self) -> int:
        return self.tile_size - self.width % self.tile_size

    def __len__(self) -> int:
        return self.num_h * self.num_w

    def origin(self, idx: int) -> tuple[int, int]:
        """Top-left (y, x) of tile ``idx`` (row-major; it may lie past the
        slide, in the zero padding)."""
        i_h, i_w = divmod(idx, self.num_w)
        return i_h * self.tile_size + self.shift_h, i_w * self.tile_size + self.shift_w

    def extract(self, img: np.ndarray, idx: int) -> np.ndarray:
        """Tile ``idx`` of ``img`` ((H, W) or (H, W, C)), zero-padded past
        the slide's edge."""
        y, x = self.origin(idx)
        sz = self.tile_size
        py0, py1 = max(0, y), min(y + sz, self.height)
        px0, px1 = max(0, x), min(x + sz, self.width)
        patch = np.zeros((sz, sz) + img.shape[2:], img.dtype)
        patch[0 : py1 - py0, 0 : px1 - px0] = img[py0:py1, px0:px1]
        return patch


# BCSS ships 21 raw annotation codes; MSF-WSI collapses them to 5 classes
# (+0 background/outside) at prep time (the reference's
# ``tools/bcss_prepare.py:25-34``).
BCSS_CLASS_REMAP = {
    1: (1, 19, 20),
    2: (2,),
    3: (3, 10, 11, 14),
    4: (4,),
    5: (5, 6, 7, 8, 9, 12, 13, 15, 16, 17, 18, 21),
}


def remap_bcss_labels(mask: np.ndarray) -> np.ndarray:
    """Raw BCSS label codes -> the 5-class scheme, by one lookup table (the
    reference's sequential ``np.isin`` sweeps never rewrite each other's
    outputs, so a table reproduces them). The table is sized to the mask's
    maximum, so a code of a 16-bit mask >= 256 stays as it is, as under
    the sweeps; the dtype is the mask's."""
    n = max(256, int(mask.max()) + 1 if mask.size else 256)
    lut = np.arange(n, dtype=mask.dtype)
    for new, raws in BCSS_CLASS_REMAP.items():
        lut[list(raws)] = new
    return lut[mask]
