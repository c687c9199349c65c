"""A PNG writer on zlib and numpy (the port has no PIL), and a reader of a
PNG's size from its header.

:func:`write_png` writes 8-bit non-interlaced grey, RGB, RGBA or palette
images with one IDAT; the rows may cycle through the five filter types, so
one image can exercise every path of a decoder. A palette image (colour
type 3) stores class indices that PIL and the port's decoder read back as
the indices themselves, with colours for a viewer.
"""

from __future__ import annotations

import struct
import zlib
from typing import Sequence

import numpy as np

__all__ = ["write_png", "png_size"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}
_PALETTE_TYPE = 3


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(
        ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def _filtered(img: np.ndarray, bpp: int, filters: Sequence[int]) -> np.ndarray:
    """(H, 1 + W*C) rows, each prefixed by its filter type."""
    H = img.shape[0]
    raw = img.reshape(H, -1).astype(np.int16)
    left = np.zeros_like(raw)
    left[:, bpp:] = raw[:, :-bpp]
    up = np.zeros_like(raw)
    up[1:] = raw[:-1]
    up_left = np.zeros_like(raw)
    up_left[1:, bpp:] = raw[:-1, :-bpp]
    p = left + up - up_left
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, up_left))
    predictors = (0, left, up, (left + up) >> 1, paeth)
    types = np.resize(np.asarray(filters, np.uint8), H)
    out = np.empty((H, 1 + raw.shape[1]), np.uint8)
    out[:, 0] = types
    for t in set(types.tolist()):
        rows = types == t
        out[rows, 1:] = ((raw[rows] - (predictors[t][rows] if t else 0)) & 0xFF).astype(np.uint8)
    return out


def write_png(path: str, img: np.ndarray, filters: Sequence[int] = (0, 1, 2, 3, 4),
              palette: Sequence[tuple[int, int, int]] | None = None) -> None:
    """Write a uint8 (H, W) or (H, W, C) array, C in 1, 3, 4, to ``path``
    as an 8-bit non-interlaced PNG with one IDAT, row i filtered with
    ``filters[i % len(filters)]`` (0 none, 1 sub, 2 up, 3 average, 4
    Paeth). With ``palette`` (RGB triples, at most 256) an (H, W) array is
    written as palette indices (colour type 3), the palette padded with
    black to 256 entries so that every index has a colour."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"want a uint8 (H, W[, C]) array, got {img.dtype} {img.shape}")
    C = 1 if img.ndim == 2 else img.shape[2]
    if C not in _COLOR_TYPE or any(f not in range(5) for f in filters) or not filters:
        raise ValueError(f"channels {C} or filters {tuple(filters)} not supported")
    plte = b""
    color_type = _COLOR_TYPE[C]
    if palette is not None:
        if img.ndim != 2 or not 0 < len(palette) <= 256:
            raise ValueError(f"a palette image is (H, W) with 1-256 colours, got {img.shape} "
                             f"and {len(palette)} colours")
        flat = [int(v) for rgb in palette for v in rgb]
        plte = _chunk(b"PLTE", bytes(flat + [0] * (768 - len(flat))))
        color_type = _PALETTE_TYPE
    H, W = img.shape[:2]
    ihdr = struct.pack(">IIBBBBB", W, H, 8, color_type, 0, 0, 0)
    idat = zlib.compress(_filtered(img, C, filters).tobytes())
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", ihdr) + plte + _chunk(b"IDAT", idat)
                + _chunk(b"IEND", b""))


def png_size(path: str) -> tuple[int, int]:
    """(width, height) of a PNG file from its IHDR chunk, as PIL's
    ``Image.size``; nothing past the header is read. Unlike the decoder's
    ``native.probe`` it takes any PNG (16-bit, interlaced), since a raw
    slide need not be one the port decodes."""
    with open(path, "rb") as f:
        head = f.read(24)
    if len(head) < 24 or head[:8] != _SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path} is not a PNG file")
    return struct.unpack(">II", head[16:24])
