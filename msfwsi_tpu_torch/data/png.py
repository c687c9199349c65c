"""A PNG writer on zlib and numpy (the port has no PIL), and a reader of a
PNG's size from its header.

:func:`write_png` writes non-interlaced 8-bit grey, grey + alpha, RGB, RGBA
or palette images and 16-bit grey images, with one IDAT; the rows may cycle
through the five filter types, so one image can exercise every path of a
decoder. A palette image (colour type 3) stores class indices that PIL and
the port's decoder read back as the indices themselves, with colours for a
viewer. A 16-bit grey image is what PIL writes for a ``uint16`` mask.
"""

from __future__ import annotations

import struct
import zlib
from typing import Sequence

import numpy as np

__all__ = ["write_png", "png_size"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}
_PALETTE_TYPE = 3


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(
        ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def _filtered(raw: np.ndarray, bpp: int, filters: Sequence[int]) -> np.ndarray:
    """(H, 1 + row bytes): the (H, row bytes) uint8 ``raw`` filtered with
    ``bpp`` bytes a pixel, each row prefixed by its filter type."""
    H = raw.shape[0]
    raw = raw.astype(np.int16)
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
    """Write a uint8 (H, W) or (H, W, C) array, C in 1-4, to ``path`` as an
    8-bit non-interlaced PNG, or a uint16 (H, W) array as a 16-bit grey one
    (big-endian samples, filtered on bytes at 2 bytes a pixel), with one
    IDAT, row i filtered with ``filters[i % len(filters)]`` (0 none, 1 sub,
    2 up, 3 average, 4 Paeth). With ``palette`` (RGB triples, at most 256)
    a uint8 (H, W) array is written as palette indices (colour type 3), the
    palette padded with black to 256 entries so that every index has a
    colour."""
    img = np.ascontiguousarray(img)
    wide = img.dtype == np.uint16 and img.ndim == 2
    if not (wide or (img.dtype == np.uint8 and img.ndim in (2, 3))):
        raise ValueError(f"want a uint8 (H, W[, C]) or uint16 (H, W) array, got {img.dtype} "
                         f"{img.shape}")
    C = 1 if img.ndim == 2 else img.shape[2]
    if C not in _COLOR_TYPE or any(f not in range(5) for f in filters) or not filters:
        raise ValueError(f"channels {C} or filters {tuple(filters)} not supported")
    plte = b""
    color_type = _COLOR_TYPE[C]
    if palette is not None:
        if wide or img.ndim != 2 or not 0 < len(palette) <= 256:
            raise ValueError(f"a palette image is uint8 (H, W) with 1-256 colours, got "
                             f"{img.dtype} {img.shape} and {len(palette)} colours")
        flat = [int(v) for rgb in palette for v in rgb]
        plte = _chunk(b"PLTE", bytes(flat + [0] * (768 - len(flat))))
        color_type = _PALETTE_TYPE
    H, W = img.shape[:2]
    depth = 16 if wide else 8
    raw = (img.astype(">u2") if wide else img).view(np.uint8).reshape(H, -1)
    ihdr = struct.pack(">IIBBBBB", W, H, depth, color_type, 0, 0, 0)
    idat = zlib.compress(_filtered(raw, C * depth // 8, filters).tobytes())
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", ihdr) + plte + _chunk(b"IDAT", idat)
                + _chunk(b"IEND", b""))


def png_size(path: str) -> tuple[int, int]:
    """(width, height) of a PNG file from its IHDR chunk, as PIL's
    ``Image.size``; nothing past the header is read. Unlike the decoder's
    ``native.probe`` it takes any PNG (16-bit colour, interlaced), since a raw
    slide need not be one the port decodes."""
    with open(path, "rb") as f:
        head = f.read(24)
    if len(head) < 24 or head[:8] != _SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path} is not a PNG file")
    return struct.unpack(">II", head[16:24])
