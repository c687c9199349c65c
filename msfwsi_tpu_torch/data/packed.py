"""Packed tile cache: decode once, stream raw bytes in every epoch.

Port of ``msfwsi_tpu/data/packed.py``, in the same format under the same
key (``pack_<key>.npy``, an uncompressed (N, H, W, C) uint8 array, and
``pack_<key>.json`` with the file list, shape and key), so one pack serves
both packages. Tiles are decoded by the port's decoder (:mod:`..native`),
which raises on a file it cannot decode.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Sequence

import numpy as np

from .. import native

__all__ = ["pack_key", "build_pack", "PackedTiles", "get_or_build_pack"]


def pack_key(files: Sequence[str], root: str = "") -> str:
    """Stable key for (dataset root, ordered file list). The root is part
    of it, so two dataset roots whose relative tile names coincide never
    share a pack; so is the order."""
    h = hashlib.sha256()
    h.update(os.path.realpath(root).encode() if root else b"")
    h.update(b"\0")
    for f in files:
        h.update(f.encode())
        h.update(b"\0")
    return h.hexdigest()[:16]


def build_pack(root: str, files: Sequence[str], out_prefix: str, batch: int = 64,
               num_threads: int = 0) -> str:
    """Decode ``files`` (relative to ``root``) into ``<out_prefix>.npy`` +
    ``<out_prefix>.json``. Returns the prefix."""
    if not files:
        raise ValueError("cannot pack an empty file list")
    h, w, c = native.probe(os.path.join(root, files[0]))
    shape = (h, w) if c == 1 else (h, w, c)
    n = len(files)
    arr = np.lib.format.open_memmap(out_prefix + ".npy", mode="w+", dtype=np.uint8,
                                    shape=(n, *shape))
    for i0 in range(0, n, batch):
        chunk = files[i0 : i0 + batch]
        native.decode_batch([os.path.join(root, f) for f in chunk], h, w, c, num_threads,
                            out=arr[i0 : i0 + len(chunk)])
    arr.flush()
    del arr
    with open(out_prefix + ".json", "w") as fh:
        json.dump({"files": list(files), "shape": list(shape), "key": pack_key(files, root)}, fh)
    return out_prefix


class PackedTiles:
    """Reader over a built pack; index by original file path or position."""

    def __init__(self, prefix: str):
        self.arr = np.load(prefix + ".npy", mmap_mode="r")
        with open(prefix + ".json") as fh:
            meta = json.load(fh)
        self.files = meta["files"]
        self.key = meta["key"]
        self._pos = {f: i for i, f in enumerate(self.files)}

    def __len__(self):
        return len(self.files)

    def load(self, rec) -> np.ndarray:
        idx = rec if isinstance(rec, (int, np.integer)) else self._pos[rec]
        return self.arr[idx]  # a view of the memmap; the caller copies it


def get_or_build_pack(root: str, files: Sequence[str], cache_dir: str) -> PackedTiles:
    """A pack for ``files``, built under ``cache_dir`` on first use."""
    os.makedirs(cache_dir, exist_ok=True)
    prefix = os.path.join(cache_dir, f"pack_{pack_key(files, root)}")
    if not (os.path.exists(prefix + ".npy") and os.path.exists(prefix + ".json")):
        build_pack(root, files, prefix)
    pack = PackedTiles(prefix)
    if pack.files != list(files):
        # a key collision (the key covers root and order, so this is rare)
        build_pack(root, files, prefix)
        pack = PackedTiles(prefix)
    return pack
