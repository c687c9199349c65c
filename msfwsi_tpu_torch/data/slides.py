"""Slides for the per-slide inference CLIs (port of ``tools/_slides.py``):
each iterator yields ``(slide name, tile stems, imgs (T, H, W, 3) uint8)``
from a prepared dataset's fold, a tree of tile folders, or synthetic data.
Tiles are decoded by the port's decoder (:mod:`..native`), all of a slide
in one threaded batch.
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np

from .. import native
from . import datasets as D
from .loader import NUM_THREADS, synthetic_tile_library

__all__ = ["decode_tiles", "iter_csv_slides", "iter_dir_slides", "iter_synthetic"]


def decode_tiles(paths) -> np.ndarray:
    """The images at ``paths``, all of the first one's shape, as one
    (T, H, W[, C]) uint8 array."""
    h, w, c = native.probe(paths[0])
    return native.decode_batch(list(paths), h, w, c, NUM_THREADS)


def iter_csv_slides(train_data: str, data_name: str, fold: int, logger, split: str = "val"):
    """Slides of a prepared dataset's fold: ``split="val"`` is the
    validation contract (``shift`` tiles left out), ``"train"`` the rest."""
    groups = D.seg_slide_groups(train_data, data_name, fold=fold, split=split)
    label = "validation" if split == "val" else split
    logger.info(f"=> {len(groups)} {label} slides (fold {fold})")
    for g in groups:
        imgs = decode_tiles([osp.join(train_data, s.img) for s in g.samples])
        stems = [osp.splitext(osp.basename(s.img))[0] for s in g.samples]
        yield g.filename, stems, imgs


def iter_dir_slides(tiles_dir: str, logger):
    """Tile folders: ``<dir>/images/*.png`` is one slide, else each
    subdirectory holding ``images/`` is one. Numeric stems sort
    numerically (the prep's tile ids), others lexically."""
    if osp.isdir(osp.join(tiles_dir, "images")):
        slides = [(osp.basename(osp.normpath(tiles_dir)), osp.join(tiles_dir, "images"))]
    else:
        slides = sorted((d, osp.join(tiles_dir, d, "images")) for d in os.listdir(tiles_dir)
                        if osp.isdir(osp.join(tiles_dir, d, "images")))
    if not slides:
        raise FileNotFoundError(f"--tiles-dir {tiles_dir}: no images/ directory found (expected "
                                "<dir>/images/*.png or <dir>/<slide>/images/*.png)")
    logger.info(f"=> {len(slides)} tile folder(s) under {tiles_dir}")
    for name, img_dir in slides:
        files = [f for f in os.listdir(img_dir) if f.lower().endswith(".png")]
        if not files:
            logger.warning(f"=> {img_dir}: no .png tiles; skipping {name}")
            continue
        stems = [osp.splitext(f)[0] for f in files]
        numeric = all(s.isdigit() for s in stems)
        order = sorted(range(len(stems)), key=lambda i: int(stems[i]) if numeric else stems[i])
        yield (name, [stems[i] for i in order],
               decode_tiles([osp.join(img_dir, files[i]) for i in order]))


def iter_synthetic(n: int, tile_size: int, num_classes: int):
    """Two in-memory synthetic slides of ``n`` tiles each."""
    imgs, _, slide_ids = synthetic_tile_library(n_slides=2, tiles_per_slide=n,
                                                tile_size=tile_size, num_classes=num_classes)
    for s in np.unique(slide_ids):
        ids = np.nonzero(slide_ids == s)[0]
        yield f"synthetic_{s}", [str(i) for i in range(len(ids))], imgs[ids]
