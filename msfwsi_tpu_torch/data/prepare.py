"""WSI tile preparation: region PNGs -> a fixed-size tile library + CSV.

Port of ``msfwsi_tpu/data/prepare.py`` (the reference's
``tools/bcss_prepare.py``) without PIL or pandas: cut each slide's image
and mask into a ``tile_size`` grid (zero-padded at the edges), remap raw
BCSS labels to the 5-class scheme, drop all-background tiles, zero the
unmasked pixels, write image and mask PNGs, and write ``data.csv`` with the
column contract the manifests read (``bcss_prepare.py:236-252``):

  filename_img, filename_mask, filename, num_masked_pixels,
  ratio_masked_area, ratio_masked_{1..5}_area

``shift != 0`` adds the ``_shiftW/_shiftH/_shiftHW`` origin-shifted
variants of every slide, as the JAX package does (the reference's shift
branches name an undefined ``train_list``; the variants run over the same
slide list, which the validation loader's exclusion of "shift" rows
assumes).

Region PNGs are read by the port's decoder (:func:`..native.load_image`:
8-bit grey, RGB, palette, grey + alpha, RGBA and 16-bit grey; a side above
2^20 pixels or more than 4 GiB of raw bytes fails, naming the limit and
the file). Tiles are written by :func:`.png.write_png`, a mask in its own
dtype (a 16-bit input mask gives 16-bit mask PNGs, as PIL writes them), and
``data.csv`` by the ``csv`` module, row for row and byte for byte as
pandas' ``to_csv(index=False)`` writes it. ``workers`` writes tiles on a
thread pool: zlib's compression releases the interpreter lock, and threads,
unlike forked processes, are safe beside a CUDA context.
"""

from __future__ import annotations

import csv
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np

from .. import native
from ..ops.geometry import TileGrid, remap_bcss_labels
from .png import write_png

__all__ = ["CSV_COLUMNS", "tile_stats", "tile_slide", "tile_slide_arrays", "prepare_bcss"]

CSV_COLUMNS = [
    "filename_img",
    "filename_mask",
    "filename",
    "num_masked_pixels",
    "ratio_masked_area",
    "ratio_masked_1_area",
    "ratio_masked_2_area",
    "ratio_masked_3_area",
    "ratio_masked_4_area",
    "ratio_masked_5_area",
]



def tile_stats(mask_patch: np.ndarray, num_fg: int = 5):
    """(num_masked_pixels, ratio_masked_area, per-class ratios): the CSV
    statistics of ``bcss_prepare.py:72-95``."""
    area = mask_patch.shape[0] * mask_patch.shape[1]
    clip = np.clip(mask_patch, 0, 1)
    num_masked = int(clip.sum())
    ratios = [float((mask_patch == c).sum() / area) for c in range(1, num_fg + 1)]
    return num_masked, float(num_masked / area), ratios


def _process_tile(args):
    out_dir, slide_name, idx, img_patch, mask_patch = args
    num_masked, ratio, class_ratios = tile_stats(mask_patch)
    if num_masked == 0:
        return None  # drop all-background tiles (bcss_prepare.py:77)

    img_patch = img_patch.copy()
    img_patch[~np.clip(mask_patch, 0, 1).astype(bool)] = 0  # zero the unmasked pixels

    img_rel = f"{slide_name}/images/{idx}.png"
    mask_rel = f"{slide_name}/masks/{idx}.png"
    write_png(os.path.join(out_dir, img_rel), img_patch)
    write_png(os.path.join(out_dir, mask_rel), mask_patch)
    return [img_rel, mask_rel, slide_name, num_masked, ratio, *class_ratios]


def _read_pair(img_path: str, mask_path: str) -> tuple[np.ndarray, np.ndarray]:
    return native.load_image(img_path), native.load_image(mask_path)


def tile_slide(
    img_path: str,
    mask_path: str,
    out_dir: str,
    slide_name: str,
    tile_size: int,
    shift_h: int = 0,
    shift_w: int = 0,
    remap_labels: bool = True,
    workers: int | None = None,
) -> list[list]:
    """Tile one slide; returns its CSV rows. ``slide_name`` may carry a
    shift suffix (e.g. ``TCGA-XX_shiftW_512``)."""
    img, mask = _read_pair(img_path, mask_path)
    if remap_labels:
        mask = remap_bcss_labels(mask)
    return tile_slide_arrays(img, mask, out_dir, slide_name, tile_size,
                             shift_h=shift_h, shift_w=shift_w, workers=workers)


def tile_slide_arrays(
    img: np.ndarray,
    mask: np.ndarray,
    out_dir: str,
    slide_name: str,
    tile_size: int,
    shift_h: int = 0,
    shift_w: int = 0,
    workers: int | None = None,
) -> list[list]:
    """Tile one decoded (and remapped) slide, so that a caller decodes a
    region pair once and runs every shift variant over the same arrays.
    ``workers`` 0 writes in the calling thread; None or N > 0 on a thread
    pool of that size (None: the executor's default)."""
    os.makedirs(os.path.join(out_dir, slide_name, "images"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, slide_name, "masks"), exist_ok=True)

    grid = TileGrid(img.shape[0], img.shape[1], tile_size, shift_h, shift_w)
    jobs = ((out_dir, slide_name, i, grid.extract(img, i), grid.extract(mask, i))
            for i in range(len(grid)))
    if workers == 0:
        results = [_process_tile(j) for j in jobs]
    else:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            results = list(pool.map(_process_tile, jobs))
    return [r for r in results if r is not None]


def prepare_bcss(
    data_path: str,
    out_path: str,
    tile_size: int = 1024,
    shift: int = 0,
    slides: Sequence[str] | None = None,
    workers: int | None = None,
) -> list[list]:
    """Full preparation: every slide under ``data_path/images`` (with its
    mask under ``data_path/masks``), plus the shift variants when ``shift
    != 0``, writing ``out_path/data.csv``. Returns the CSV rows (under
    :data:`CSV_COLUMNS`). The README recipe is ``-s 1024 --overlap 512``."""
    img_dir = os.path.join(data_path, "images")
    mask_dir = os.path.join(data_path, "masks")
    os.makedirs(out_path, exist_ok=True)

    names = sorted(slides) if slides is not None else sorted(
        f.split(".png")[0] for f in os.listdir(img_dir) if f.endswith(".png")
    )
    variants: list[tuple[str, int, int]] = [("", 0, 0)]
    if shift != 0:
        variants += [
            (f"_shiftW_{shift}", 0, shift),
            (f"_shiftH_{shift}", shift, 0),
            (f"_shiftHW_{shift}", shift, shift),
        ]
    rows: list[list] = []
    for name in names:
        # decode and remap the region pair once a slide; the variants
        # re-tile the same arrays
        img, mask = _read_pair(os.path.join(img_dir, name + ".png"),
                               os.path.join(mask_dir, name + ".png"))
        mask = remap_bcss_labels(mask)
        for suffix, sh, sw in variants:
            rows.extend(tile_slide_arrays(img, mask, out_path, name + suffix, tile_size,
                                          shift_h=sh, shift_w=sw, workers=workers))
    # as pandas' to_csv(index=False) writes it: "\n" line ends, floats by repr
    with open(os.path.join(out_path, "data.csv"), "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(CSV_COLUMNS)
        w.writerows(rows)
    return rows
