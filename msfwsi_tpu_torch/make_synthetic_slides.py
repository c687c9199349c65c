"""Synthetic, learnable raw datasets in the BCSS or Camelyon16 layout (port
of ``tools/make_synthetic_slides.py``, written without PIL).

    python -m msfwsi_tpu_torch.make_synthetic_slides -o /tmp/bcss_raw --slides 6 --size 3072
    python -m msfwsi_tpu_torch.make_synthetic_slides -o /tmp/c16 --layout c16 \\
        --slides 4 --tiles-per-slide 8

``--layout bcss`` (the default) writes region PNGs in the layout that
``bcss_prepare`` reads (``<out>/images/TCGA-XX-....png`` and
``<out>/masks/...``, raw label codes): an H&E-like background with blobby
annotated regions whose codes go with a class tint, so the whole recipe
(prepare, SSL pretraining, fine-tuning, evaluation) has something to learn.
``--layout c16`` writes a prepared Camelyon16 pretraining corpus: per-slide
tile folders ``imagesTr/<id>/<id>_<n>.png`` (and ``imagesTs/``) with a
``dataset.json`` of ``train_ids`` / ``val_ids`` / ``test_ids`` /
``file_ending``.

The flags and the numpy draws are the JAX tool's, in the same order, so a
``--seed`` gives the same arrays as there (the texture is
``scipy.ndimage.gaussian_filter``'s, as there). Each blob is computed over
its bounding square only, which gives the same pixels as the tool's
full-slide grid at a fraction of the cost. PNGs are written by
:func:`.data.png.write_png`. A host tool: no ``--device``.
"""

from __future__ import annotations

import argparse
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .data.png import write_png

__all__ = ["CLASS_TO_RAW", "CLASS_TINT", "INSTITUTIONS", "make_slide", "build_parser", "main",
           "main_bcss", "main_c16"]

# one raw code per collapsed class (ops/geometry.BCSS_CLASS_REMAP)
CLASS_TO_RAW = {1: 1, 2: 2, 3: 3, 4: 4, 5: 5}
CLASS_TINT = {
    1: (170, 60, 120),  # tumor: purple-ish
    2: (235, 170, 200),  # stroma: pink
    3: (90, 60, 160),  # inflammatory: blue-purple
    4: (240, 230, 180),  # necrosis: pale yellow
    5: (120, 200, 140),  # other: green tint
}
# BCSS slide IDs carry the institution code in field 2 (the reference's
# bcss.py:67); fold 0's validation institutions include "OL".
INSTITUTIONS = ["OL", "A1", "A2", "A7", "A8", "AR"]


def make_slide(rng: np.random.Generator, size: int) -> tuple[np.ndarray, np.ndarray]:
    """A (size, size, 3) uint8 H&E-like image and its (size, size) uint8
    mask of raw codes, drawn from ``rng`` as the JAX tool draws them."""
    from scipy.ndimage import gaussian_filter

    base = np.array([225, 195, 215], np.float32)  # H&E background
    img = base[None, None] + rng.normal(scale=6.0, size=(size, size, 3))
    mask = np.zeros((size, size), np.uint8)

    n_blobs = rng.integers(16, 28)
    for _ in range(n_blobs):
        cls = int(rng.integers(1, 6))
        cy, cx = rng.integers(0, size, 2)
        ry, rx = rng.integers(size // 16, size // 5, 2)
        ang = rng.uniform(0, np.pi)
        ca, sa = np.cos(ang), np.sin(ang)
        # Outside the square of half-side max(ry, rx) around the centre,
        # (u/ry)^2 + (v/rx)^2 >= (r+1)^2 / r^2 > 1: no pixel of the blob.
        r = max(ry, rx)
        y0, y1 = max(0, cy - r), min(size, cy + r + 1)
        x0, x1 = max(0, cx - r), min(size, cx + r + 1)
        dy, dx = np.arange(y0, y1)[:, None] - cy, np.arange(x0, x1)[None, :] - cx
        u = dy * ca + dx * sa  # element for element the tool's full-grid values
        v = -dy * sa + dx * ca
        blob = (u / ry) ** 2 + (v / rx) ** 2 < 1.0
        mask[y0:y1, x0:x1][blob] = CLASS_TO_RAW[cls]
        tint = np.asarray(CLASS_TINT[cls], np.float32)
        win = img[y0:y1, x0:x1]
        win[blob] = 0.35 * win[blob] + 0.65 * tint

    # texture so SSL has structure beyond flat color
    tex = gaussian_filter(rng.normal(scale=1.0, size=(size, size)), sigma=3)
    img += 25.0 * tex[..., None]
    return np.clip(img, 0, 255).astype(np.uint8), mask


def main_bcss(args) -> list[str]:
    """BCSS region PNGs; returns the slide names. A slide's PNGs are written
    on a thread while the next slide is drawn (zlib and numpy release the
    interpreter lock)."""
    os.makedirs(os.path.join(args.out, "images"), exist_ok=True)
    os.makedirs(os.path.join(args.out, "masks"), exist_ok=True)
    rng = np.random.default_rng(args.seed)
    names, writes = [], []
    with ThreadPoolExecutor(max_workers=2) as pool:
        for i in range(args.slides):
            inst = INSTITUTIONS[i % len(INSTITUTIONS)]
            name = f"TCGA-{inst}-S{i:02d}-DX1_xmin0_ymin0_MPP-0.2500"
            img, mask = make_slide(rng, args.size)
            for sub, arr in (("images", img), ("masks", mask)):
                writes.append(pool.submit(write_png, os.path.join(args.out, sub, name + ".png"),
                                          arr))
            names.append(name)
            print(f"wrote {name} ({args.size}px, classes: {sorted(set(np.unique(mask)) - {0})})")
        for w in writes:
            w.result()  # a failed write raises here
    return names


def main_c16(args) -> dict:
    """A prepared C16 pretraining corpus: ``imagesTr/<id>/`` tile folders and
    ``dataset.json`` (the manifest keys of the reference's
    ``camelyon.py:56-61``); one validation and one test slide are always
    written, so ``--c16-mode all`` has an ``imagesTs`` to read. Returns the
    manifest."""
    rng = np.random.default_rng(args.seed)
    tile = args.tile_size
    train_ids, val_ids, test_ids = [], [], []
    # C16 slide naming: tumor_###/normal_### in train, test_### in test.
    specs = [("imagesTr", f"{'tumor' if i % 2 else 'normal'}_{i:03d}", train_ids)
             for i in range(args.slides)]
    specs.append(("imagesTr", f"normal_{args.slides:03d}", val_ids))
    specs.append(("imagesTs", f"test_{0:03d}", test_ids))
    for sub, slide_id, bucket in specs:
        d = os.path.join(args.out, sub, slide_id)
        os.makedirs(d, exist_ok=True)
        bucket.append(slide_id)
        # the tiles of a slide are crops of one textured canvas, so they
        # share its appearance statistics, as real WSI tiles do
        canvas, _ = make_slide(rng, tile * 2)
        for t in range(args.tiles_per_slide):
            y, x = rng.integers(0, tile, 2)
            write_png(os.path.join(d, f"{slide_id}_{t}.png"), canvas[y : y + tile, x : x + tile])
        print(f"wrote {sub}/{slide_id}: {args.tiles_per_slide} x {tile}px tiles")
    meta = {
        "train_ids": train_ids,
        "val_ids": val_ids,
        "test_ids": test_ids,
        "file_ending": ".png",
    }
    with open(os.path.join(args.out, "dataset.json"), "w") as f:
        json.dump(meta, f, indent=1)
    print(f"wrote dataset.json ({len(train_ids)} train / {len(val_ids)} val / "
          f"{len(test_ids)} test ids)")
    return meta


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--layout", choices=("bcss", "c16"), default="bcss")
    p.add_argument("--slides", type=int, default=6)
    p.add_argument("--size", type=int, default=3072)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiles-per-slide", type=int, default=8,
                   help="(c16) tiles per slide dir")
    p.add_argument("--tile-size", type=int, default=1024,
                   help="(c16) tile edge in px (reference corpus: 1024)")
    return p


def main(argv=None):
    """Run the CLI on ``argv``: the slide names (bcss) or the manifest (c16)."""
    args = build_parser().parse_args(argv)
    return main_c16(args) if args.layout == "c16" else main_bcss(args)


if __name__ == "__main__":
    main()
