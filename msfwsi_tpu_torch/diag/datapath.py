"""The SSL CLI's datapath on the card, measured in one process.

    python -m msfwsi_tpu_torch.diag.datapath [--tiles 256] [--epochs 3]

Writes ``--tiles`` smooth 1024 px RGB PNG tiles (with mild noise, so
that they do not compress as a bare gradient would; rows cycle through the
five PNG filters) and a BCSS-style ``data.csv`` into a temporary directory, then
prints, one line each:

  * the decoder's build (whether libjpeg and libpng headers were found);
  * the decode rate in tiles/s at the loader's thread count;
  * the host-to-device copy of one (B, 1024, 1024, 3) uint8 batch from
    pinned memory, ms by CUDA events;
  * the CLI's tile views/s (B * steps * (2 + 2K) / seconds, epochs after
    the first, each timed from its first batch in hand to its loss fetch)
    and the wait for each epoch's first batch (the fill, which no step
    overlaps), training from the PNGs, then from a ``--packed-cache``;
  * the port bench's median and quartiles in modes ``pipeline`` and
    ``step`` (``BENCH_*`` variables apply);

and a last JSON line with all of them and the card's name. The helpers
also serve ``chip_smoke.py``'s phases "datapath" and "cli", and the tests;
tiles are written by the data layer's PNG writer (:mod:`..data.png`).
"""

from __future__ import annotations

import argparse
import csv
import json
import math
import os
import shutil
import statistics
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np
import torch

from .. import native, resolve_device
from ..data.loader import NUM_THREADS
from ..data.png import write_png

__all__ = ["smooth_tiles", "write_bcss_dataset", "write_bcss_masks", "decode_rate",
           "h2d_ms", "cli_argv", "cli_rate", "cli_fill_s", "main"]

def smooth_tiles(n: int, size: int = 1024, seed: int = 0, device="cpu") -> np.ndarray:
    """(n, size, size, 3) uint8: per tile a smooth sinusoidal colour field
    plus Gaussian noise of std 4, drawn on ``device``."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    yy = torch.arange(size, device=dev, dtype=torch.float32).view(size, 1, 1) / size
    xx = torch.arange(size, device=dev, dtype=torch.float32).view(1, size, 1) / size
    out = np.empty((n, size, size, 3), np.uint8)
    for i in range(n):
        f = torch.rand((2, 3), generator=gen, device=dev) * 3 + 1
        phase = torch.rand(3, generator=gen, device=dev) * 2 * math.pi
        img = 127 + 100 * torch.sin(math.pi * (f[0] * yy + f[1] * xx) + phase)
        img = img + 4 * torch.randn((size, size, 3), generator=gen, device=dev)
        out[i] = img.round().clamp(0, 255).to(torch.uint8).cpu().numpy()
    return out


def write_bcss_dataset(root: str, tiles: np.ndarray, threads: int = NUM_THREADS) -> list[str]:
    """``tiles`` as ``root/tiles/tile_NNNN.png`` (rows cycling through
    filters 0-4) and a ``data.csv`` listing them, none in fold 0's
    validation slides, all above the area threshold. Returns the relative
    paths in order."""
    os.makedirs(os.path.join(root, "tiles"), exist_ok=True)
    files = [f"tiles/tile_{i:04d}.png" for i in range(len(tiles))]
    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(lambda i: write_png(os.path.join(root, files[i]), tiles[i]),
                      range(len(tiles))))
    codes = ("A2", "B6", "C4", "D1")  # not in BCSS_VAL_SET[0]
    with open(os.path.join(root, "data.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["filename", "filename_img", "filename_mask", "ratio_masked_area"])
        for i, name in enumerate(files):
            w.writerow([f"TCGA-{codes[i % 4]}-{i:04d}", name, "", 0.5])
    return files


def write_bcss_masks(root: str, files: Sequence[str], masks: np.ndarray, n_val: int,
                     threads: int = NUM_THREADS) -> list[str]:
    """Make a :func:`write_bcss_dataset` directory a fine-tuning one:
    ``masks`` (N, H, W) uint8 as grey ``root/masks/mask_NNNN.png`` and
    ``data.csv`` rewritten with their ``filename_mask`` and each BCSS
    class's share of the mask, ``ratio_masked_{c}_area`` for c in 1-5 (the
    probe's tile labels). The last ``n_val`` tiles become one slide of fold
    0's validation set (``TCGA-OL-0000``); the others keep their slide
    codes, outside it. Returns the mask paths."""
    os.makedirs(os.path.join(root, "masks"), exist_ok=True)
    names = [f"masks/mask_{i:04d}.png" for i in range(len(files))]
    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(lambda i: write_png(os.path.join(root, names[i]), masks[i]),
                      range(len(files))))
    codes = ("A2", "B6", "C4", "D1")  # not in BCSS_VAL_SET[0]
    n_train = len(files) - n_val
    with open(os.path.join(root, "data.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["filename", "filename_img", "filename_mask", "ratio_masked_area",
                    *(f"ratio_masked_{c}_area" for c in range(1, 6))])
        for i, (img, mask) in enumerate(zip(files, names)):
            slide = f"TCGA-{codes[i % 4]}-{i:04d}" if i < n_train else "TCGA-OL-0000"
            shares = [float((masks[i] == c).mean()) for c in range(1, 6)]
            w.writerow([slide, img, mask, 0.5, *shares])
    return names


def decode_rate(paths, shape, threads: int = NUM_THREADS, reps: int = 2) -> float:
    """Tiles/s of ``native.decode_batch`` on ``paths`` (best of ``reps``)."""
    out = np.empty((len(paths), *shape), np.uint8)
    best = math.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        native.decode_batch(paths, *shape, threads, out=out)
        best = min(best, time.perf_counter() - t0)
    return len(paths) / best


def h2d_ms(shape, device, reps: int = 10) -> float:
    """Median ms of one non-blocking copy of a pinned uint8 ``shape`` batch
    to ``device``, by CUDA events."""
    src = torch.empty(shape, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(shape, dtype=torch.uint8, device=device)
    times = []
    for _ in range(reps + 2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dst.copy_(src, non_blocking=True)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times[2:])


def cli_argv(root: str, log_dir: str, batch: int = 32, epochs: int = 2, extra=()) -> list[str]:
    """The CLI's arguments for resnet18 at scale 4 under ``--amp`` on the
    BCSS-style dataset at ``root``."""
    return ["-a", "resnet18", "-b", str(batch), "--scale", "4", "--amp", "--data-name", "bcss",
            "--data", root, "--epochs", str(epochs), "--imagenet-weights", "none",
            "--log-dir", log_dir, "-p", "1", *extra]


def _timed_epochs(result: dict) -> list[dict]:
    """A CLI run's epochs after the first (the first if it has only one)."""
    return result["epochs"][1:] or result["epochs"]


def cli_rate(result: dict, batch: int, scale: int = 4) -> float:
    """Tile views/s of a CLI run over :func:`_timed_epochs`, each timed
    from its first batch in hand to its loss fetch: the fill of the first
    batch, which no step overlaps, is :func:`cli_fill_s`."""
    epochs = _timed_epochs(result)
    steps = sum(e["steps"] for e in epochs)
    seconds = sum(e["seconds"] - e["fill_seconds"] for e in epochs)
    return batch * steps * (2 + 2 * scale**2) / seconds


def cli_fill_s(result: dict) -> float:
    """Mean seconds an epoch of :func:`_timed_epochs` waited for its first
    batch."""
    epochs = _timed_epochs(result)
    return sum(e["fill_seconds"] for e in epochs) / len(epochs)


def main(argv=None) -> dict:
    from .. import bench, ssl_train

    parser = argparse.ArgumentParser(description="SSL CLI datapath on the card")
    parser.add_argument("--tiles", type=int, default=256)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("-b", "--batch-size", type=int, default=32)
    args = parser.parse_args(argv)
    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    out = {"card": card, "tiles": args.tiles, "batch": args.batch_size}
    tmp = tempfile.mkdtemp(prefix="msfwsi_datapath_")
    try:
        native.load_library()
        out["libjpeg"] = native.has_jpeg()
        out["libpng_header"] = native.header_found("png.h")
        print(f"decoder built: libjpeg {out['libjpeg']}, png.h {out['libpng_header']}",
              flush=True)
        root = os.path.join(tmp, "data")
        tiles = smooth_tiles(args.tiles, 1024, seed=0, device=dev)
        t0 = time.perf_counter()
        files = write_bcss_dataset(root, tiles)
        size = sum(os.path.getsize(os.path.join(root, f)) for f in files)
        print(f"wrote {len(files)} PNGs in {time.perf_counter() - t0:.1f} s, "
              f"{size / tiles.nbytes:.3f} of the raw bytes", flush=True)
        del tiles
        paths = [os.path.join(root, f) for f in files]
        out["decode_tiles_per_s"] = decode_rate(paths, (1024, 1024, 3))
        out["h2d_ms"] = h2d_ms((args.batch_size, 1024, 1024, 3), dev)
        print(f"decode {out['decode_tiles_per_s']:.1f} tiles/s at {NUM_THREADS} threads; "
              f"H2D {out['h2d_ms']:.3f} ms per batch", flush=True)
        for name, extra in (("cli_png", ()),
                            ("cli_pack", ("--packed-cache", os.path.join(tmp, "pack")))):
            res = ssl_train.main(cli_argv(root, os.path.join(tmp, name), args.batch_size,
                                          args.epochs, extra))
            out[name] = cli_rate(res, args.batch_size)
            out[name + "_fill_s"] = cli_fill_s(res)
            out[name + "_epochs"] = [{k: e[k] for k in ("steps", "seconds", "fill_seconds", "loss")}
                                     for e in res["epochs"]]
            del res
            print(f"{name}: {out[name]:.2f} tile views/s from each epoch's first batch; "
                  f"first-batch fill {out[name + '_fill_s']:.3f} s an epoch", flush=True)
        for mode in ("pipeline", "step"):
            b = bench.main([], env={**os.environ, "BENCH_MODE": mode})
            out[f"bench_{mode}"] = {k: b[k] for k in ("value", "q1", "q3", "rates", "peak_bytes")}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
