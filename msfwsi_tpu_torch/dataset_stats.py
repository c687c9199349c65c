"""Dataset normalization statistics (port of ``tools/dataset_stats.py``):
the ``--mean/--std`` a training run should be given.

    python -m msfwsi_tpu_torch.dataset_stats --train-data ../data/bcss/L0_1024_s512

The channel mean and std of the [0, 1]-scaled pixels in one streaming pass
(the reference's ``cal_mean_and_std``, ``src/utils/utils.py:26-62``), over
the fold's training tiles (``--fold -1``: every tile of ``data.csv``) or
over every image under ``--tiles-dir`` (``masks/`` folders skipped). Tiles
are decoded by the port's decoder on a thread pool and summed in float64
on ``--device``. Prints the exact flags to pass. The flags are the JAX
CLI's, plus ``--device``.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from . import native, resolve_device
from .data import datasets as D

__all__ = ["build_parser", "main", "cal_mean_and_std"]


def _prepared_files(data_name: str, train_data: str, fold: int, threshold: float,
                    frac: float) -> list[str]:
    if fold == -1:
        files = [r["filename_img"] for r in D._read_csv(train_data, "data.csv")]
    elif data_name == "bcss":
        files = D.bcss_pretrain_files(train_data, fold=fold, threshold=threshold, frac=frac)
    else:
        files = D.paip_pretrain_files(train_data, fold=fold, threshold=threshold, frac=frac)
    return [osp.join(train_data, f) for f in files]


def _dir_files(tiles_dir: str) -> list[str]:
    out = []
    for root, _, names in os.walk(tiles_dir):
        if osp.basename(root) == "masks":
            continue
        out += [osp.join(root, n) for n in names if n.lower().endswith((".png", ".jpg", ".jpeg"))]
    return sorted(out)


def cal_mean_and_std(images, device="cpu", max_value: float = 255.0):
    """Channel mean and std of ``images`` ((H, W, C) arrays) scaled by
    ``1 / max_value``, from float64 sums of x and x^2 on ``device``;
    returns two length-C lists."""
    n, s1, s2 = 0, None, None
    for img in images:
        x = torch.from_numpy(img).to(device).double() / max_value
        x = x.reshape(-1, x.shape[-1])
        s1 = x.sum(0) if s1 is None else s1 + x.sum(0)
        s2 = (x * x).sum(0) if s2 is None else s2 + (x * x).sum(0)
        n += x.shape[0]
    if n == 0:
        raise ValueError("cal_mean_and_std: no images")
    mean = s1 / n
    std = torch.sqrt(s2 / n - mean**2)
    return mean.cpu().tolist(), std.cpu().tolist()


def main(argv=None) -> tuple[list, list]:
    """Run the CLI on ``argv``; returns (mean, std)."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    if args.train_data:
        files = _prepared_files(args.data_name, args.train_data, args.fold, args.threshold,
                                args.frac)
    elif args.tiles_dir:
        files = _dir_files(args.tiles_dir)
    else:
        print("=> one of --train-data / --tiles-dir is required", file=sys.stderr)
        raise SystemExit(2)
    if not files:
        print("=> no images found", file=sys.stderr)
        raise SystemExit(1)
    print(f"=> {len(files)} images")
    with ThreadPoolExecutor(args.threads) as pool:
        mean, std = cal_mean_and_std(pool.map(native.load_image, files), dev)
    fmt = lambda v: " ".join(f"{x:.4f}" for x in v)  # noqa: E731
    print(f"Dataset MEAN is: {[round(v, 6) for v in mean]}")
    print(f"Dataset STD is: {[round(v, 6) for v in std]}")
    print(f"--mean {fmt(mean)} --std {fmt(std)}")
    return mean, std


def build_parser():
    parser = argparse.ArgumentParser(description="MSF-WSI dataset mean/std (PyTorch port)")
    parser.add_argument("--data-name", type=str, default="bcss", choices=("bcss", "paip"))
    parser.add_argument("--train-data", type=str,
                        help="prepared dataset root (data.csv): stats over the fold's train "
                        "tiles")
    parser.add_argument("--fold", type=int, default=0, help="-1 = all tiles")
    parser.add_argument("--threshold", type=float, default=0.1,
                        help="min ratio_masked_area (pretrain default)")
    parser.add_argument("--frac", type=float, default=1.0)
    parser.add_argument("--tiles-dir", type=str,
                        help="any folder tree of tiles (masks/ subdirs skipped)")
    parser.add_argument("--threads", type=int, default=8)

    # The port's own
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


if __name__ == "__main__":
    main()
