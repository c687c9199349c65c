"""SSL pre-training entry point of the port (synthetic-data mode).

    python -m msfwsi_tpu_torch.ssl_train --synthetic 64 -b 32 --steps 5 --amp

Trains ``--steps`` fused steps (on-device augmentation + train step) on
``--synthetic`` seeded random uint8 tiles of ``scale * tile_px`` pixels and
logs the loss and tile views/s (``B * steps * (2 + 2K) / seconds``). Flag
names follow ``tools/ssl_train.py``; data loading, checkpoints and
experiment logging of the full CLI are not ported yet.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from . import resolve_device
from .data.pipeline import AugConfig
from .train.ssl import SSLConfig, create_ssl_state, make_fused_step

__all__ = ["build_parser", "main"]


def build_parser():
    parser = argparse.ArgumentParser(description="MSF-WSI pre-training (PyTorch port)")
    parser.add_argument("-a", "--arch", default="resnet18")
    parser.add_argument("-b", "--batch-size", default=32, type=int)
    parser.add_argument("-p", "--print-freq", default=1, type=int)
    parser.add_argument("--lr", "--learning-rate", default=1e-3, type=float)
    parser.add_argument("--seed", default=3407, type=int)
    parser.add_argument("--mean", nargs=3, type=float, default=[0.485, 0.456, 0.406])
    parser.add_argument("--std", nargs=3, type=float, default=[0.229, 0.224, 0.225])
    parser.add_argument("-i", "--img-sz", type=int, default=224)
    parser.add_argument("--mask_ratio", type=int, default=50)
    parser.add_argument("--amp", action="store_true")
    parser.add_argument("--ms_lr", nargs=3, type=float, default=[1.0, 1.0, 1.0])
    parser.add_argument("--scale", type=int, default=4)
    parser.add_argument("--fuser_weights", nargs=4, type=float, default=[0.1, 0.4, 0.7, 1.0])
    parser.add_argument("--synthetic", type=int, required=True,
                        help="train on N seeded random uint8 tiles")
    parser.add_argument("--tile-px", type=int, default=256,
                        help="target sub-tile size before the per-tile RRC")
    parser.add_argument("--steps", type=int, default=5, help="train steps to run")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    config = SSLConfig(
        arch=args.arch, batch_size=args.batch_size, lr=args.lr, mask_ratio=args.mask_ratio,
        scale=args.scale, ms_lr=tuple(args.ms_lr), fuser_weights=tuple(args.fuser_weights),
        seed=args.seed, amp=args.amp,
    )
    aug_cfg = AugConfig(
        mean=tuple(args.mean), std=tuple(args.std), img_size=args.img_sz, grid=args.scale,
        tile_px=args.tile_px, compute_dtype="bfloat16" if args.amp else "float32",
    )
    if args.synthetic < args.batch_size:
        raise ValueError(f"--synthetic {args.synthetic} is smaller than the batch {args.batch_size}")
    src = args.scale * args.tile_px
    rng = np.random.default_rng(args.seed)
    tiles = torch.from_numpy(rng.integers(0, 256, (args.synthetic, src, src, 3), dtype=np.uint8))
    state = create_ssl_state(config, device=dev)
    step = make_fused_step(config, aug_cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    views_per_sample = 2 + 2 * args.scale**2
    n_batches = args.synthetic // args.batch_size
    print(f"=> {args.arch} scale {args.scale} b{args.batch_size} amp={args.amp} on {dev}, "
          f"init_lr {config.init_lr:.6f}", flush=True)
    t0 = time.perf_counter()
    loss = float("nan")
    for i in range(args.steps):
        j = i % n_batches
        metrics = step(state, tiles[j * args.batch_size : (j + 1) * args.batch_size], gen)
        if (i + 1) % args.print_freq == 0 or i + 1 == args.steps:
            loss = float(metrics["loss"])  # synchronizes
            dt = time.perf_counter() - t0
            rate = args.batch_size * (i + 1) * views_per_sample / dt
            print(f"step {i + 1}/{args.steps} loss {loss:.6f} tile views/s {rate:.1f}", flush=True)
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    return {"loss": loss, "steps": args.steps}


if __name__ == "__main__":
    main()
