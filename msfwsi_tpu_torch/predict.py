"""Prediction CLI of the port (from ``tools/predict.py``): export the
segmentation masks of a fine-tuned HookNet.

    python -m msfwsi_tpu_torch.predict --weights logs/ft/best_ft_model.pth.tar \\
        --train-data ../data/bcss/L0_1024_s512 --head both --amp --log-dir logs/pred

Runs the evaluation's chunked per-slide datapath and writes class-index
mask PNGs in palette mode (coloured in a viewer, read back as the raw class
indices by PIL and by the port's decoder), per tile as
``<out>/<slide>/<head>/<stem>.png`` and, with ``--stitch``, assembled into
slide maps ``<out>/<slide>_<head>_stitched.png`` on the prep grid, whose
size comes from the raw slide's PNG header (``--raw-data``).

Inputs: a prepared dataset (``--train-data`` and ``--fold``: the fold's
validation slides), any tile folders (``--tiles-dir``), or
``--synthetic``. The flags are the JAX CLI's, plus ``--device``; an Orbax
``--weights`` directory raises, naming ``tools/export_torch.py``.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import _cli
from .data.loader import NUM_THREADS
from .data.pipeline import make_seg_val_views_host
from .data.png import png_size, write_png
from .data.slides import iter_csv_slides, iter_dir_slides, iter_synthetic
from .evaluate import eval_aug_config, load_hooknet
from .ops.geometry import TileGrid
from .ssl_finetune import CLASS_NAMES
from .train import predict as PR
from .utils import prefetch_iter

__all__ = ["PALETTE", "build_parser", "main", "save_pred_png"]

# Background black and up to 15 distinct foreground colours.
PALETTE = [
    (0, 0, 0), (230, 60, 60), (60, 140, 230), (250, 200, 40), (70, 200, 120),
    (200, 100, 240), (240, 130, 40), (100, 230, 230), (160, 160, 80),
    (240, 120, 180), (100, 100, 240), (170, 230, 60), (230, 170, 130),
    (60, 170, 170), (200, 60, 130), (130, 130, 130),
]


def save_pred_png(path: str, pred: np.ndarray) -> None:
    """A (H, W) uint8 class map as a palette PNG."""
    write_png(path, pred, filters=(0,), palette=PALETTE)


def main(argv=None) -> dict:
    """Run the CLI on ``argv``. Returns the log dir, the output dir, the
    tile count and the seconds of the prediction loop (decode, views,
    forward and PNG writes)."""
    parser = build_parser()
    args, dev, _ = _cli.start(parser, argv)
    return _cli.run(args, argv, __spec__.name, lambda logger: _predict(args, dev, logger))


def _slides(args, num_classes: int, logger):
    if args.synthetic:
        return iter_synthetic(args.synthetic, 4 * args.seg_size, num_classes)
    if args.tiles_dir:
        return iter_dir_slides(args.tiles_dir, logger)
    if not args.train_data:
        raise ValueError("one of --train-data / --tiles-dir / --synthetic is required")
    return iter_csv_slides(args.train_data, args.data_name, args.fold, logger)


def _predict(args, dev, logger) -> dict:
    class_names = CLASS_NAMES[args.data_name]
    if args.stitch and not args.raw_data:
        raise ValueError("--stitch needs --raw-data (the prep input dir) for slide geometry")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    logger.info(f"=> device {dev} ({name})")
    logger.info(f"=> creating model '{args.arch}'")
    logger.info(f"=> loading fine-tuned weights {args.weights}")
    model = load_hooknet(args.weights, args.arch, len(class_names) + 1, dev, args, logger)
    aug_cfg = eval_aug_config(args)
    heads = PR.HEADS if args.head == "both" else (args.head,)
    preds_fn = PR.make_chunk_preds_for_views(model, args.val_views, aug_cfg, heads, args.amp)
    slides = _slides(args, len(class_names), logger)
    out_dir = args.out or osp.join(args.log_dir, "predictions")
    os.makedirs(out_dir, exist_ok=True)

    def prepared():
        for slide, stems, imgs in slides:
            if args.val_views == "host":
                zeros = np.zeros(imgs.shape[:3], np.uint8)
                ctx_u8, tgt_u8, _ = make_seg_val_views_host(imgs, zeros, aug_cfg)
                arrays = (ctx_u8, tgt_u8)
            else:
                arrays = (imgs,)
            yield slide, stems, int(imgs.shape[1]), arrays

    n_tiles = 0
    t0 = time.perf_counter()
    with ThreadPoolExecutor(NUM_THREADS) as pool:
        for slide, stems, tile_px, arrays in prefetch_iter(prepared()):
            preds = PR.predict_slide(preds_fn, arrays, chunk=args.val_chunk, device=dev)
            writes = []
            for head, head_preds in zip(heads, preds):
                head_dir = osp.join(out_dir, slide, head)
                os.makedirs(head_dir, exist_ok=True)
                writes += [pool.submit(save_pred_png, osp.join(head_dir, stem + ".png"), p)
                           for stem, p in zip(stems, head_preds)]
            n_tiles += len(stems)
            if args.stitch:
                raw = osp.join(args.raw_data, "images", slide + ".png")
                if not osp.exists(raw):
                    logger.warning(f"=> --stitch: no raw slide at {raw}; skipping {slide}")
                elif not all(s.isdigit() for s in stems):
                    logger.warning(f"=> --stitch: non-numeric tile ids for {slide}; skipping")
                else:
                    w, h = png_size(raw)  # the header only
                    grid = TileGrid(h, w, tile_px)
                    indices = [int(s) for s in stems]
                    for head, head_preds in zip(heads, preds):
                        stitch = (PR.stitch_context_preds if head == "context"
                                  else PR.stitch_target_preds)
                        canvas = stitch(head_preds, indices, grid, seg_size=args.seg_size)
                        writes.append(pool.submit(
                            save_pred_png, osp.join(out_dir, f"{slide}_{head}_stitched.png"),
                            canvas))
            for f in writes:
                f.result()
            logger.info(f"=> {slide}: wrote {len(stems)} tile prediction(s) per head")
    seconds = time.perf_counter() - t0
    logger.info(f"=> done: {n_tiles} tiles -> {out_dir} in {seconds:.2f} s")
    return {"log_dir": args.log_dir, "out_dir": out_dir, "tiles": n_tiles, "seconds": seconds}


def build_parser():
    parser = argparse.ArgumentParser(description="MSF-WSI mask prediction (PyTorch port)")
    parser.add_argument("-a", "--arch", default="resnet18")
    parser.add_argument("--weights", type=str, required=True,
                        help="fine-tuned HookNet checkpoint (.pth.tar)")
    parser.add_argument("--data-name", type=str, default="bcss", choices=("bcss", "paip"),
                        help="class schema (bcss: 5+bg, paip: 3+bg)")
    parser.add_argument("--train-data", type=str,
                        help="prepared dataset root: predict on the fold's val slides")
    parser.add_argument("--fold", type=int, default=0)
    parser.add_argument("--tiles-dir", type=str,
                        help="predict on arbitrary tile PNGs: <dir>/images/*.png "
                        "or <dir>/<slide>/images/*.png (no masks needed)")
    parser.add_argument("--synthetic", type=int, default=0)
    parser.add_argument("--mean", nargs=3, type=float, default=[0.485, 0.456, 0.406])
    parser.add_argument("--std", nargs=3, type=float, default=[0.229, 0.224, 0.225])
    parser.add_argument("--seed", default=3407, type=int)
    parser.add_argument("--amp", action="store_true")
    parser.add_argument("--log-dir", default="./logs/temp", type=str)
    parser.add_argument("--out", type=str, help="output dir (default <log_dir>/predictions)")
    parser.add_argument("--head", choices=("target", "context", "both"), default="target",
                        help="target: full-res center crops (what the reference scores); "
                        "context: whole tile at 1/4 scale (gap-free stitching)")
    parser.add_argument("--stitch", action="store_true",
                        help="also write slide-level maps assembled with the prep grid "
                        "geometry (needs --raw-data for slide sizes)")
    parser.add_argument("--raw-data", type=str,
                        help="prep input dir (images/<slide>.png) for --stitch geometry")
    parser.add_argument("--val-chunk", type=int, default=128,
                        help="tiles per device pass (reference: 128)")
    parser.add_argument("--val-views", choices=("host", "device"), default="host",
                        help="where eval views are built (see the evaluate CLI)")
    parser.add_argument("--seg-size", type=int, default=256)

    # The port's own
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


if __name__ == "__main__":
    main()
