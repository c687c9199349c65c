"""Tile-embedding CLI of the port (from ``tools/extract_features.py``):
per-tile features of a pretrained MSFWSI SSL checkpoint.

    python -m msfwsi_tpu_torch.extract_features --weights logs/ssl/checkpoint_0499.pth.tar \\
        --train-data ../data/bcss/L0_1024_s512 --split train --amp --out feats/train

Runs the two-branch forward of :mod:`.train.features` over slides on the
chunked datapath and writes one ``<slide>.npz`` per slide:

* ``stems``: tile ids (prep-layout names), the row order of every array;
* ``context_s{1..4}``: (T, C_i) whole-tile context-encoder features;
* ``target_s{1..4}``: (T, K, C_i) per-sub-tile target-encoder features
  (K = scale^2, spatial row-major);

and a ``features.json`` manifest (arch, scale, the branch/stage channel
map). Only the requested encoders are loaded; the SSL heads are not.

``--weights`` is an SSL ``.pth.tar`` of the port or the reference, or
``random``: the epoch-0 encoders of the port's own SSL training for
``--seed`` (``build_msfwsi(torch.Generator().manual_seed(seed))``), the
control a linear probe compares against. A fine-tuned HookNet checkpoint is
refused; an Orbax directory raises, naming ``tools/export_torch.py``. The
flags are the JAX CLI's, plus ``--device``.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import time

import numpy as np
import torch

from . import _cli
from .data.pipeline import AugConfig
from .data.slides import iter_csv_slides, iter_dir_slides, iter_synthetic
from .models.backbone import MSFWSI, build_msfwsi
from .models.resnet import get_encoder
from .evaluate import chunk_mesh
from .ssl_finetune import check_norm_stats
from .train import checkpoint as C
from .train import features as F
from .train.predict import predict_slide
from .utils import prefetch_iter

__all__ = ["build_parser", "main", "encoders_model"]


def encoders_model(state_dict: dict, arch: str, scale: int, branches, dev, weights: str
                   ) -> MSFWSI:
    """An MSFWSI in eval mode whose requested branch encoders hold
    ``state_dict``'s (keys with or without ``module.``) on ``dev``; the
    heads and any other encoder stay unallocated (on the meta device) and
    are never run."""
    sd = {k.removeprefix("module."): v for k, v in state_dict.items()}
    with torch.device("meta"):
        model = MSFWSI(arch=arch, scale=scale)
    for b in branches:
        prefix = f"{b}_encoder."
        enc = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)
               and not k.startswith(f"{prefix}fc.") and not k.endswith("num_batches_tracked")}
        if not enc:
            raise ValueError(f"checkpoint {weights} has no {b}_encoder weights: is this an SSL "
                             "checkpoint? (fine-tuned HookNet checkpoints are not supported "
                             "here)")
        encoder = get_encoder(arch, zero_init_residual=True)
        encoder.load_state_dict(enc, strict=True)
        setattr(model, f"{b}_encoder", encoder.to(dev))
    return model.eval()


def main(argv=None) -> dict:
    """Run the CLI on ``argv``. Returns the log dir, the output dir, the
    feature spec, the tile count and the seconds of the extraction loop."""
    return _cli.launch(build_parser(), argv, __spec__.name, _extract)


def _extract(args, dev, defaults, logger, mesh) -> dict:
    branches = F.BRANCHES if args.branch == "both" else (args.branch,)
    scales = tuple(int(s) for s in args.scales.split(","))
    logger.info(f"=> creating model '{args.arch}' (scale {args.scale})")
    if args.weights == "random":
        logger.info(f"=> random-init encoders (untrained probe control, seed {args.seed})")
        sd = build_msfwsi(torch.Generator().manual_seed(args.seed), arch=args.arch,
                          scale=args.scale).state_dict()
    else:
        logger.info(f"=> loading SSL weights {args.weights}")
        resolved = C.resolve_checkpoint_arg(args.weights)
        if resolved is None:
            logger.error(f"=> weights not found: {args.weights}")
            raise FileNotFoundError(f"--weights {args.weights}: no such file")
        check_norm_stats(args, resolved, logger)
        sd = C.load_torch_file(resolved)
    model = encoders_model(sd, args.arch, args.scale, branches, dev, args.weights)
    del sd

    aug_cfg = AugConfig(mean=tuple(args.mean), std=tuple(args.std), img_size=args.img_sz)
    out_dtype = torch.float32 if args.out_dtype == "float32" else torch.float16
    feats_fn = F.make_chunk_features(model, aug_cfg, branches, scales, out_dtype, amp=args.amp)
    spec = F.feature_spec(model, branches, scales)

    if args.synthetic:
        slides = iter_synthetic(args.synthetic, args.tile_px, 6)
    elif args.tiles_dir:
        slides = iter_dir_slides(args.tiles_dir, logger)
    elif args.train_data:
        slides = iter_csv_slides(args.train_data, args.data_name, args.fold, logger,
                                 split=args.split)
    else:
        raise ValueError("one of --train-data / --tiles-dir / --synthetic is required")

    out_dir = args.out or osp.join(args.log_dir, "features")
    split = chunk_mesh(mesh, args.chunk, logger, "extraction")
    if mesh.is_main:
        os.makedirs(out_dir, exist_ok=True)
        _write_spec(out_dir, args, spec)

    n_tiles = 0
    t0 = time.perf_counter()
    for slide, stems, imgs in prefetch_iter(slides):
        if imgs.shape[1] % args.scale or imgs.shape[2] % args.scale:
            logger.warning(f"=> {slide}: tile size {imgs.shape[1]}x{imgs.shape[2]} not "
                           f"divisible by --scale {args.scale}; skipping")
            continue
        feats = predict_slide(feats_fn, (imgs,), chunk=args.chunk, device=dev, mesh=split)
        n_tiles += len(stems)
        if not mesh.is_main:  # rank 0 writes every slide's features
            continue
        payload = {"stems": np.asarray(stems)}
        for (b, s, _), arr in zip(spec, feats):
            payload[f"{b}_s{s}"] = arr
        np.savez(osp.join(out_dir, f"{slide}.npz"), **payload)
        logger.info(f"=> {slide}: {len(stems)} tiles x {len(spec)} feature keys")
    seconds = time.perf_counter() - t0
    logger.info(f"=> done: {n_tiles} tiles -> {out_dir} in {seconds:.2f} s")
    return {"log_dir": args.log_dir, "out_dir": out_dir, "spec": spec, "tiles": n_tiles,
            "seconds": seconds}


def _write_spec(out_dir: str, args, spec) -> None:
    with open(osp.join(out_dir, "features.json"), "w") as f:
        json.dump({
            "arch": args.arch, "scale": args.scale, "img_size": args.img_sz,
            "weights": str(args.weights), "out_dtype": args.out_dtype,
            "keys": [{"key": f"{b}_s{s}", "branch": b, "stage": s, "channels": c,
                      "shape": ["T", c] if b == "context" else ["T", args.scale**2, c]}
                     for b, s, c in spec],
        }, f, indent=2)


def build_parser():
    parser = argparse.ArgumentParser(description="MSF-WSI tile embedding extraction "
                                     "(PyTorch port)")
    parser.add_argument("-a", "--arch", default="resnet18")
    parser.add_argument("--weights", type=str, required=True,
                        help="SSL checkpoint (.pth.tar), or 'random' for untrained encoders: "
                        "the control a linear probe compares against (epoch-0 encoders of "
                        "--seed)")
    parser.add_argument("--data-name", type=str, default="bcss", choices=("bcss", "paip"))
    parser.add_argument("--train-data", type=str,
                        help="prepared dataset root: extract on the fold's val slides")
    parser.add_argument("--fold", type=int, default=0)
    parser.add_argument("--split", choices=("val", "train"), default="val",
                        help="which side of the fold to extract (--train-data mode); train "
                        "includes shift variants, val excludes them (the reference's "
                        "validation contract)")
    parser.add_argument("--tiles-dir", type=str,
                        help="extract from arbitrary tile PNGs: <dir>/images/*.png "
                        "or <dir>/<slide>/images/*.png")
    parser.add_argument("--synthetic", type=int, default=0)
    parser.add_argument("--branch", choices=("context", "target", "both"), default="both",
                        help="context: whole-tile features; target: per-sub-tile feature "
                        "stacks (K = scale^2)")
    parser.add_argument("--scales", type=str, default="1,2,3,4",
                        help="comma-separated 1-indexed encoder stages to export")
    parser.add_argument("--scale", type=int, default=4,
                        help="sub-tile grid (K = scale^2); must match pretraining")
    parser.add_argument("--img-sz", type=int, default=224,
                        help="encoder input size (reference --img-sz)")
    parser.add_argument("--tile-px", type=int, default=1024, help="synthetic-mode tile size")
    parser.add_argument("--mean", nargs=3, type=float, default=[0.485, 0.456, 0.406])
    parser.add_argument("--std", nargs=3, type=float, default=[0.229, 0.224, 0.225])
    parser.add_argument("--seed", default=3407, type=int)
    parser.add_argument("--amp", action="store_true", help="bf16 encoder compute")
    parser.add_argument("--out-dtype", choices=("float16", "float32"), default="float16",
                        help="dtype of the saved features")
    parser.add_argument("--chunk", type=int, default=32,
                        help="tiles per device pass (each tile is K+1 encoder inputs)")
    parser.add_argument("--log-dir", default="./logs/temp", type=str)
    parser.add_argument("--out", type=str, help="output dir (default <log_dir>/features)")

    # The port's own
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


if __name__ == "__main__":
    main()
