"""Evaluation CLI of the port (from ``tools/evaluate.py``): load a
fine-tuned HookNet, run the per-slide validation once, log micro and
per-class F1 / IoU / accuracy.

    python -m msfwsi_tpu_torch.evaluate -a resnet18 --data-name paip \\
        --train-data ../data/paip/L0_1024_s512 --weights logs/ft/best_ft_model.pth.tar \\
        --amp --fold 0 --log-dir logs/eval

Every flag of the JAX CLI's parser is here with its default, so the
evaluation commands of ``scripts/paip.sh`` run verbatim with ``python -m
msfwsi_tpu_torch.evaluate``; the DDP flags and the reference's unused
``--frac``/``--lam``/``--weight-name`` are logged as inert. ``--device``
(``cuda`` by default) is the port's own.

``--weights`` is a ``.pth.tar`` (``best_ft_model.pth.tar`` of the port's
or the reference's fine-tuning). An Orbax directory of the JAX package
raises, naming ``tools/export_torch.py``, which converts it. The views
are fp32, as the JAX CLI's are; ``--amp`` runs the model in bf16 autocast.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import _cli
from .data import datasets as D
from .data.loader import load_slide_arrays, synthetic_tile_library
from .data.pipeline import AugConfig, make_seg_val_views_host
from .models.hooknet import HookNet
from .ssl_finetune import CLASS_NAMES, FT_NOOP_FLAGS, check_norm_stats
from .ssl_train import warn_noop_flags
from .train import checkpoint as C
from .train import evaluate as EV

__all__ = ["build_parser", "main", "main_worker", "load_hooknet", "eval_aug_config"]

EVAL_NOOP_FLAGS = {
    **FT_NOOP_FLAGS,
    "frac": "the reference evaluator parses --frac but never uses it",
    "lam": "the reference evaluator parses --lam but never uses it",
    "weight_name": "the reference evaluator parses --weight-name but never uses it",
}


def load_hooknet(weights: str | None, arch: str, num_classes: int, dev, args, logger) -> HookNet:
    """A fine-tuned HookNet from ``weights`` (a ``.pth.tar``) on ``dev``,
    after the normalization-stats check against its run's ``configs.txt``."""
    if not weights:
        raise ValueError("--weights is required: a fine-tuned HookNet .pth.tar")
    resolved = C.resolve_checkpoint_arg(weights)
    if resolved is None:
        logger.error(f"=> weights not found: {weights}")
        raise FileNotFoundError(f"--weights {weights}: no such file")
    check_norm_stats(args, resolved, logger)
    model = C.load_ft_model(resolved, HookNet(arch=arch, classes=num_classes))
    return model.to(dev).eval()


def eval_aug_config(args) -> AugConfig:
    """The evaluation views' config: fp32 views whatever ``--amp`` says
    (``tools/evaluate.py`` and ``tools/predict.py`` build the default
    ``AugConfig``); only the model runs in bf16."""
    return AugConfig(mean=tuple(args.mean), std=tuple(args.std), seg_size=args.seg_size)


def main(argv=None) -> dict:
    """Run the CLI on ``argv``. Returns the log dir, the summary (micro
    scores' means over slides, per-class means) and each slide's micro
    scores and (4, C) tp/fp/fn/tn counts."""
    parser = build_parser()
    args, dev, defaults = _cli.start(parser, argv)
    return _cli.run(args, argv, __spec__.name,
                    lambda logger: main_worker(args, dev, defaults, logger))


def main_worker(args, dev, defaults, logger) -> dict:
    warn_noop_flags(logger, args, defaults, EVAL_NOOP_FLAGS)
    if args.packed_tail:
        logger.info("=> flag --packed-tail accepted for parity but inert: the port computes the "
                    "decoder unpacked (exact with the same weights)")
    if args.data_name not in CLASS_NAMES:
        raise ValueError(f"unsupported --data-name {args.data_name!r} (bcss or paip)")
    class_names = CLASS_NAMES[args.data_name]
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    logger.info(f"=> device {dev} ({name})")
    logger.info(f"=> creating model '{args.arch}'")
    logger.info(f"=> loading pretrained weights {args.weights}")
    model = load_hooknet(args.weights, args.arch, len(class_names) + 1, dev, args, logger)
    logger.info(f"=> loaded pretrained weights {args.weights}")
    aug_cfg = eval_aug_config(args)

    if args.synthetic:
        imgs, masks, slide_ids = synthetic_tile_library(
            n_slides=2, tiles_per_slide=args.synthetic, tile_size=4 * args.seg_size,
            num_classes=len(class_names))

        def raw_slides():
            for s in np.unique(slide_ids):
                ids = np.nonzero(slide_ids == s)[0]
                yield imgs[ids], masks[ids]
    else:
        root = args.train_data
        groups = (D.bcss_seg_val_slides(root, fold=args.fold) if args.data_name == "bcss"
                  else D.paip_seg_val_slides(root, fold=args.fold))
        logger.info(f"=> validation slides: {len(groups)}")

        def raw_slides():
            for g in groups:
                yield load_slide_arrays(root, g)

    if args.val_views == "host":
        def slides():
            for imgs_s, masks_s in raw_slides():
                yield make_seg_val_views_host(imgs_s, masks_s, aug_cfg)
    else:
        slides = raw_slides
    chunk_stats = EV.make_chunk_stats_for_views(model, len(class_names), args.val_views,
                                                cfg=aug_cfg, amp=args.amp)

    def log_slide(i, micro):
        if i % args.print_freq == 0:
            logger.info(f"Val slide [{i}] f1={micro['f1']:.4f}")

    scores = EV.validate_slides(chunk_stats, slides(), args.val_views, class_names,
                                chunk=args.val_chunk, device=dev, on_slide=log_slide)
    s = scores.summary()
    logger.info("=> Best scores:")
    logger.info("=======\n"
                f"MICRO F1: {s['f1_micro']:.4f}\n"
                f"MICRO IOU: {s['iou_micro']:.4f}\n"
                f"MICRO ACC: {s['acc_micro']:.4f}\n")
    for c in class_names:
        logger.info(f"{c} F1: {s[f'f1_{c}']:.4f}, IOU: {s[f'iou_{c}']:.4f}, "
                    f"ACC: {s[f'acc_{c}']:.4f}")
    per_slide = [{"micro": {k: v[i] for k, v in scores.micro.items()}, "counts": counts}
                 for i, counts in enumerate(scores.counts)]
    return {"log_dir": args.log_dir, "summary": s, "slides": per_slide}


def build_parser():
    parser = argparse.ArgumentParser(description="MSF-WSI evaluation (PyTorch port)")
    parser.add_argument("-a", "--arch", default="resnet18")
    parser.add_argument("-b", "--batch-size", default=64, type=int)
    parser.add_argument("-j", "--workers", default=4, type=int)
    parser.add_argument("-p", "--print-freq", default=50, type=int)
    parser.add_argument("--world-size", default=-1, type=int)
    parser.add_argument("--rank", default=-1, type=int)
    parser.add_argument("--dist-url", default="", type=str)
    parser.add_argument("--dist-backend", default="nccl", type=str)
    parser.add_argument("--seed", default=3407, type=int)
    parser.add_argument("--gpu", default=None, type=int)
    parser.add_argument("--multiprocessing-distributed", action="store_true")

    parser.add_argument("--data-name", type=str, default="bcss")
    parser.add_argument("--train-data", type=str)
    parser.add_argument("--mean", nargs=3, type=float, default=[0.485, 0.456, 0.406])
    parser.add_argument("--std", nargs=3, type=float, default=[0.229, 0.224, 0.225])
    parser.add_argument("--fold", type=int, default=0)

    parser.add_argument("--log-dir", default="./logs/temp", type=str)
    parser.add_argument("--tensorboard", action="store_true")
    parser.add_argument("--wandb", action="store_true")

    parser.add_argument("--tf32", action="store_true")
    parser.add_argument("--amp", action="store_true")
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--weights", type=str)
    parser.add_argument("--weight-name", type=str,
                        help="parsed but unused, as in the reference (evaluate.py:447)")
    parser.add_argument("--frac", type=float, default=1,
                        help="parsed but unused, as in the reference (evaluate.py:446)")
    parser.add_argument("--lam", type=float, default=1,
                        help="parsed but unused, as in the reference (evaluate.py:448)")

    parser.add_argument("--synthetic", type=int, default=0)
    parser.add_argument("--packed-tail", action=argparse.BooleanOptionalAction, default=False,
                        help="accepted for parity; the port computes the decoder unpacked "
                        "(exact, the same weights)")
    parser.add_argument("--val-chunk", type=int, default=128,
                        help="tiles per device pass during validation (reference: 128)")
    parser.add_argument("--val-views", choices=("host", "device"), default="host",
                        help="where evaluation views are built: 'host' = uint8 resize/crop on "
                        "the CPU, normalize on the device (the reference's split); 'device' = "
                        "raw tiles to the device, views built there")
    parser.add_argument("--seg-size", type=int, default=256,
                        help="context/target view size (reference: 256)")

    # The port's own
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


if __name__ == "__main__":
    main()
