"""HookNet fine-tuning CLI of the port (from ``tools/ssl_finetune.py``).

    python -m msfwsi_tpu_torch.ssl_finetune -b 64 --epochs 50 --lr 1e-3 --seed 3407 \\
        --data-name bcss --train-data ../data/bcss/L0_1024_s512 --amp \\
        --weights logs/bcss/fold_0/checkpoint_0499.pth.tar --fold 0 --log-dir logs/ft

Every flag of the JAX CLI's parser is here with its default, so the
fine-tuning commands of ``scripts/{bcss,paip,c16}.sh`` run verbatim with
``python -m msfwsi_tpu_torch.ssl_finetune`` in place of ``python
tools/ssl_finetune.py``. Flags kept only for parity with the reference's
DDP/CUDA runtime are logged as inert; ``--packed-tail`` (a TPU layout of
the decoder, exact with the same weights) is accepted and the decoder is
computed unpacked; a value the port cannot honour yet raises, naming the
``ROADMAP.md`` queue item that ports it. ``--device`` (``cuda`` by default)
is the port's own: without a card the CLI raises unless given ``--device
cpu``.

``--weights`` takes an SSL checkpoint of the port (or the reference), whose
two encoders become the HookNet branch encoders. Each epoch trains on the
fold's tiles with the fused step (on-device views + train step; the view
generator is seeded per ``(seed, epoch, step)``), then validates slide by
slide and keeps ``best_ft_model.pth.tar`` on the best validation micro
F1. The step's metrics are fetched once per print window.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import os
import random
import sys
import time

import numpy as np
import torch

from . import resolve_device
from .data import datasets as D
from .data.loader import TileBatchLoader, load_slide_arrays, synthetic_tile_library
from .data.pipeline import AugConfig, make_seg_val_views_host
from .ops import metrics as M
from .ssl_train import NOOP_FLAGS, _trackers, add_error_capture, warn_noop_flags
from .train import checkpoint as C
from .train import evaluate as EV
from .train import finetune as FT
from .train.ssl import view_seed
from .utils import (AverageMeter, BestRecorder, ProgressMeter, close_logger, dump_config,
                    increment_path, setup_logger)

__all__ = ["build_parser", "main", "check_norm_stats"]

FT_NOOP_FLAGS = {k: NOOP_FLAGS[k] for k in (
    "world_size", "rank", "dist_url", "dist_backend", "gpu", "multiprocessing_distributed",
    "workers", "tf32", "bf16")}
CLASS_NAMES = {"bcss": FT.BCSS_CLASSES, "paip": FT.PAIP_CLASSES}


def _unsupported(args) -> list[str]:
    """Flag values the port cannot honour yet, each with its queue item of
    ``ROADMAP.md``."""
    checks = (
        (args.accum_steps > 1, f"--accum-steps {args.accum_steps}", FT.ACCUM_NOT_PORTED),
        (args.world_size > 1, f"--world-size {args.world_size}",
         "not ported yet, ROADMAP.md queue 1, distributed"),
    )
    return [f"{flag}: {why}" for bad, flag, why in checks if bad]


def check_norm_stats(args, weights_path: str, logger) -> None:
    """Warn when ``--mean``/``--std`` differ from those of the SSL run that
    wrote ``weights_path``, read from the ``configs.txt`` beside it (or one
    directory up): scoring with other normalization stats silently degrades
    results. A warning only, since stats may rightly differ for weights
    moved out of their run directory."""
    d = weights_path if os.path.isdir(weights_path) else os.path.dirname(weights_path)
    cfg_path = os.path.join(d, "configs.txt")
    if not os.path.exists(cfg_path):
        cfg_path = os.path.join(os.path.dirname(d.rstrip("/")), "configs.txt")
        if not os.path.exists(cfg_path):
            return
    trained = {}
    try:
        with open(cfg_path) as f:
            for line in f:
                key, _, val = line.partition(":")
                if key.strip() in ("mean", "std"):
                    trained[key.strip()] = ast.literal_eval(val.strip())
    except (OSError, ValueError, SyntaxError):
        return
    for key in ("mean", "std"):
        want, got = trained.get(key), getattr(args, key, None)
        if want is None or got is None:
            continue
        if any(abs(a - b) > 1e-6 for a, b in zip(want, list(got))):
            logger.warning(
                f"=> --{key} {list(got)} differs from the checkpoint's training run ({want}, "
                f"from {cfg_path}). Mismatched normalization silently degrades scores: pass "
                f"--{key} {' '.join(str(v) for v in want)} unless you know the stats changed.")


def main(argv=None) -> dict:
    """Run the CLI on ``argv``. Returns the run's log dir, its per-epoch
    records (``loss``, ``train_f1``, ``val_f1``/``val_iou``/``val_acc``
    micro, ``steps``, ``seconds``: the training part's wall time up to its
    metrics fetch, ``fill_seconds``: the wait for the first batch within
    it, ``val_seconds``), the best scores, the last validation summary and
    the final train state."""
    parser = build_parser()
    args = parser.parse_args(argv)
    problems = _unsupported(args)
    if problems:
        raise ValueError("; ".join(problems))
    dev = resolve_device(args.device)
    args.log_dir = str(increment_path(args.log_dir, sep="_", mkdir=True))
    if args.seed is not None:
        random.seed(args.seed)
        np.random.seed(args.seed)
    dump_config(args.log_dir, args)
    defaults = {a.dest: a.default for a in parser._actions}
    cmdline = " ".join([sys.executable, "-m", __spec__.name,
                        *(sys.argv[1:] if argv is None else argv)])
    return add_error_capture(args.log_dir)(main_worker)(args, dev, defaults, cmdline)


def main_worker(args, dev, defaults, cmdline: str) -> dict:
    logger = setup_logger(args.log_dir, name="MSF-WSI")
    try:
        return _finetune(args, dev, defaults, cmdline, logger)
    finally:
        close_logger(logger)


def _data(args, class_names, logger):
    """(root, train records, load_fn, val slide iterator factory)."""
    if args.synthetic:
        imgs, masks, slide_ids = synthetic_tile_library(
            n_slides=4, tiles_per_slide=args.synthetic, tile_size=4 * args.seg_size,
            num_classes=len(class_names))
        train = [i for i in range(len(imgs)) if slide_ids[i] % 4 != 0]
        val = [i for i in range(len(imgs)) if slide_ids[i] % 4 == 0]

        def val_slides():
            yield imgs[val], masks[val]

        return "<synthetic>", train, lambda i: (imgs[i], masks[i]), val_slides
    root = args.train_data
    if args.data_name == "bcss":
        samples = D.bcss_seg_samples(root, fold=args.fold, frac=args.frac)
        groups = D.bcss_seg_val_slides(root, fold=args.fold)
    else:
        samples = D.paip_seg_samples(root, fold=args.fold, frac=args.frac)
        groups = D.paip_seg_val_slides(root, fold=args.fold)
    train = [(s.img, s.mask) for s in samples]
    load_fn = None  # (image, mask) path pairs: the loader decodes both natively
    if args.packed_cache:
        from .data.packed import get_or_build_pack

        logger.info(f"=> building/opening packed tile caches ({len(train)} tiles and masks)")
        img_pack = get_or_build_pack(root, [r[0] for r in train], args.packed_cache)
        mask_pack = get_or_build_pack(root, [r[1] for r in train], args.packed_cache)

        def load_fn(rec):
            return img_pack.load(rec[0]), mask_pack.load(rec[1])

        logger.info("=> streaming raw tiles and masks from the packed cache (no decode)")

    def val_slides():
        for g in groups:
            yield load_slide_arrays(root, g)

    logger.info(f"=> validation slides: {len(groups)}")
    return root, train, load_fn, val_slides


def _drain(pending, losses, stats) -> None:
    """Fetch the pending steps' metrics in one device-to-host copy (float64
    holds the counts exactly) and update the loss meter and the per-sample
    count lists. A step's batch may be the epoch's short last one."""
    if not pending:
        return
    flat = torch.cat([torch.cat([m["loss"].double().view(1)]
                                + [m[k].double().reshape(-1) for k in ("tp", "fp", "fn", "tn")])
                      for m in pending]).cpu().numpy()
    off = 0
    for m in pending:
        shape = tuple(m["tp"].shape)  # (batch, classes) of this step
        n = 1 + 4 * shape[0] * shape[1]
        row = flat[off : off + n]
        off += n
        losses.update(float(row[0]), shape[0])
        for lst, c in zip(stats, row[1:].reshape(4, *shape).astype(np.int64)):
            lst.append(c)
    pending.clear()


def _finetune(args, dev, defaults, cmdline: str, logger) -> dict:
    logger.info(cmdline)
    warn_noop_flags(logger, args, defaults, FT_NOOP_FLAGS)
    if args.packed_tail:
        logger.info("=> flag --packed-tail accepted for parity but inert: the port computes the "
                    "decoder unpacked (the packed tail is a TPU layout, exact with the same "
                    "weights)")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    logger.info(f"=> device {dev} ({name})")
    if args.data_name not in CLASS_NAMES:
        raise ValueError(f"unsupported --data-name {args.data_name!r} (bcss or paip)")
    class_names = CLASS_NAMES[args.data_name]

    config = FT.FinetuneConfig(
        arch=args.arch, class_names=tuple(class_names), batch_size=args.batch_size,
        lr=args.lr, lam=args.lam, amp=args.amp, seed=args.seed if args.seed is not None else 0,
        accum_steps=args.accum_steps,
    )
    logger.info(f"=> creating model '{args.arch}' ({config.num_classes} classes incl. bg)")
    logger.info(f"=> scale lr from {args.lr:.4f} to {config.init_lr:.4f}")
    state = FT.create_finetune_state(config, device=dev)
    if args.weights:
        resolved = C.resolve_checkpoint_arg(args.weights)
        if resolved is None:
            logger.warning("=> Invalid model weights!")
            raise FileNotFoundError(f"--weights {args.weights}: no such file")
        check_norm_stats(args, resolved, logger)
        state = FT.load_ssl_encoders(state, C.load_torch_file(resolved), config)
        logger.info(f"=> loaded pretrained weights {resolved} into encoders")
    tb_writer, wandb_run = _trackers(args, logger, job_type="fine-tune")

    aug_cfg = AugConfig(mean=tuple(args.mean), std=tuple(args.std), seg_size=args.seg_size,
                        compute_dtype="bfloat16" if args.amp else "float32")
    root, train_recs, load_fn, val_slides = _data(args, class_names, logger)
    # The reference keeps the last partial batch (drop_last=False,
    # ssl_finetune.py:276); on one device it is genuinely short.
    loader = TileBatchLoader(root, train_recs, batch_size=args.batch_size, load_fn=load_fn,
                             seed=config.seed, drop_last=False, device=dev)
    logger.info(f"=> train tiles: {len(train_recs)}, steps/epoch: {len(loader)}")
    if len(loader) == 0:
        raise ValueError(f"no training tiles in {root}")

    step_fn = FT.make_fused_finetune_step(config, aug_cfg, device=dev)
    gen = torch.Generator(device=dev)
    chunk_stats = EV.make_chunk_stats_for_views(state.model, len(class_names), args.val_views,
                                                cfg=aug_cfg, amp=args.amp)
    # Evaluation views are deterministic: in host mode the uint8 views are
    # kept after the first pass, so later epochs skip the decode and resize
    # (--no-val-cache decodes every epoch, as the reference's DataLoader).
    val_view_cache: list = []

    def host_view_slides():
        if val_view_cache:
            yield from val_view_cache
            return
        for imgs_s, masks_s in val_slides():
            views = make_seg_val_views_host(imgs_s, masks_s, aug_cfg)
            if not args.no_val_cache:
                val_view_cache.append(views)
            yield views

    def run_validation():
        slides = host_view_slides() if args.val_views == "host" else val_slides()
        return EV.validate_slides(chunk_stats, slides, args.val_views, class_names,
                                  chunk=args.val_chunk, device=dev).summary()

    recorders = {k: BestRecorder("max") for k in ("f1", "iou", "acc")}
    raw_recorders = {m: {c: BestRecorder("max") for c in class_names}
                     for m in ("f1", "iou", "acc")}
    history, summary = [], None
    for epoch in range(args.epochs):
        start = time.time()
        losses = AverageMeter("Loss", ":.4f")
        batch_time = AverageMeter("Time", ":6.3f")
        progress = ProgressMeter(len(loader), [batch_time, losses],
                                 prefix=f"Train epoch: [{epoch}]")
        stats: tuple[list, list, list, list] = ([], [], [], [])
        pending = []  # the steps' metrics, small device tensors
        fill, steps = 0.0, 0
        end = time.time()
        with contextlib.closing(loader.epoch(epoch)) as batches:
            for it, (bimgs, bmasks) in enumerate(batches):
                if it == 0:
                    fill = time.time() - start
                gen.manual_seed(view_seed(config.seed, epoch, it))
                pending.append(step_fn(state, bimgs, bmasks, gen))
                steps += 1
                batch_time.update(time.time() - end)
                end = time.time()
                if it % args.print_freq == 0:
                    _drain(pending, losses, stats)
                    logger.info(progress.display(it))
                if args.steps_per_epoch and steps >= args.steps_per_epoch:
                    break
        _drain(pending, losses, stats)
        seconds = time.time() - start
        train_f1 = float(M.f1_score(*(np.concatenate(s) for s in stats),
                                    reduction="micro-imagewise"))

        t_val = time.time()
        summary = run_validation()
        val_seconds = time.time() - t_val
        best_f1, is_best = recorders["f1"].update(summary["f1_micro"])
        best_iou, _ = recorders["iou"].update(summary["iou_micro"])
        best_acc, _ = recorders["acc"].update(summary["acc_micro"])
        for m in ("f1", "iou", "acc"):
            for c in class_names:
                raw_recorders[m][c].update(summary[f"{m}_{c}"])
        if tb_writer is not None:
            tb_writer.add_scalar("train/loss", losses.avg, epoch)
            tb_writer.add_scalars("train/f1", {"micro": train_f1}, epoch)
            for m in ("f1", "iou", "acc"):
                tb_writer.add_scalars(f"val/{m}", {"micro": summary[f"{m}_micro"]}, epoch)
        if wandb_run is not None:
            wandb_run.log({"train_f1_micro": train_f1, "val_f1_micro": summary["f1_micro"]})
            wandb_run.summary["best_val_f1_micro"] = best_f1
        if is_best:
            C.save_best_ft_model(args.log_dir, state.model, epoch, args.arch)
            logger.info(f"=> Best model saved at epoch {epoch}!")
        history.append({"epoch": epoch, "loss": losses.avg, "train_f1": train_f1,
                         "val_f1": summary["f1_micro"], "val_iou": summary["iou_micro"],
                         "val_acc": summary["acc_micro"], "steps": steps, "seconds": seconds,
                         "fill_seconds": fill, "val_seconds": val_seconds, "is_best": is_best})
        logger.info(
            "=======\n"
            f"TIME: {(time.time() - start) / 60:.2f} mins, LOSS: {losses.avg:.4f}\n"
            f"MICRO F1: {train_f1:.4f}/{summary['f1_micro']:.4f}/{best_f1:.4f}\n"
            f"MICRO IOU: {summary['iou_micro']:.4f}/{best_iou:.4f}\n"
            f"MICRO ACC: {summary['acc_micro']:.4f}/{best_acc:.4f}\n"
            "=======")

    logger.info("=> Best scores:")
    logger.info("=======\n"
                f"MICRO F1: {recorders['f1'].best:.4f}\n"
                f"MICRO IOU: {recorders['iou'].best:.4f}\n"
                f"MICRO ACC: {recorders['acc'].best:.4f}\n")
    for c in class_names:
        logger.info(f"{c} F1: {raw_recorders['f1'][c].best:.4f}, "
                    f"IOU: {raw_recorders['iou'][c].best:.4f}, "
                    f"ACC: {raw_recorders['acc'][c].best:.4f}")
    if tb_writer is not None:
        tb_writer.close()
    if wandb_run is not None:
        wandb_run.finish()
    return {"log_dir": args.log_dir, "epochs": history, "summary": summary,
            "best": {k: r.best for k, r in recorders.items()}, "state": state}


def build_parser():
    parser = argparse.ArgumentParser(description="MSF-WSI fine-tuning (PyTorch port)")
    parser.add_argument("-a", "--arch", default="resnet18")
    parser.add_argument("-b", "--batch-size", default=64, type=int)
    parser.add_argument("-j", "--workers", default=4, type=int)
    parser.add_argument("-p", "--print-freq", default=50, type=int)
    parser.add_argument("--epochs", default=50, type=int)
    parser.add_argument("--lr", default=1e-3, type=float)
    parser.add_argument("--world-size", default=-1, type=int)
    parser.add_argument("--rank", default=-1, type=int)
    parser.add_argument("--dist-url", default="", type=str)
    parser.add_argument("--dist-backend", default="nccl", type=str)
    parser.add_argument("--seed", type=int)
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
    parser.add_argument("--run-group", default=None, type=str)
    parser.add_argument("--run-tag", nargs="*", default=None, type=str)
    parser.add_argument("--run-name", default=None, type=str)
    parser.add_argument("--run-notes", default="MSF-WSI/TPU training", type=str)

    parser.add_argument("--tf32", action="store_true")
    parser.add_argument("--amp", action="store_true")
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--weights", type=str)
    parser.add_argument("--frac", type=float, default=1)
    parser.add_argument("--lam", type=float, default=1)

    # Extras of the JAX CLI (not in the reference)
    parser.add_argument("--packed-tail", action=argparse.BooleanOptionalAction, default=True,
                        help="accepted for parity; the port computes the decoder unpacked "
                        "(exact, the same weights)")
    parser.add_argument("--accum-steps", type=int, default=1,
                        help="gradient accumulation; the port has 1 only")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="fine-tune on 4 in-memory synthetic slides of N tiles each, "
                        "slide 0 for validation (smoke mode)")
    parser.add_argument("--val-chunk", type=int, default=128,
                        help="tiles per device pass during validation (reference: 128)")
    parser.add_argument("--val-views", choices=("host", "device"), default="host",
                        help="where evaluation views are built: 'host' = uint8 resize/crop on "
                        "the CPU, normalize on the device (the reference's split); 'device' = "
                        "raw tiles to the device, views built there")
    parser.add_argument("--no-val-cache", action="store_true",
                        help="decode the validation slides every epoch (by default the host "
                        "views are kept after the first validation)")
    parser.add_argument("--steps-per-epoch", type=int, default=0,
                        help="cap steps per epoch (0 = full epoch)")
    parser.add_argument("--seg-size", type=int, default=256,
                        help="context/target view size (reference: 256)")
    parser.add_argument("--packed-cache", type=str, default="",
                        help="directory for decode-once uint8 packs of the tiles and masks")

    # The port's own
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


if __name__ == "__main__":
    main()
