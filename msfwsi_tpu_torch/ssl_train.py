"""SSL pre-training CLI of the port (from ``tools/ssl_train.py``).

    python -m msfwsi_tpu_torch.ssl_train -a resnet18 -b 32 --epochs 500 \\
        --data-name bcss --data ../data/bcss/L0_1024_s512 --amp --log-dir logs/bcss

Every flag of the JAX CLI's parser is here with its default, so the
pretrain commands of ``scripts/{bcss,paip,c16}.sh`` run verbatim with
``python -m msfwsi_tpu_torch.ssl_train`` in place of ``python
tools/ssl_train.py``. Flags kept only for parity with the reference's
runtime (``--gpu``, ``--workers``, ...) are logged as inert. ``--device``
(``cuda`` by default) is the port's own: without a card the CLI raises
unless given ``--device cpu``.

Distributed runs take the reference's flags with the reference's meaning
(``parallel/mesh.py::plan_launch``): ``--multiprocessing-distributed``
spawns one process per visible card, ``--world-size`` then counting nodes
and ``--rank`` naming this one (the recipes' ``--multiprocessing-distributed
--world-size 1 --rank 0`` forms a group of the node's cards); without it,
``--world-size N --rank R --dist-url URL`` makes this process rank R of N.
``torchrun --nproc-per-node N -m msfwsi_tpu_torch.ssl_train ...`` works
too. The backend is ``--dist-backend`` (``nccl``) on the card and gloo with
``--device cpu``, where a process stands for a card:
``--multiprocessing-distributed --world-size N --device cpu`` spawns N
processes on this host. ``-b`` is the global batch, split over the
``"data"`` ranks; ``--model-parallel M`` splits the fuser heads over groups
of M adjacent ranks (``parallel/tp.py``), for a head and optimizer state
that do not fit one card (plain Adam at resnet50 ``-b 32``). Rank 0 alone
writes checkpoints, ``configs.txt``, TensorBoard and wandb; each rank logs
to ``log.txt`` (rank 0) or ``log.txt.rank{N}``.

Tiles are read from disk (BCSS, PAIP, Camelyon16 manifests; PNG decoded by
the port's decoder, or raw bytes from ``--packed-cache``) or made in memory
(``--synthetic N``), fed to the card by :class:`~.data.loader.TileBatchLoader`
and trained on by the fused step (on-device views + train step). The view
generator is seeded per ``(seed, epoch, step)``, so a resumed run draws the
views an uninterrupted one drew. A run writes ``configs.txt``, ``log.txt``,
``error.txt`` on a crash, and ``checkpoint_{epoch:04d}.pth.tar`` every
``--save-freq`` epochs; ``--resume`` restores weights, BatchNorm
statistics and the optimizer's state. The large-model memory path is the
JAX CLI's: ``--inter-opt adafactor|fused_adafactor``, ``--inter-dtype
bfloat16``, ``--accum-steps N`` (N must divide ``-b``), ``--use-ac`` and
``--remat-stages``.

The loop makes no host sync per step: the epoch's loss is one
device-to-host fetch of the stacked step losses at the epoch's end.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import re
import shutil
import time

import numpy as np
import torch

from . import _cli
from ._cli import group_info, warn_noop_flags
from .data import datasets as D
from .data.loader import TileBatchLoader, synthetic_tile_library
from .data.pipeline import AugConfig
from .parallel.mesh import Mesh
from .train import checkpoint as C
from .train.ssl import (SSLConfig, create_ssl_state, load_imagenet_encoders, make_fused_step,
                        view_seed)
from .utils import AverageMeter, ProgressMeter, increment_path
from .utils.imagenet import resolve_imagenet_weights, search_dirs

__all__ = ["build_parser", "main"]

# Flags kept for parity with the reference's DDP/CUDA runtime that change
# nothing here; each is logged once when set to a non-default value.
NOOP_FLAGS = {
    "gpu": "the device comes from --device (and each worker's card from its local rank)",
    "workers": "the loader decodes with a thread pool of its own",
    "tf32": "under --amp the step computes in bf16; TF32 keeps PyTorch's defaults",
    "bf16": "bf16 is the autocast dtype whenever --amp is set",
    "wd": "parsed but unused, as in the reference (Adam without weight decay)",
    "dim": "unused by the model, as in the JAX package (heads keep each scale's width)",
    "pred_dim": "unused by the model, as in the JAX package (predictor hidden = width // 4)",
}


def main(argv=None) -> dict:
    """Run the CLI on ``argv``. Returns the run's log dir, its per-epoch
    records (``loss``, ``steps``, ``seconds``: the epoch's wall time up to
    its loss fetch, ``fill_seconds``: the part of it spent waiting for the
    first batch, which no step overlaps), the best loss and the final
    train state; None after a spawn, each worker's records staying in its
    process."""
    return _cli.launch(build_parser(), argv, __spec__.name, _train)


def _files(args, seed: int, logger):
    """(root, files, load_fn, camelyon manifest or None) of the run."""
    if args.synthetic:
        imgs, _, _ = synthetic_tile_library(n_slides=1, tiles_per_slide=args.synthetic,
                                            tile_size=args.tile_px * args.scale)
        return "<synthetic>", list(range(len(imgs))), imgs.__getitem__, None
    if args.data_name == "bcss":
        return args.data, D.bcss_pretrain_files(args.data, fold=args.fold), None, None
    if args.data_name == "paip":
        return args.data, D.paip_pretrain_files(args.data, fold=args.fold), None, None
    if args.data_name == "camelyon16":
        camelyon = D.Camelyon16Manifest(args.data, mode=args.c16_mode, seed=seed)
        return args.data, camelyon.resample(0), None, camelyon
    logger.error("Unsupported dataset!")
    raise ValueError(f"unsupported --data-name {args.data_name!r} (bcss, paip or camelyon16)")


def _train(args, dev, defaults, logger, mesh: Mesh) -> dict:
    warn_noop_flags(logger, args, defaults, NOOP_FLAGS)
    if args.amp:
        logger.info("=> bf16 autocast enabled (no GradScaler needed)")

    config = SSLConfig(
        arch=args.arch, batch_size=args.batch_size, lr=args.lr, mask_ratio=args.mask_ratio,
        scale=args.scale, ms_lr=tuple(args.ms_lr), fuser_weights=tuple(args.fuser_weights),
        seed=args.seed if args.seed is not None else 0, amp=args.amp,
        inter_opt=args.inter_opt, inter_dtype=args.inter_dtype, accum_steps=args.accum_steps,
        use_ac=args.use_ac, remat_stages=tuple(args.remat_stages) if args.remat_stages else None,
    )
    logger.info(f"=> creating model '{args.arch}' (scale={args.scale}, K={config.scale**2})")
    logger.info(f"=> fuser heads: {args.inter_opt}, {args.inter_dtype}; accum_steps "
                f"{args.accum_steps}; activation checkpointing "
                + (f"on (stages {config.remat_stages or 'all'})" if args.use_ac else "off"))
    logger.info(f"=> use init_lr of {config.init_lr:.4f} (sqrt-batch scaling)")
    aug_cfg = AugConfig(
        mean=tuple(args.mean), std=tuple(args.std), img_size=args.img_sz, grid=args.scale,
        tile_px=args.tile_px, compute_dtype="bfloat16" if args.amp else "float32",
    )

    # ---- data -----------------------------------------------------------
    root, files, load_fn, camelyon = _files(args, config.seed, logger)
    if args.quick_test:
        files = files[:7680]
    if args.packed_cache and not args.synthetic:
        from .data.packed import get_or_build_pack

        # Camelyon16 packs its whole candidate pool once; each epoch's
        # resample then indexes into the pack by path.
        pool = (sorted(f for fs in camelyon.all_data.values() for f in fs)
                if camelyon is not None else files)
        logger.info(f"=> building/opening packed tile cache ({len(pool)} tiles)")
        load_fn = get_or_build_pack(root, pool, args.packed_cache).load
        logger.info("=> streaming raw tiles from the packed cache (no decode)")
    # The global batch divided over the data ranks, each loading its strided
    # shard of the files (the JAX CLI's per-host split, tools/ssl_train.py:168).
    loader = TileBatchLoader(root, files, batch_size=args.batch_size // mesh.data,
                             load_fn=load_fn, seed=config.seed, rank=mesh.data_rank,
                             world_size=mesh.data, device=dev)
    logger.info(f"=> Size of data: {len(files)}, steps per epoch: {len(loader)}")

    # ---- state ----------------------------------------------------------
    # Under --model-parallel the fuser heads are born split: no rank holds
    # a whole head or its optimizer state.
    state = create_ssl_state(config, device=dev, mesh=mesh if mesh.world > 1 else None)
    if mesh.model > 1:
        logger.info(f"=> fuser heads tensor-parallel over {mesh.model} ranks")
    # ImageNet init is the reference default (backbone.py:58-63);
    # --imagenet-weights none opts out.
    if args.imagenet_weights != "none":
        explicit = "" if args.imagenet_weights == "auto" else args.imagenet_weights
        weights_path = resolve_imagenet_weights(config.arch, explicit)
        if weights_path is not None:
            state = load_imagenet_encoders(state, C.load_torch_file(weights_path, dev), config)
            logger.info(f"=> initialized encoders from ImageNet weights {weights_path}")
        else:
            msg = (
                f"ImageNet weights for {config.arch} not found locally (the port does not "
                f"download). The reference always pretrains from torchvision "
                f"pretrained=True (backbone.py:58-63); place the .pth in $MSFWSI_IMAGENET_DIR "
                f"(searched: {search_dirs()}), pass --imagenet-weights <path>, or opt out "
                f"explicitly with --imagenet-weights none / --allow-random-init."
            )
            # Random init silently diverges from the published setup: fail
            # unless the user opted out (synthetic smoke mode implies it).
            if args.synthetic or args.allow_random_init:
                logger.warning(f"=> {msg} PRETRAINING FROM RANDOM INIT.")
            else:
                logger.error(f"=> {msg}")
                raise RuntimeError(msg)
    start_epoch = args.start_epoch
    if args.resume:
        resume = C.resolve_checkpoint_arg(args.resume)
        if resume is not None:
            logger.info(f"=> loading checkpoint '{resume}'")
            if not C.restore_checkpoint(resume, state, dev):
                logger.warning("=> torch-format resume restores weights/BN only; "
                               "optimizer state restarts")
            # The name carries the completed epoch (checkpoint_{epoch:04d},
            # ssl_train.py:385): right even when --steps-per-epoch capped
            # the earlier epochs.
            m = re.search(r"checkpoint_(\d+)", os.path.basename(os.path.normpath(resume)))
            if m:
                start_epoch = int(m.group(1)) + 1
            else:
                spe = (min(args.steps_per_epoch, len(loader)) if args.steps_per_epoch
                       else len(loader))
                start_epoch = state.step // max(1, spe)
            logger.info(f"=> loaded checkpoint (step {state.step}, epoch {start_epoch})")
        else:
            logger.info(f"=> no checkpoint found at '{args.resume}'")
    if camelyon is not None and start_epoch:
        # Epoch N trains on resample(N), as in the uninterrupted run.
        loader.files = camelyon.resample(start_epoch)
        logger.info(f"=> camelyon resampling rejoined at epoch {start_epoch}")

    step_fn = make_fused_step(config, aug_cfg, device=dev, mesh=state.mesh)
    gen = torch.Generator(device=dev)
    tb_writer, wandb_run = _trackers(args, logger) if mesh.is_main else (None, None)

    best_loss = 255.0
    history = []
    for epoch in range(start_epoch, args.epochs):
        start = time.time()
        batch_time = AverageMeter("Time", ":6.3f")
        data_time = AverageMeter("Data", ":6.3f")
        progress = ProgressMeter(len(loader), [batch_time, data_time], prefix=f"Epoch: [{epoch}]")
        logger.info(f"=> begin epoch {epoch}")

        prof = None
        if args.profile_steps and epoch == start_epoch:
            prof = _start_profiler(dev)
        pending = []  # device loss scalars, fetched once at the epoch's end
        fill = 0.0
        end = time.time()
        with contextlib.closing(loader.epoch(epoch)) as batches:
            for it, tiles in enumerate(batches):
                data_time.update(time.time() - end)
                if it == 0:
                    fill = time.time() - start
                gen.manual_seed(view_seed(config.seed, epoch, it))
                pending.append(step_fn(state, tiles, gen)["loss"])
                batch_time.update(time.time() - end)
                end = time.time()
                if it % args.print_freq == 0:
                    logger.info(progress.display(it))
                if prof is not None and len(pending) >= args.profile_steps:
                    _stop_profiler(prof, args.log_dir, logger)
                    prof = None
                if args.steps_per_epoch and len(pending) >= args.steps_per_epoch:
                    break
        if prof is not None:
            _stop_profiler(prof, args.log_dir, logger)

        losses = torch.stack(pending).tolist() if pending else []  # the one fetch
        loss = float(np.mean(losses)) if losses else float("nan")
        seconds = time.time() - start
        # The reference computes is_best but saves pretrain checkpoints with
        # is_best=False: best_loss is for the log only.
        best_loss = min(loss, best_loss)
        history.append({"epoch": epoch, "loss": loss, "steps": len(pending), "seconds": seconds,
                        "fill_seconds": fill})

        if camelyon is not None:
            loader.files = camelyon.resample(epoch + 1)
            logger.info("=> reset dataset for next epoch!")
        if tb_writer is not None:
            tb_writer.add_scalar("train/loss", loss, epoch)
        if wandb_run is not None:
            wandb_run.log({"train_loss": loss})
            wandb_run.summary["train_loss"] = best_loss
        if (epoch + 1) % args.save_freq == 0:
            C.save_checkpoint(args.log_dir, state, epoch, args.arch)
            logger.info(f"=> Model saved at epoch {epoch}!")

        elapsed = (time.time() - start) / 60
        logger.info(
            f"======= TIME: {elapsed:.2f} mins, BEST LOSS: {loss:.4f}/{best_loss:.4f} ======="
        )

    if tb_writer is not None:
        tb_writer.close()
    if wandb_run is not None:
        log_txt = os.path.join(args.log_dir, "log.txt")
        if os.path.exists(log_txt):  # reference ssl_train.py:394-405
            shutil.copyfile(log_txt, os.path.join(wandb_run.dir, "train_output.log"))
        wandb_run.finish()
    return {"log_dir": args.log_dir, "start_epoch": start_epoch, "epochs": history,
            "best_loss": best_loss, "state": state, "process_group": group_info(mesh)}


def _trackers(args, logger, job_type: str = "pretrain"):
    """TensorBoard and wandb, each where requested and importable."""
    tb_writer = wandb_run = None
    if args.tensorboard:
        try:
            from torch.utils.tensorboard import SummaryWriter

            tb_writer = SummaryWriter(
                str(increment_path(f"{args.log_dir}/tb_log/exp", sep="_", mkdir=True)))
            logger.info("Initialise tensorboard logger successfully!")
        except ImportError as e:
            logger.info(f"=> tensorboard unavailable: {e}")
    if args.wandb:
        try:
            import wandb

            wandb_run = wandb.init(
                project="MSF-WSI Experiments", notes=args.run_notes, tags=args.run_tag,
                group=args.run_group, name=args.run_name, job_type=job_type,
                dir=args.log_dir, config=vars(args),
            )
            logger.info("=> initialise wandb logger successfully!")
        except ImportError as e:
            logger.info(f"=> wandb unavailable, continuing without it: {e}")
    return tb_writer, wandb_run


def _start_profiler(dev):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_profiler(prof, log_dir: str, logger) -> None:
    prof.stop()
    out = os.path.join(log_dir, "profile")
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, "trace.json"))
    logger.info(f"=> profiler trace written to {out}")


def build_parser():
    parser = argparse.ArgumentParser(description="MSF-WSI pre-training (PyTorch port)")
    parser.add_argument("-a", "--arch", default="resnet18")
    parser.add_argument("-b", "--batch-size", default=32, type=int)
    parser.add_argument("-j", "--workers", default=8, type=int)
    parser.add_argument("-p", "--print-freq", default=50, type=int)
    parser.add_argument("--lr", "--learning-rate", default=1e-3, type=float)
    parser.add_argument("--wd", "--weight-decay", default=1e-2, type=float,
                        help="parsed but unused, as in the reference (ssl_train.py:551,309)")
    parser.add_argument("--epochs", default=300, type=int)
    parser.add_argument("--start-epoch", default=0, type=int)
    parser.add_argument("--resume", default="", type=str)
    parser.add_argument("--world-size", default=-1, type=int)
    parser.add_argument("--rank", default=-1, type=int)
    parser.add_argument("--dist-url", default="", type=str)
    parser.add_argument("--dist-backend", default="nccl", type=str)
    parser.add_argument("--seed", default=3407, type=int)
    parser.add_argument("--gpu", default=None, type=int)
    parser.add_argument("--multiprocessing-distributed", action="store_true")

    # simsiam specific configs:
    parser.add_argument("--dim", default=2048, type=int)
    parser.add_argument("--pred-dim", default=512, type=int)

    # Data settings
    parser.add_argument("--data-name", type=str)
    parser.add_argument("--data", metavar="DIR", help="path to dataset")
    parser.add_argument("--inter-opt", type=str, default="adam",
                        choices=("adam", "adafactor", "fused_adafactor"),
                        help="fuser-head optimizer: adam (the reference's), adafactor, or "
                        "fused_adafactor (the big head weights updated from their gradient's "
                        "outer-product factors, no dense gradient)")
    parser.add_argument("--inter-dtype", type=str, default="float32",
                        choices=("float32", "bfloat16"),
                        help="fuser-head Linear storage dtype (their BatchNorm stays fp32)")
    parser.add_argument("--accum-steps", type=int, default=1,
                        help="gradient accumulation: sequential microbatches a step, one update "
                        "on their mean gradient; must divide --batch-size")
    parser.add_argument("--remat-stages", type=int, nargs="*", default=None,
                        help="with --use-ac: the encoder stages (1-4) to checkpoint (default: "
                        "all)")
    parser.add_argument("--c16-mode", type=str, default="train", choices=("train", "all"),
                        help="Camelyon16 slide pool: train = train_ids only (reference CLI "
                        "default), all = imagesTr + imagesTs (camelyon.py:56-83)")
    parser.add_argument("--mean", nargs=3, type=float, default=[0.485, 0.456, 0.406])
    parser.add_argument("--std", nargs=3, type=float, default=[0.229, 0.224, 0.225])
    parser.add_argument("-i", "--img-sz", type=int, default=224)
    parser.add_argument("--fold", type=int, default=0)

    # Log setting
    parser.add_argument("--logger-name", default="MSF-WSI", type=str)
    parser.add_argument("--log-dir", default="./logs/temp", type=str)
    parser.add_argument("--tensorboard", action="store_true")
    parser.add_argument("--wandb", action="store_true")
    parser.add_argument("--run-group", default=None, type=str)
    parser.add_argument("--run-tag", nargs="*", default=None, type=str)
    parser.add_argument("--run-name", default=None, type=str)
    parser.add_argument("--run-notes", default="MSF-WSI/TPU training", type=str)

    # MSF-WSI specific configs:
    parser.add_argument("--quick-test", action="store_true")
    parser.add_argument("--save-freq", default=50, type=int)
    parser.add_argument("--mask_ratio", type=int, default=50)
    parser.add_argument("--tf32", action="store_true")
    parser.add_argument("--amp", action="store_true")
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--use-ac", action="store_true")
    parser.add_argument("--ms_lr", nargs=3, type=float, default=[1.0, 1.0, 1.0])
    parser.add_argument("--scale", type=int, default=4)
    parser.add_argument("--fuser_weights", nargs=4, type=float, default=[0.1, 0.4, 0.7, 1.0])

    # Extras of the JAX CLI (not in the reference)
    parser.add_argument("--synthetic", type=int, default=0,
                        help="train on N in-memory synthetic tiles (smoke mode)")
    parser.add_argument("--steps-per-epoch", type=int, default=0,
                        help="cap steps per epoch (0 = full epoch)")
    parser.add_argument("--tile-px", type=int, default=256,
                        help="target sub-tile size before per-tile RRC (reference: 256)")
    parser.add_argument("--profile-steps", type=int, default=0,
                        help="trace the first N steps with torch.profiler into <log-dir>/profile")
    parser.add_argument("--model-parallel", type=int, default=1,
                        help="fuser-head tensor parallelism: split the inter_* heads over "
                        "groups of this many adjacent ranks (must divide the world)")
    parser.add_argument("--allow-random-init", action="store_true",
                        help="proceed from random init when ImageNet weights cannot be "
                        "resolved (default: hard error, since the published setup always "
                        "starts from pretrained=True)")
    parser.add_argument("--imagenet-weights", type=str, default="auto",
                        help="ImageNet init for both encoders (reference default: "
                        "pretrained=True). 'auto' = search $MSFWSI_IMAGENET_DIR and the "
                        "caches (no download); 'none' = random init; or a local torchvision "
                        ".pth path")
    parser.add_argument("--packed-cache", type=str, default="",
                        help="directory for a decode-once uint8 tile pack; training then "
                        "streams raw bytes (no per-epoch PNG decode)")

    # The port's own
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


if __name__ == "__main__":
    main()
