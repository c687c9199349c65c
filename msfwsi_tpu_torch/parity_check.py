"""Released-checkpoint accuracy parity check of the port (from
``tools/parity_check.py``).

    python -m msfwsi_tpu_torch.parity_check --weights bcss_fold0_ft_model.pth.tar \\
        --train-data ../data/bcss/L0_1024_s512 --data-name bcss --fold 0 \\
        --reference-miou <mIoU printed by the reference's evaluate.py>

Runs the evaluate CLI's loop once on the fine-tuned ``.pth.tar`` and prints
a one-line JSON verdict: the measured micro IoU, and with
``--reference-miou`` the reference value, the delta and ``parity``; the
exit code is 1 when ``|delta| > --tolerance`` (0.005, half a point), else
0. ``--ssl-weights`` also checks that an SSL pretrain ``.pth.tar`` loads
into a fresh HookNet's branch encoders through the fine-tuning loader and
changes them. The flags are the JAX tool's, plus ``--device``.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import evaluate as EVAL_CLI
from . import resolve_device
from .ssl_finetune import CLASS_NAMES
from .train import checkpoint as C
from .train import finetune as FT

__all__ = ["build_parser", "main", "check_ssl_surgery"]


def build_parser():
    parser = argparse.ArgumentParser(
        description="MSF-WSI released-checkpoint parity check (PyTorch port)",
        epilog=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--weights", type=str, required=True,
                        help="released fine-tuned HookNet .pth.tar")
    parser.add_argument("--ssl-weights", type=str, default="",
                        help="optionally also check the released SSL pretrain .pth.tar loads "
                        "through the finetune surgery path")
    parser.add_argument("--train-data", type=str,
                        help="prepared dataset dir (bcss_prepare output)")
    parser.add_argument("--data-name", type=str, default="bcss", choices=("bcss", "paip"))
    parser.add_argument("--fold", type=int, default=0)
    parser.add_argument("-a", "--arch", default="resnet18")
    parser.add_argument("--seed", type=int, default=3407)
    parser.add_argument("--val-chunk", type=int, default=128)
    parser.add_argument("--seg-size", type=int, default=256)
    # Evaluation must use the normalization stats of the checkpoint's
    # training run; they are passed through to the evaluate CLI.
    parser.add_argument("--mean", nargs=3, type=float, default=None,
                        help="normalization mean used at training time (default: the "
                        "evaluate CLI's ImageNet stats)")
    parser.add_argument("--std", nargs=3, type=float, default=None)
    parser.add_argument("--log-dir", default="./logs/parity", type=str)
    parser.add_argument("--synthetic", type=int, default=0,
                        help="fixture mode: N synthetic tiles/slide instead of real data")
    parser.add_argument("--reference-miou", type=float, default=None,
                        help="micro-IoU of the released checkpoint as printed by the reference "
                        "evaluate.py on the same fold")
    parser.add_argument("--tolerance", type=float, default=0.005,
                        help="max |delta| in absolute mIoU (0.005 == 0.5 pts)")

    # The port's own
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def main(argv=None) -> int:
    """Run the check on ``argv``; returns the exit code."""
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    if args.ssl_weights:
        check_ssl_surgery(args)
    eval_argv = [
        "--arch", args.arch, "--weights", args.weights, "--data-name", args.data_name,
        "--fold", str(args.fold), "--seed", str(args.seed), "--val-chunk", str(args.val_chunk),
        "--seg-size", str(args.seg_size), "--log-dir", args.log_dir, "--device", args.device,
        *(["--train-data", args.train_data] if args.train_data else []),
        *(["--synthetic", str(args.synthetic)] if args.synthetic else []),
        *(["--mean", *map(str, args.mean)] if args.mean else []),
        *(["--std", *map(str, args.std)] if args.std else []),
    ]
    summary = EVAL_CLI.main(eval_argv)["summary"]  # the path a user runs
    result = {
        "metric": f"{args.data_name}_fold{args.fold}_micro_iou",
        "measured": round(summary["iou_micro"], 6),
        "f1_micro": round(summary["f1_micro"], 6),
        "acc_micro": round(summary["acc_micro"], 6),
    }
    if args.reference_miou is not None:
        delta = summary["iou_micro"] - args.reference_miou
        result.update(reference=args.reference_miou, delta=round(delta, 6),
                      tolerance=args.tolerance, parity=bool(abs(delta) <= args.tolerance))
    print(json.dumps(result))
    return 1 if args.reference_miou is not None and not result["parity"] else 0


def check_ssl_surgery(args) -> None:
    """Load an SSL pretrain checkpoint into a fresh HookNet's branch
    encoders (the fine-tuning loader) and assert that they changed."""
    class_names = CLASS_NAMES[args.data_name]
    config = FT.FinetuneConfig(arch=args.arch, class_names=tuple(class_names), seed=0)
    state = FT.create_finetune_state(config, device="cpu")
    before = [v.clone() for v in state.model.context_branch.encoder.state_dict().values()]
    state = FT.load_ssl_encoders(state, C.load_torch_file(args.ssl_weights), config)
    after = state.model.context_branch.encoder.state_dict().values()
    assert any(not torch.equal(a, b) for a, b in zip(before, after)), (
        "SSL surgery left encoder weights unchanged")
    print(json.dumps({"ssl_surgery": "ok", "weights": args.ssl_weights}))


if __name__ == "__main__":
    sys.exit(main())
