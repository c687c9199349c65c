"""Freeze a fine-tuned HookNet checkpoint into a ``torch.export`` serving
artifact (port of ``tools/export_serving.py``).

    python -m msfwsi_tpu_torch.export_serving --checkpoint logs/ft/best_ft_model.pth.tar \\
        --out hooknet.pt2 --data-name bcss [--chunk 128] [--seg-size 256] [--amp]

The flags and defaults are the JAX tool's, plus ``--device`` (``cuda`` by
default; without a card the CLI raises unless given ``--device cpu``). The
checkpoint is a ``.pth.tar`` of the port or of the reference (a
``best_ft_model.pth.tar``); an Orbax directory of the JAX package raises,
naming its converter. The artifact holds the weights and the eval-mode
chunked inference (:func:`.train.serving.export_hooknet_serving`), runs on
the device type it was exported on, and loads with
:func:`.train.serving.load_serving_artifact`.
"""

from __future__ import annotations

import argparse

from . import resolve_device
from .models.hooknet import HookNet
from .train import checkpoint as C
from .train import finetune as FT
from .train import serving

__all__ = ["build_parser", "main"]

CLASS_NAMES = {"bcss": FT.BCSS_CLASSES, "paip": FT.PAIP_CLASSES}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Export HookNet to a torch.export artifact")
    parser.add_argument("--checkpoint", required=True, help="fine-tuned HookNet .pth.tar")
    parser.add_argument("--out", required=True)
    parser.add_argument("-a", "--arch", default="resnet18")
    parser.add_argument("--data-name", default="bcss", choices=["bcss", "paip"])
    parser.add_argument("--chunk", type=int, default=128)
    parser.add_argument("--seg-size", type=int, default=256)
    parser.add_argument("--amp", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="the device the artifact is exported on and will serve on")
    return parser


def main(argv=None) -> str:
    """Run the CLI on ``argv``; returns the artifact's path."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    classes = len(CLASS_NAMES[args.data_name]) + 1
    model = C.load_ft_model(args.checkpoint, HookNet(arch=args.arch, classes=classes))
    path = serving.export_hooknet_serving(model.to(dev), args.out, chunk=args.chunk,
                                          size=args.seg_size, amp=args.amp)
    print(f"exported serving artifact -> {path}")
    return path


if __name__ == "__main__":
    main()
