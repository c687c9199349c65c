"""Serving export: a fine-tuned HookNet frozen into one ``torch.export``
artifact (port of ``msfwsi_tpu/train/serving.py``).

:func:`export_hooknet_serving` exports the whole inference function: the
eval-mode HookNet forward on a fixed chunk of tiles, with the weights baked
in, then the argmax of the target logits. Any PyTorch of the same or a
newer version loads it with :func:`load_serving_artifact` (or
``torch.export.load(path).module()``) and calls it without the model's code
or its checkpoint.

The signature is the JAX artifact's, that of the per-slide chunk loop:
``(context, target)``, each ``(chunk, size, size, 3)`` float32 NHWC and
normalized, to the ``(chunk, size, size)`` int32 argmax of the fp32 target
logits (the first index at ties). The shapes are fixed; another chunk or
size raises when called. Under ``amp`` the forward runs in
``torch.autocast(bfloat16)``, as the port's evaluation does.

An artifact runs on the device type it was exported on: its weights are
stored there, and the autocast region names that device type. Export on
the kind of device that will serve.
"""

from __future__ import annotations

import torch
from torch import nn

from .. import resolve_device

__all__ = ["export_hooknet_serving", "load_serving_artifact"]


class _Serve(nn.Module):
    """Eval-mode target argmax of a HookNet, as the artifact computes it."""

    def __init__(self, model: nn.Module, amp: bool):
        super().__init__()
        self.model = model
        self.amp = amp

    def forward(self, context, target):
        with torch.autocast(context.device.type, dtype=torch.bfloat16, enabled=self.amp):
            _, tgt_logits = self.model(context, target)
        return tgt_logits.float().argmax(dim=-1).to(torch.int32)


def export_hooknet_serving(model: nn.Module, path: str, chunk: int = 128, size: int = 256,
                           amp: bool = False) -> str:
    """Export the eval-mode chunked inference of ``model`` (a HookNet, on
    the device the artifact will serve on) to ``path`` with
    ``torch.export.save``. Returns the path. ``model`` is left in eval
    mode."""
    dev = next(model.parameters()).device
    model.eval()
    # two tensors: one passed twice would be traced as one input, aliased
    specs = tuple(torch.zeros((chunk, size, size, 3), dtype=torch.float32, device=dev)
                  for _ in range(2))
    program = torch.export.export(_Serve(model, amp), specs)
    torch.export.save(program, path)
    return path


def load_serving_artifact(path: str, device="cuda"):
    """Load an artifact for ``device`` (which must be of the device type it
    was exported on); returns a callable ``(context, target) ->
    pred_mask`` that runs without autograd."""
    dev = resolve_device(device)
    program = torch.export.load(path)
    kinds = {t.device.type for t in program.state_dict.values()}
    if kinds != {dev.type}:
        raise ValueError(f"{path} was exported on {sorted(kinds)} and runs there only; "
                         f"asked for {str(dev)!r}")
    module = program.module().to(dev)

    def infer(context, target):
        with torch.no_grad():
            return module(context, target)

    return infer
