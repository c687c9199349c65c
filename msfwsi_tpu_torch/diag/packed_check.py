"""The packed decoder tail against the unpacked decoder on one model
(``models/hooknet.py``), train mode, forward and backward, with the bounds
the CPU tests measured (``tests/test_torch_packed.py``) and the smoke holds
the card to (``chip_smoke.py``, phase "packed")."""

from __future__ import annotations

import torch

from ..models import hooknet as H
from ..ops import losses as L
from ..ops import s2d

__all__ = ["packed_against_unpacked", "BOUNDS", "within_bounds"]


def packed_against_unpacked(model, batch, amp: bool, lam: float = 0.5):
    """One train-mode forward and backward of ``model`` unpacked, then
    packed with packed logits and the packed Dice (running stats restored
    between), on the same batch: the differences of the loss, of both
    logits (the packed ones after their depth-to-space; the largest
    difference and the largest logit), of the gradients (the worst
    parameter's ||a - b|| / ||b|| and that of all parameters together) and
    of the running stats. ``chip_smoke.py`` runs it on the card at full
    width."""
    init = {k: b.clone() for k, b in model.named_buffers()}
    classes = list(range(1, model.target_branch.segmentation_head[0].out_channels))
    runs = []
    for packed in (False, True):
        with torch.no_grad():
            for k, b in model.named_buffers():
                b.copy_(init[k])
        H.configure_tail(model.train(), packed, packed_logits=packed)
        model.zero_grad(set_to_none=True)
        dice = L.dice_loss_packed if packed else L.dice_loss
        with torch.autocast(batch["context"].device.type, dtype=torch.bfloat16, enabled=amp):
            logits = model(batch["context"], batch["target"])
        loss = ((1 - lam) * dice(logits[0], batch["context_mask"], classes=classes)
                + lam * dice(logits[1], batch["target_mask"], classes=classes))
        loss.backward()
        if packed:
            logits = [s2d.depth_to_space(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
                      for x in logits]
        runs.append({"loss": float(loss.detach()), "logits": [x.detach().float() for x in logits],
                     "grads": {k: p.grad.detach().double() for k, p in model.named_parameters()},
                     "stats": {k: b.detach().double().clone()
                               for k, b in model.named_buffers()}})
    H.configure_tail(model, False)
    a, b = runs
    ga = torch.cat([g.flatten() for g in a["grads"].values()])
    gb = torch.cat([b["grads"][k].flatten() for k in a["grads"]])
    return {
        "loss": abs(a["loss"] - b["loss"]),
        "logits": max(float((x - y).abs().max()) for x, y in zip(a["logits"], b["logits"])),
        "logit_max": max(float(x.abs().max()) for x in a["logits"]),
        "grad_worst": max((float((b["grads"][k] - g).norm() / g.norm().clamp_min(1e-30)), k)
                          for k, g in a["grads"].items()),
        "grad_all": float((gb - ga).norm() / ga.norm()),
        "stats": max((float((b["stats"][k] - s).abs().max()), k) for k, s in a["stats"].items()),
    }


# Packed against unpacked on one model, train mode, forward and backward.
# fp32 as test_torch_hooknet.py bounds the train-mode logits (5e-3 at logits
# up to ~5) and the stats, the gradients by chip_smoke.py's card-against-CPU
# bound (2e-2 of a parameter's norm); measured on the CPU logits 7.1e-6
# apart, losses equal, the worst gradient 5.9e-3, stats 6e-8. bf16
# autocast: two bf16 networks that round in different places; measured on
# the CPU (resnet10 b4 64 px, seeds 0-1, and resnet18 b8 128 px) logits
# 6.3e-2 apart at logits up to 6.5 (1.2% of the largest), losses 5.8e-6,
# the worst parameter's gradient 0.18 of its norm (a BatchNorm bias), all
# gradients together 0.12, running stats 3.1e-4. A wrong backward or
# statistic is off by O(1).
BOUNDS = {
    "fp32": {"loss": 1e-5, "logits_rel": 1e-3, "grad_worst": 2e-2, "grad_all": 1e-2,
             "stats": 1e-4},
    "bf16": {"loss": 1e-4, "logits_rel": 3e-2, "grad_worst": 0.5, "grad_all": 0.3,
             "stats": 3e-3},
}


def within_bounds(d: dict, bounds: dict) -> bool:
    return (d["loss"] <= bounds["loss"] and d["logits"] <= bounds["logits_rel"] * d["logit_max"]
            and d["grad_worst"][0] <= bounds["grad_worst"] and d["grad_all"] <= bounds["grad_all"]
            and d["stats"][0] <= bounds["stats"])
