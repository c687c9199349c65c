"""HookNet fine-tuning: state, SSL checkpoint surgery, train step and the
fused augment-and-step (port of ``msfwsi_tpu/train/finetune.py``).

  * model: :class:`HookNet` with ``classes = len(class_names) + 1``
    (background 0, ``ssl_finetune.py:137-144``);
  * surgery: the SSL ``context_encoder`` / ``target_encoder`` load into the
    two branch encoders, weights and BatchNorm statistics
    (``ssl_finetune.py:146-172``);
  * loss: ``(1-lam)*Dice(context) + lam*Dice(target)`` over classes 1..C
    from the logits (``ssl_finetune.py:287-288,433-436``), lam 1 by default;
  * optimizer: one Adam at ``lr*sqrt(B)/sqrt(64)`` (``ssl_finetune.py:178``);
  * train metrics: per-sample confusion counts of the target argmax with
    background ignored (``ssl_finetune.py:440-447``).

Under ``amp`` the forward runs in ``torch.autocast`` bf16 with fp32
parameters, BatchNorm statistics and loss. Nothing is compiled.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from .. import resolve_device
from ..data.pipeline import AugConfig, make_seg_train_views
from ..models.hooknet import HookNet, build_hooknet
from ..ops.losses import dice_loss
from ..ops.metrics import get_stats

__all__ = [
    "PAIP_CLASSES",
    "BCSS_CLASSES",
    "FinetuneConfig",
    "SegTrainState",
    "make_finetune_optimizer",
    "create_finetune_state",
    "load_ssl_encoders",
    "finetune_loss_fn",
    "finetune_train_step",
    "make_fused_finetune_step",
]

# ssl_finetune.py:38-40
PAIP_CLASSES = ["tissue", "whole", "viable"]
BCSS_CLASSES = ["tumor", "stroma", "infla", "necr", "other"]

ACCUM_NOT_PORTED = "not ported yet, ROADMAP.md queue 1, the large-model memory path"


@dataclasses.dataclass(frozen=True)
class FinetuneConfig:
    """Fine-tuning hyperparameters; defaults mirror the reference's flags.
    The port has ``accum_steps=1`` only."""

    arch: str = "resnet18"
    class_names: Sequence[str] = tuple(BCSS_CLASSES)
    batch_size: int = 64
    lr: float = 1e-3
    lam: float = 1.0
    amp: bool = True
    seed: int = 3407
    accum_steps: int = 1

    def __post_init__(self):
        if self.accum_steps != 1:
            raise ValueError(f"--accum-steps {self.accum_steps}: {ACCUM_NOT_PORTED}")

    @property
    def num_fg(self) -> int:
        return len(self.class_names)

    @property
    def num_classes(self) -> int:
        return self.num_fg + 1  # + background

    @property
    def init_lr(self) -> float:
        # ssl_finetune.py:178: sqrt-batch scaling against base batch 64.
        return self.lr * (self.batch_size**0.5) / (64**0.5)


@dataclasses.dataclass
class SegTrainState:
    model: HookNet
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_finetune_optimizer(model: HookNet, config: FinetuneConfig) -> torch.optim.Adam:
    return torch.optim.Adam(model.parameters(), lr=config.init_lr, betas=(0.9, 0.999), eps=1e-8)


def create_finetune_state(config: FinetuneConfig, device="cuda",
                          model: HookNet | None = None) -> SegTrainState:
    """HookNet (initialized from ``config.seed`` unless given) and Adam on
    ``device``."""
    dev = resolve_device(device)
    if model is None:
        gen = torch.Generator().manual_seed(config.seed)
        model = build_hooknet(gen, device=dev, arch=config.arch, classes=config.num_classes)
    model = model.to(dev)
    return SegTrainState(model=model, optimizer=make_finetune_optimizer(model, config))


def load_ssl_encoders(state: SegTrainState, ssl_state_dict: dict,
                      config: FinetuneConfig) -> SegTrainState:
    """Checkpoint surgery: the SSL model's ``context_encoder`` into the
    context branch's encoder and ``target_encoder`` into the target
    branch's, weights and BatchNorm statistics (keys with or without the
    ``module.`` prefix; ``fc`` and ``num_batches_tracked`` of a reference
    file are left out). Adam is rebuilt, with no state."""
    sd = {k.removeprefix("module."): v for k, v in ssl_state_dict.items()}
    for branch, encoder in (("context_branch", "context_encoder"),
                            ("target_branch", "target_encoder")):
        prefix = f"{encoder}."
        enc = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)
               and not k.startswith(f"{prefix}fc.") and not k.endswith("num_batches_tracked")}
        getattr(state.model, branch).encoder.load_state_dict(enc, strict=True)
    state.optimizer = make_finetune_optimizer(state.model, config)
    return state


def finetune_loss_fn(model: HookNet, batch: dict, lam: float, num_fg: int, amp: bool = False):
    """``(loss, target logits)`` of one batch in train mode. A term whose
    weight is 0 is not computed, as in the JAX package: with lam 1 the
    context head gets no gradient. Adam then skips its ``None`` gradient
    where optax applies a zero update; the weights are the same either way,
    since a parameter whose gradient has always been 0 has zero moments."""
    classes = list(range(1, num_fg + 1))
    valid = batch.get("valid")  # (N,) mask of a wrap-padded trailing batch
    device_type = batch["context"].device.type
    with torch.autocast(device_type, dtype=torch.bfloat16, enabled=amp):
        ctx_logits, tgt_logits = model(batch["context"], batch["target"])
    loss = 0.0
    if (1.0 - lam) != 0.0:
        loss = loss + (1.0 - lam) * dice_loss(ctx_logits, batch["context_mask"], classes=classes,
                                              sample_mask=valid)
    if lam != 0.0:
        loss = loss + lam * dice_loss(tgt_logits, batch["target_mask"], classes=classes,
                                      sample_mask=valid)
    return loss, tgt_logits


def finetune_train_step(state: SegTrainState, batch: dict, lam: float, num_fg: int,
                        amp: bool = False) -> dict:
    """One step in place on ``state``. Returns device tensors: the loss and
    the per-sample (N, num_fg) confusion counts ``tp/fp/fn/tn`` of the
    target argmax against the target mask, background ignored
    (``get_stats(pred-1, mask-1, ignore_index=-1)``), and ``valid`` when
    the batch has one. Reading them synchronizes, so the caller decides
    when."""
    model = state.model
    model.train()
    state.optimizer.zero_grad(set_to_none=True)
    loss, tgt_logits = finetune_loss_fn(model, batch, lam, num_fg, amp)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    with torch.no_grad():
        pred = tgt_logits.float().argmax(dim=-1)
        tp, fp, fn, tn = get_stats(pred - 1, batch["target_mask"].long() - 1, num_fg,
                                   ignore_index=-1)
    metrics = {"loss": loss.detach(), "tp": tp, "fp": fp, "fn": fn, "tn": tn}
    if batch.get("valid") is not None:
        metrics["valid"] = batch["valid"]
    return metrics


def make_fused_finetune_step(config: FinetuneConfig, aug_cfg: AugConfig, device="cuda"):
    """On-device seg views (uint8 tiles and masks -> context/target pairs)
    followed by the train step, the eager counterpart of the JAX package's
    ``make_jitted_fused_finetune_step``.

    The returned ``step(state, imgs_u8, masks_u8, generator=None,
    view_params=None, valid=None)`` draws the view parameters from
    ``generator`` (on ``device``) or applies ``view_params`` (as
    ``data.pipeline.sample_seg_train_views`` returns them). ``valid`` (B,)
    bool keeps wrap-padded samples out of the Dice loss."""
    dev = resolve_device(device)
    lam = float(config.lam)

    def step(state: SegTrainState, imgs_u8, masks_u8, generator=None, view_params=None,
             valid=None):
        (ctx, tgt), (cm, tm) = make_seg_train_views(imgs_u8.to(dev), masks_u8.to(dev), aug_cfg,
                                                    generator, params=view_params)
        batch = {"context": ctx, "target": tgt, "context_mask": cm, "target_mask": tm}
        if valid is not None:
            batch["valid"] = valid.to(dev)
        return finetune_train_step(state, batch, lam, config.num_fg, amp=config.amp)

    return step
