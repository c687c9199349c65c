"""SSL pre-training: train state, optimizer, train step and the fused
augment-and-step (port of ``msfwsi_tpu/train/ssl.py``).

One step is: forward of both SimSiam views through :class:`MSFWSI`, the
MSF-WSI loss, backward, Adam on three learning-rate groups keyed on the
``context_/target_/inter_`` parameter prefixes with the sqrt-batch lr
scaling, and the BatchNorm running-stat update (in the forward). Under
``amp`` the forward runs in ``torch.autocast`` bf16 with fp32 parameters,
BN statistics and loss. PyTorch runs eagerly: nothing is compiled.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .. import resolve_device
from ..data.pipeline import AugConfig, make_ssl_views, target_keys
from ..models.backbone import MSFWSI, build_msfwsi
from ..ops.losses import msfwsi_loss

__all__ = [
    "SSLConfig",
    "SSLTrainState",
    "create_ssl_state",
    "make_ssl_optimizer",
    "target_keys",
    "ssl_loss_fn",
    "ssl_train_step",
    "make_fused_step",
    "view_seed",
    "load_imagenet_encoders",
]


@dataclasses.dataclass(frozen=True)
class SSLConfig:
    """Pretrain hyperparameters; defaults mirror the reference's flags.
    The port has the reference optimizer only: ``inter_opt="adam"``,
    ``accum_steps=1`` and no activation checkpointing (``use_ac``)."""

    arch: str = "resnet18"
    batch_size: int = 32  # global batch
    lr: float = 1e-3
    mask_ratio: int = 50  # percent, as the reference flag
    scale: int = 4
    ms_lr: Sequence[float] = (1.0, 1.0, 1.0)
    fuser_weights: Sequence[float] = (0.1, 0.4, 0.7, 1.0)
    seed: int = 3407
    amp: bool = True  # bf16 compute
    use_ac: bool = False
    inter_opt: str = "adam"
    accum_steps: int = 1
    # False: target views stay in spatial order and the jigsaw shuffle is
    # applied to the features (same result, no view-stack permute).
    shuffle_views: bool = False

    def __post_init__(self):
        if self.inter_opt != "adam":
            raise ValueError(f"inter_opt {self.inter_opt!r}: the port has only 'adam'")
        if self.accum_steps != 1:
            raise ValueError(f"accum_steps {self.accum_steps}: the port has only 1")
        if self.use_ac:
            raise ValueError("use_ac: the port has no activation checkpointing")

    @property
    def init_lr(self) -> float:
        # sqrt-batch scaling against base batch 32.
        return self.lr * (self.batch_size**0.5) / (32**0.5)

    def model_kwargs(self) -> dict:
        return dict(
            arch=self.arch,
            scale=self.scale,
            mask_ratio=self.mask_ratio / 100,
            views_shuffled=self.shuffle_views,
        )


@dataclasses.dataclass
class SSLTrainState:
    model: MSFWSI
    optimizer: torch.optim.Optimizer
    step: int = 0


def _param_group(name: str) -> str:
    """Optimizer group of a parameter by its top-level module prefix."""
    for group in ("context", "target", "inter"):
        if name.startswith(f"{group}_"):
            return group
    raise ValueError(f"parameter {name} not in any optimizer group")


def make_ssl_optimizer(model: MSFWSI, config: SSLConfig) -> torch.optim.Adam:
    """Adam over three groups at ``init_lr * ms_lr[i]``; no weight decay
    (the reference parses ``--wd`` but never passes it to Adam)."""
    groups = {"context": [], "target": [], "inter": []}
    for name, p in model.named_parameters():
        groups[_param_group(name)].append(p)
    return torch.optim.Adam(
        [
            {"params": groups[g], "lr": config.init_lr * m}
            for g, m in zip(("context", "target", "inter"), config.ms_lr)
        ],
        betas=(0.9, 0.999),
        eps=1e-8,
    )


def create_ssl_state(config: SSLConfig, device="cuda", model: MSFWSI | None = None) -> SSLTrainState:
    """Model (initialized from ``config.seed`` unless given) and optimizer
    on ``device``."""
    dev = resolve_device(device)
    if model is None:
        gen = torch.Generator().manual_seed(config.seed)
        model = build_msfwsi(gen, device=dev, **config.model_kwargs())
    model = model.to(dev)
    return SSLTrainState(model=model, optimizer=make_ssl_optimizer(model, config))


def ssl_loss_fn(model: MSFWSI, batch, fuser_weights: Sequence[float]):
    t1, t2 = target_keys(model.views_shuffled)
    outputs = model(
        (batch["context1"], batch[t1]),
        (batch["context2"], batch[t2]),
        (batch["rev1"], batch["rev2"]),
    )
    return msfwsi_loss(outputs, fuser_weights)


def ssl_train_step(state: SSLTrainState, batch, fuser_weights: Sequence[float],
                   amp: bool = False) -> dict:
    """One step in place on ``state``; returns the detached loss tensors
    (reading them synchronizes, so the caller decides when)."""
    model = state.model
    model.train()
    state.optimizer.zero_grad(set_to_none=True)
    device_type = next(model.parameters()).device.type
    with torch.autocast(device_type, dtype=torch.bfloat16, enabled=amp):
        loss, per_path = ssl_loss_fn(model, batch, fuser_weights)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return {"loss": loss.detach(), **{f"loss_{k}": v.detach() for k, v in per_path.items()}}


def make_fused_step(config: SSLConfig, aug_cfg: AugConfig, device="cuda"):
    """On-device augmentation (uint8 tiles -> 4 views + jigsaw) followed by
    the train step — the eager counterpart of the JAX package's
    ``make_jitted_fused_step``.

    The returned ``step(state, tiles_u8, generator=None, view_params=None)``
    draws the view parameters from ``generator`` (on ``device``) or applies
    ``view_params`` (as ``data.pipeline.sample_ssl_views`` returns them).
    """
    dev = resolve_device(device)
    fuser_weights = tuple(config.fuser_weights)

    def step(state: SSLTrainState, tiles_u8, generator=None, view_params=None):
        batch = make_ssl_views(
            tiles_u8.to(dev), aug_cfg, generator,
            shuffle_views=config.shuffle_views, params=view_params,
        )
        return ssl_train_step(state, batch, fuser_weights, amp=config.amp)

    return step


def view_seed(seed: int, epoch: int, it: int) -> int:
    """Seed of the view generator for step ``it`` of ``epoch``: a function
    of ``(seed, epoch, it)`` alone (``SeedSequence``), as the JAX CLI folds
    ``epoch`` then ``it`` into its base key, so a resumed run draws the
    views an uninterrupted one drew."""
    ss = np.random.SeedSequence([seed & 0x7FFFFFFF, epoch, it])
    return int(ss.generate_state(1, np.uint64)[0])


def load_imagenet_encoders(state: SSLTrainState, torch_state_dict: dict,
                           config: SSLConfig) -> SSLTrainState:
    """Both encoders from a torchvision ImageNet ResNet state dict (``fc``
    and ``num_batches_tracked`` left out), as the reference's
    ``base_encoder(pretrained=True)`` (``backbone.py:58-63``). The heads
    keep their init; the optimizer is rebuilt, with no state."""
    enc = {k: v for k, v in torch_state_dict.items()
           if not k.startswith("fc.") and not k.endswith("num_batches_tracked")}
    for encoder in (state.model.context_encoder, state.model.target_encoder):
        encoder.load_state_dict(enc, strict=True)
    state.optimizer = make_ssl_optimizer(state.model, config)
    return state
