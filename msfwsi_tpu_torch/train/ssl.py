"""SSL pre-training: train state, optimizer, train step and the fused
augment-and-step (port of ``msfwsi_tpu/train/ssl.py``).

One step is: forward of both SimSiam views through :class:`MSFWSI`, the
MSF-WSI loss, backward, the optimizer on three learning-rate groups keyed
on the ``context_/target_/inter_`` parameter prefixes with the sqrt-batch
lr scaling, and the BatchNorm running-stat update (in the forward). Under
``amp`` the forward runs in ``torch.autocast`` bf16 with fp32 parameters
(the fuser heads' in bf16 with ``inter_dtype="bfloat16"``), BN statistics
and loss. PyTorch runs eagerly: nothing is compiled.

The large-model memory path, as the JAX package's: Adafactor on the fuser
heads (``inter_opt="adafactor"``), or the fused outer-product Adafactor on
their big weights (``"fused_adafactor"``, ``train/factored.py``), bf16
head storage, gradient accumulation over interleaved microbatches
(``accum_steps``) and per-block activation checkpointing (``use_ac``,
``remat_stages``).

Distributed, as the JAX package's mesh step (``parallel/``): with a
:class:`~..parallel.mesh.Mesh` each data rank trains on its contiguous rows
of the global batch, BatchNorm reduces its statistics over the data group,
the fuser heads are split over the model group, and the gradients are
averaged once per step, after accumulation; a step equals the
single-process step on the global batch.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..data.pipeline import AugConfig, make_ssl_views, sample_ssl_views, target_keys
from ..models.backbone import MSFWSI, build_msfwsi
from ..models.resnet import sync_batchnorm
from ..ops.losses import msfwsi_loss
from ..parallel import tp
from ..parallel.mesh import Mesh, rank_draws
from .factored import (Adafactor, FactorStash, FusedOuterAdafactor, OptimizerGroups,
                       is_factored_kernel)

__all__ = [
    "SSLConfig",
    "SSLTrainState",
    "create_ssl_state",
    "make_ssl_optimizer",
    "target_keys",
    "ssl_loss_fn",
    "ssl_train_step",
    "slice_microbatch",
    "make_fused_step",
    "view_seed",
    "load_imagenet_encoders",
]


@dataclasses.dataclass(frozen=True)
class SSLConfig:
    """Pretrain hyperparameters; defaults mirror the reference's flags.

    ``inter_opt``: the fuser heads' optimizer, ``adam`` (the reference's),
    ``adafactor`` or ``fused_adafactor``; ``inter_dtype``: their storage
    dtype, ``float32`` or ``bfloat16``; ``use_ac``: per-block activation
    checkpointing of the encoders, of the stages in ``remat_stages``
    (1-indexed; None for all); ``accum_steps``: sequential microbatches a
    step, one optimizer update on the mean of their gradients, each
    microbatch's BatchNorm on its own statistics (the running ones take
    ``accum_steps`` updates a step), as the JAX package's."""

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
    inter_dtype: str = "float32"
    remat_stages: Sequence[int] | None = None
    accum_steps: int = 1
    # False: target views stay in spatial order and the jigsaw shuffle is
    # applied to the features (same result, no view-stack permute).
    shuffle_views: bool = False

    def __post_init__(self):
        if self.inter_opt not in INTER_OPTS:
            raise ValueError(f"unknown inter_opt {self.inter_opt!r} (one of {INTER_OPTS})")
        if self.inter_dtype not in INTER_DTYPES:
            raise ValueError(f"unknown inter_dtype {self.inter_dtype!r} (one of "
                             f"{tuple(INTER_DTYPES)})")
        if self.accum_steps < 1:
            raise ValueError(f"accum_steps {self.accum_steps} < 1")

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
            inter_param_dtype=INTER_DTYPES[self.inter_dtype],
            remat=self.use_ac,
            remat_stages=self.remat_stages,
        )


INTER_OPTS = ("adam", "adafactor", "fused_adafactor")
INTER_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class SSLTrainState:
    """The model, its optimizer and step count; ``stash`` holds the fused
    Adafactor's gradient factors (``inter_opt="fused_adafactor"``);
    ``mesh`` the rank layout of a distributed run (None: one process)."""

    model: MSFWSI
    optimizer: torch.optim.Optimizer | OptimizerGroups
    step: int = 0
    stash: FactorStash | None = None
    mesh: Mesh | None = None


def _param_group(name: str) -> str:
    """Optimizer group of a parameter by its top-level module prefix."""
    for group in ("context", "target", "inter"):
        if name.startswith(f"{group}_"):
            return group
    raise ValueError(f"parameter {name} not in any optimizer group")


def make_ssl_optimizer(model: MSFWSI, config: SSLConfig, stash: FactorStash | None = None,
                       mesh: Mesh | None = None):
    """The groups of the JAX package's ``make_ssl_optimizer``, each at
    ``init_lr * ms_lr[i]``; no weight decay (the reference parses ``--wd``
    but never passes it to Adam). With ``inter_opt="adam"``, one Adam over
    the three groups (the reference's). Otherwise an
    :class:`OptimizerGroups`: Adam on ``context`` and ``target``,
    :class:`Adafactor` on ``inter``, and with ``fused_adafactor`` the
    :class:`FusedOuterAdafactor` on the factored inter-head weights
    (``inter_fac``), fed by ``stash``. Under a ``mesh`` the Adafactors take
    the fuser heads' splits and the fused one the data group."""
    fused = config.inter_opt == "fused_adafactor"
    if fused and stash is None:
        raise ValueError("inter_opt 'fused_adafactor' needs the FactorStash its taps fill")
    groups = {"context": [], "target": [], "inter": [], "inter_fac": []}
    shards = tp.param_shards(model)
    for name, p in model.named_parameters():
        group = _param_group(name)
        full = shards[p].full_shape(p.shape) if p in shards else None
        if fused and is_factored_kernel(name, p, full):
            group = "inter_fac"
        groups[group].append(p)
    lrs = {g: config.init_lr * m for g, m in zip(("context", "target", "inter"), config.ms_lr)}

    def adam(names):
        return torch.optim.Adam([{"params": groups[g], "lr": lrs[g]} for g in names],
                                betas=(0.9, 0.999), eps=1e-8)

    if config.inter_opt == "adam":
        return adam(("context", "target", "inter"))
    opts = {"adam": adam(("context", "target")),
            "adafactor": Adafactor(groups["inter"], lr=lrs["inter"], shards=shards)}
    if fused:
        opts["fused_adafactor"] = FusedOuterAdafactor(
            groups["inter_fac"], lr=lrs["inter"], stash=stash, shards=shards,
            data_group=mesh.data_group if mesh is not None else None)
    return OptimizerGroups(opts)


def create_ssl_state(config: SSLConfig, device="cuda", model: MSFWSI | None = None,
                     mesh: Mesh | None = None) -> SSLTrainState:
    """Model (initialized from ``config.seed`` unless given) and optimizer
    on ``device``; with ``fused_adafactor`` the factored weights' layers
    are tapped into the state's stash. Under a ``mesh`` BatchNorm reduces
    over the data group and the fuser heads are split over the model group:
    born split when the model is made here, a given full model cut to this
    rank's slices."""
    dev = resolve_device(device)
    if model is None:
        gen = torch.Generator().manual_seed(config.seed)
        model = build_msfwsi(gen, device=dev, mesh=mesh, **config.model_kwargs())
    elif mesh is not None and not tp.named_shards(model):
        tp.shard_msfwsi(model, mesh)
    model = model.to(dev)
    if mesh is not None:
        sync_batchnorm(model, mesh.data_group)
    stash = None
    if config.inter_opt == "fused_adafactor":
        stash = FactorStash()
        model.tap_factored(stash)
    return SSLTrainState(model=model, optimizer=make_ssl_optimizer(model, config, stash, mesh),
                         stash=stash, mesh=mesh)


def ssl_loss_fn(model: MSFWSI, batch, fuser_weights: Sequence[float]):
    t1, t2 = target_keys(model.views_shuffled)
    outputs = model(
        (batch["context1"], batch[t1]),
        (batch["context2"], batch[t2]),
        (batch["rev1"], batch["rev2"]),
    )
    return msfwsi_loss(outputs, fuser_weights)


def slice_microbatch(batch, accum_steps: int, i: int):
    """The i-th of ``accum_steps`` microbatches of ``batch`` (a tensor or a
    dict of tensors whose leading axes are B or sample-major B*K): the
    samples whose index satisfies ``index % accum_steps == i``, the JAX
    package's interleaved partition. Raises when ``accum_steps`` does not
    divide B."""
    leaves = batch.values() if isinstance(batch, dict) else (batch,)
    B = min(a.shape[0] for a in leaves)
    if B % accum_steps:
        raise ValueError(f"batch size {B} not divisible by accum_steps {accum_steps}")

    def sl(a):
        m, rest = a.shape[0] // B, a.shape[1:]
        return a.reshape(B // accum_steps, accum_steps, m, *rest)[:, i].reshape(-1, *rest)

    return {k: sl(v) for k, v in batch.items()} if isinstance(batch, dict) else sl(batch)


def accumulate(model, accum_steps: int, microbatch_fn, loss_fn, stash=None) -> list:
    """Forward and backward of ``accum_steps`` microbatches in turn:
    ``loss_fn(microbatch_fn(i))`` returns ``(loss, detached extra)``; each
    microbatch is dropped before the next is built. The raw gradients are
    summed (the ``.grad`` accumulation), then scaled by ``1/accum_steps``
    once; the dY in ``stash`` are scaled as the optimizer takes them
    (``FactorStash.dy_scale``). Returns each microbatch's ``(loss,
    extra)``, the loss detached."""
    out = []
    for i in range(accum_steps):
        loss, extra = loss_fn(microbatch_fn(i))
        loss.backward()
        out.append((loss.detach(), extra))
        del loss, extra
    if accum_steps > 1:
        inv = 1.0 / accum_steps
        for p in model.parameters():
            if p.grad is not None:
                p.grad.mul_(inv)
        if stash is not None:
            stash.dy_scale = inv
    return out


def ssl_train_step(state: SSLTrainState, batch, fuser_weights: Sequence[float],
                   amp: bool = False, accum_steps: int = 1, microbatch_fn=None) -> dict:
    """One step in place on ``state``; returns the detached loss tensors
    (reading them synchronizes, so the caller decides when). With
    ``accum_steps`` > 1 the step runs that many microbatches (the
    interleaved slices of ``batch``, or ``microbatch_fn(i)``) and one
    optimizer update on their mean gradient; the losses are their means.
    Under ``state.mesh`` the batch is this data rank's part; the gradients
    are averaged over the ranks once, after the microbatches, and the
    losses are the global batch's."""
    model = state.model
    model.train()
    state.optimizer.zero_grad(set_to_none=True)
    device_type = next(model.parameters()).device.type
    if microbatch_fn is None:
        microbatch_fn = lambda i: slice_microbatch(batch, accum_steps, i)  # noqa: E731

    def loss_fn(mb):
        with torch.autocast(device_type, dtype=torch.bfloat16, enabled=amp):
            loss, per_path = ssl_loss_fn(model, mb, fuser_weights)
        return loss, {k: v.detach() for k, v in per_path.items()}

    try:
        parts = accumulate(model, accum_steps, microbatch_fn, loss_fn, state.stash)
        tp.sync_gradients(model, state.mesh)
        state.optimizer.step()
    finally:
        if state.stash is not None:
            state.stash.clear()
    state.step += 1
    inv = 1.0 / accum_steps
    metrics = {"loss": sum(loss for loss, _ in parts) * inv}
    for k in parts[0][1]:
        metrics[f"loss_{k}"] = sum(per_path[k] for _, per_path in parts) * inv
    group = state.mesh.data_group if state.mesh is not None else None
    if group is not None:
        flat = torch.stack([v.float() for v in metrics.values()])
        dist.all_reduce(flat, group=group)
        flat /= dist.get_world_size(group)
        metrics = dict(zip(metrics, flat.unbind()))
    return metrics


def make_fused_step(config: SSLConfig, aug_cfg: AugConfig, device="cuda", mesh: Mesh | None = None):
    """On-device augmentation (uint8 tiles -> 4 views + jigsaw) followed by
    the train step — the eager counterpart of the JAX package's
    ``make_jitted_fused_step``.

    The returned ``step(state, tiles_u8, generator=None, view_params=None)``
    draws the view parameters from ``generator`` (on ``device``) or applies
    ``view_params`` (as ``data.pipeline.sample_ssl_views`` returns them).
    With ``accum_steps`` > 1 each microbatch's views are built from its own
    slice of the tiles (``slice_microbatch``), drawn in turn from
    ``generator``, or from ``view_params[i]`` (a list, one entry per
    microbatch): the full batch's views never exist at once.

    Under a ``mesh`` the tiles are this data rank's contiguous part of the
    global batch: every rank draws (or is given) the view parameters of the
    global (micro)batch and applies its own rows, so a world-N step sees
    the views of the single-process step.
    """
    dev = resolve_device(device)
    fuser_weights = tuple(config.fuser_weights)
    accum = config.accum_steps

    def step(state: SSLTrainState, tiles_u8, generator=None, view_params=None):
        tiles_u8 = tiles_u8.to(dev)
        if accum > 1 and view_params is not None and len(view_params) != accum:
            raise ValueError(f"{len(view_params)} view parameter sets for {accum} microbatches")

        def microbatch_fn(i):
            tiles = slice_microbatch(tiles_u8, accum, i)
            params = view_params if accum == 1 or view_params is None else view_params[i]
            params = rank_draws(mesh, tiles.shape[0], params, lambda total: sample_ssl_views(
                generator, total, tiles.shape[1:3], aug_cfg))
            return make_ssl_views(tiles, aug_cfg, generator, shuffle_views=config.shuffle_views,
                                  params=params)

        return ssl_train_step(state, None, fuser_weights, amp=config.amp, accum_steps=accum,
                              microbatch_fn=microbatch_fn)

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
    state.optimizer = make_ssl_optimizer(state.model, config, state.stash, state.mesh)
    return state
