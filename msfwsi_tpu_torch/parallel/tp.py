"""Tensor parallelism of the MSF-WSI fuser heads (port of
``msfwsi_tpu/parallel/tp.py``).

The fuser heads' widths scale as ``C_i * (n_keep + 1)``: resnet50 at scale
4 has ~1.58B head parameters, whose fp32 Adam state alone outgrows a card.
Only those heads (``inter_*``) are split over the ``"model"`` group, by the
JAX package's rule (``_spec_for``): a ``Linear`` weight along its output
features where they divide (column-parallel), else along its input features
(row-parallel), else not at all; a vector (bias, BatchNorm scale, bias and
running statistics) where it divides. Everything else is replicated.

Where GSPMD inserts the collectives, :func:`head_forward` calls them:

  * column-parallel: the full input enters through :class:`_CopyToModel`
    (identity; its backward sums the ranks' partial input gradients), each
    rank computes its output features, BatchNorm and ReLU act on the
    feature shard (BatchNorm still reduces over the data group), and the
    shards are gathered before the next ``Linear`` (:class:`_GatherFeatures`,
    whose backward keeps this rank's slice of the replicated gradient);
  * row-parallel: each rank multiplies its slice of the input features,
    the partial outputs are summed (:class:`_ReduceFromModel`) and the bias
    is added once.

Optimizer state follows its parameter (the optimizers read
:func:`param_shards`; a factored one declares the axis each factor keeps,
``state_axes``). A model is born distributed (``build_msfwsi(...,
mesh=)`` initializes only this rank's slices, each drawn from the seed's
stream at its place, :meth:`Shard.fill_`), or sharded after a load
(:func:`shard_state_dict`); :func:`full_state_dict` and
:func:`gather_optimizer_state` rebuild the full tensors for a checkpoint.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.distributed as dist
from torch import nn

from .mesh import average_gradients

__all__ = ["Shard", "split_dim", "shard_msfwsi", "named_shards", "param_shards",
           "head_forward", "full_state_dict", "shard_state_dict", "gather_optimizer_state",
           "shard_optimizer_state", "sync_gradients"]

# Elements of the full tensor drawn at a time when a shard is initialized.
DRAW_BLOCK = 1 << 22


@dataclasses.dataclass(frozen=True)
class Shard:
    """This rank's part of a tensor split along ``dim`` into ``parts``
    equal slices over ``group``: slice ``index``, of ``full`` elements
    along ``dim`` in all."""

    dim: int
    full: int
    parts: int
    index: int
    group: Any = None

    @property
    def local(self) -> int:
        return self.full // self.parts

    def full_shape(self, local_shape) -> tuple:
        shape = list(local_shape)
        shape[self.dim] = self.full
        return tuple(shape)

    def take(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the full tensor."""
        return full.narrow(self.dim, self.index * self.local, self.local)

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The full tensor from every rank's slice."""
        parts = [torch.empty_like(local) for _ in range(self.parts)]
        dist.all_gather(parts, local.contiguous(), group=self.group)
        return torch.cat(parts, dim=self.dim)

    @torch.no_grad()
    def fill_(self, out: torch.Tensor, draw) -> torch.Tensor:
        """Fill ``out`` (this rank's slice) with its values of a full tensor
        whose elements ``draw(n)`` returns in order, ``n`` at a time: the
        whole stream is drawn, in blocks, so that the generator ends where
        the full tensor's draw leaves it, and the full tensor never exists."""
        shape = self.full_shape(out.shape)
        row = math.prod(shape[1:])
        per = max(1, DRAW_BLOCK // max(1, row))
        lo, hi = self.index * self.local, (self.index + 1) * self.local
        for r0 in range(0, shape[0], per):
            r1 = min(shape[0], r0 + per)
            blk = draw((r1 - r0) * row).view(r1 - r0, *shape[1:])
            if self.dim == 0:
                a, b = max(lo, r0), min(hi, r1)
                if a < b:
                    out[a - lo : b - lo].copy_(blk[a - r0 : b - r0])
            else:
                out[r0:r1].copy_(blk.narrow(self.dim, lo, self.local))
        return out


def split_dim(name: str, shape, n_model: int) -> int | None:
    """The JAX package's ``_spec_for`` on a torch tensor: None outside the
    ``inter_*`` heads; a ``Linear`` weight ``(out, in)`` split along ``out``
    where it divides (the flax kernel's output axis), else along ``in``; a
    vector where it divides; else None."""
    if n_model == 1 or not name.startswith("inter_"):
        return None
    if len(shape) == 2 and name.endswith("weight"):
        for dim in (0, 1):
            if shape[dim] % n_model == 0:
                return dim
    elif len(shape) == 1 and shape[0] % n_model == 0:
        return 0
    return None


def _inter_heads(model):
    for side in ("inter_projector", "inter_predictor"):
        for i, head in enumerate(getattr(model, side)):
            yield f"{side}.{i}", head


def shard_msfwsi(model: nn.Module, mesh) -> nn.Module:
    """Split the fuser heads of ``model`` over ``mesh.model_group`` in place:
    every split parameter and buffer replaced by this rank's slice (a meta
    tensor stays meta, at the slice's shape, for a born-distributed init),
    the split recorded on its module (``tp_split``: local name ->
    :class:`Shard`) and each head's forward switched to :func:`head_forward`."""
    if mesh.model == 1:
        return model
    for prefix, head in _inter_heads(model):
        head.tp_group = mesh.model_group
        for idx, m in head.named_children():
            m.tp_split = {}
            tensors = [*m.named_parameters(recurse=False), *m.named_buffers(recurse=False)]
            for local, t in tensors:
                dim = split_dim(f"{prefix}.{idx}.{local}", t.shape, mesh.model)
                if dim is None:
                    continue
                shard = Shard(dim, t.shape[dim], mesh.model, mesh.model_rank, mesh.model_group)
                sliced = shard.take(t).clone() if t.device.type != "meta" else t.new_empty(
                    [shard.local if d == dim else s for d, s in enumerate(t.shape)])
                if isinstance(t, nn.Parameter):
                    setattr(m, local, nn.Parameter(sliced, requires_grad=t.requires_grad))
                else:
                    m._buffers[local] = sliced
                m.tp_split[local] = shard
    return model


def named_shards(model: nn.Module) -> dict[str, Shard]:
    """``{state_dict key: Shard}`` of every split tensor of ``model``."""
    out = {}
    for name, m in model.named_modules():
        for local, shard in getattr(m, "tp_split", {}).items():
            out[f"{name}.{local}"] = shard
    return out


def param_shards(model: nn.Module) -> dict[torch.Tensor, Shard]:
    """``{parameter: Shard}`` of every split parameter of ``model``."""
    shards = named_shards(model)
    return {p: shards[n] for n, p in model.named_parameters() if n in shards}


# ------------------------------------------------------------ the forward


class _CopyToModel(torch.autograd.Function):
    """Identity; the backward sums the gradient over the model group (each
    rank's is the part that flowed through its slice of the next layer)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """Sum of the ranks' partial outputs; the gradient, replicated
    downstream, passes through."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFeatures(torch.autograd.Function):
    """Every rank's feature slice concatenated along the last axis; the
    backward keeps this rank's slice of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, group):
        n = dist.get_world_size(group)
        ctx.group, ctx.width = group, x.shape[-1]
        ctx.index = dist.get_rank(group)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(-1, ctx.index * ctx.width, ctx.width).contiguous(), None


def head_forward(head: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """A fuser head's forward with its split layers; ``x`` and the result
    are the full (replicated) activations. A row-parallel layer's bias
    is added after the sum: the layer leaves it out while its
    ``defer_bias`` is set."""
    group = head.tp_group
    sharded = False  # x holds this rank's feature slice
    for layer in head:
        if isinstance(layer, nn.Linear):
            if sharded:
                x = _GatherFeatures.apply(x, group)
                sharded = False
            shard = layer.tp_split.get("weight")
            if shard is None:
                x = layer(x)
            elif shard.dim == 0:
                x = layer(_CopyToModel.apply(x, group))
                sharded = True
            else:
                x_local = _CopyToModel.apply(x, group).narrow(-1, shard.index * shard.local,
                                                              shard.local)
                layer.defer_bias = True
                try:
                    y = layer(x_local)
                finally:
                    layer.defer_bias = False
                x = _ReduceFromModel.apply(y, group)
                if layer.bias is not None:
                    x = x + layer.bias.to(x.dtype)
        else:
            x = layer(x)
    if sharded:
        x = _GatherFeatures.apply(x, group)
    return x


# ------------------------------------------------------ state and gradients


def full_state_dict(model: nn.Module) -> dict:
    """``model.state_dict()`` with every split tensor gathered to its full
    shape (a collective: every rank of the model group calls it)."""
    shards = named_shards(model)
    return {k: shards[k].gather(v) if k in shards else v for k, v in model.state_dict().items()}


def shard_state_dict(model: nn.Module, state_dict: dict) -> dict:
    """A full state dict cut to ``model``'s slices, for ``load_state_dict``."""
    shards = named_shards(model)
    return {k: shards[k].take(v) if k in shards else v for k, v in state_dict.items()}


def _entry_shard(optimizer, key: str, t, shard: Shard, full_shape) -> Shard | None:
    """The split of state entry ``key`` of a parameter split by ``shard``:
    a tensor of the parameter's shape follows it; a factor follows it when
    it keeps the split axis; anything else is whole."""
    if not torch.is_tensor(t) or t.dim() == 0:
        return None
    axes = getattr(optimizer, "state_axes", None)  # factored optimizers declare theirs
    kept = axes(full_shape) if axes is not None else {}
    if key in kept:
        return dataclasses.replace(shard, dim=0) if kept[key] == shard.dim else None
    local = list(full_shape)
    local[shard.dim] = shard.local
    return shard if tuple(t.shape) in (tuple(full_shape), tuple(local)) else None


def _optimizers(optimizer) -> dict:
    return getattr(optimizer, "optimizers", None) or {None: optimizer}


def _resplit(optimizer, model: nn.Module, state_dict: dict, cut: bool) -> dict:
    """``state_dict`` of ``optimizer`` with the state of every split
    parameter gathered to full shape (a collective over the model group),
    or, with ``cut``, a full one cut to this rank's slices."""
    shards = param_shards(model)
    out = {}
    for name, opt in _optimizers(optimizer).items():
        sd = state_dict if name is None else state_dict[name]
        params = [p for g in opt.param_groups for p in g["params"]]
        state = dict(sd["state"])
        for i, st in state.items():
            p = params[int(i)]
            shard = shards.get(p)
            if shard is None:
                continue
            full = shard.full_shape(p.shape)
            splits = {k: _entry_shard(opt, k, t, shard, full) for k, t in st.items()}
            state[i] = {k: t if splits[k] is None else
                        (splits[k].take(t).clone() if cut else splits[k].gather(t))
                        for k, t in st.items()}
        out[name] = {**sd, "state": state}
    return out[None] if None in out else out


def gather_optimizer_state(optimizer, model: nn.Module) -> dict:
    """``optimizer.state_dict()`` with the state of split parameters
    gathered to full shape (a collective over the model group)."""
    sd = optimizer.state_dict()
    return _resplit(optimizer, model, sd, cut=False) if param_shards(model) else sd


def shard_optimizer_state(optimizer, model: nn.Module, state_dict: dict) -> dict:
    """A full optimizer state dict cut to this rank's slices."""
    return _resplit(optimizer, model, state_dict, cut=True) if param_shards(model) else state_dict


def sync_gradients(model: nn.Module, mesh) -> None:
    """One mean of every gradient per step: a split parameter's over the
    data group (its slice is this model rank's alone), a replicated one's
    over the whole world (the model ranks hold equal gradients; the mean
    keeps them bit-equal)."""
    if mesh is None or mesh.world == 1:
        return
    split = param_shards(model)
    average_gradients([p for p in model.parameters() if p in split], mesh.data_group)
    average_gradients([p for p in model.parameters() if p not in split], mesh.world_group)
