"""Adafactor for the SSL fuser heads (port of ``msfwsi_tpu/train/factored.py``
and of the ``adafactor`` group of ``msfwsi_tpu/train/ssl.py``).

:class:`Adafactor` is the update of ``optax.adafactor(lr,
multiply_by_parameter_scale=False, clipping_threshold=None, eps=1e-8)``
(decay 0.8, ``min_dim_size_to_factor`` 128) on gradients cast to fp32
first: the second-moment statistics are stored in the parameter's dtype,
the update is computed in fp32 and rounded once to the parameter's dtype,
as ``optax.apply_updates`` does. (``torch.optim.Adafactor`` is another
update: a relative step, the learning rate scaled by the parameter's RMS,
and eps as a clamp rather than added to g^2.)

:class:`FusedOuterAdafactor` computes the same update for the inter-head
``Linear`` weights from the factors of their gradient, ``dW = X^T dY``
(X the layer's input rows, dY its output gradient rows; the torch weight is
``dW^T``), without forming ``dW``:

  * the row and column mean squares of ``dW`` come from the Gram trick,
    ``sum_j dW_ij^2 = sum_{b,b'} X_bi X_b'i (dY dY^T)_bb'``;
  * optax's factored update is ``g * row_factor * col_factor``, so it is
    the rank-N product ``-lr (X * rf)^T (dY * cf)``, applied to the weight
    in row blocks so that the fp32 update never exists whole.

The factors reach the optimizer through a :class:`FactorStash`: each tapped
layer (``models/backbone.py::HeadLinear``) adds ``(X, dY)`` to it in its
backward and leaves the weight's ``.grad`` at None. Equal to
:class:`Adafactor` on ``dW`` up to float reassociation: the fused path
normalizes the statistic along ``d_in`` where optax normalizes the one
along the smaller axis, and both means are the mean of ``g^2``.

Distributed (``parallel/``): both optimizers take ``shards``, the
:class:`~..parallel.tp.Shard` of each weight split over the model group,
and compute the statistics of the full weight: a mean along the split axis
is a sum all-reduced over the model group, and a factor that keeps the
split axis is stored split. The fused one also takes the ``data_group``:
each rank's ``(X, dY)`` rows come from its part of the batch, so they are
gathered over the group, dY scaled by 1/ranks (each rank's loss is the mean
over its own rows), before the Gram products: ``dW`` of the global batch
has cross-rank terms in its squares, which no sum of per-rank statistics
holds.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.mesh import gather_rows

__all__ = ["MIN_DIM_SIZE_TO_FACTOR", "DECAY_RATE", "EPS", "BLOCK_ROWS", "factored_dims", "is_factored_kernel", "fac_path_str",
           "FactorStash", "Adafactor", "FusedOuterAdafactor", "OptimizerGroups"]

MIN_DIM_SIZE_TO_FACTOR = 128
DECAY_RATE = 0.8
EPS = 1e-8
# Rows of the weight updated at once by the fused path: a d = 18432 weight
# then takes a 2048 x 18432 fp32 update (151 MB) at a time, not 1.36 GB.
BLOCK_ROWS = 2048

# Sequential index of a head's Linear -> the JAX package's module name.
_FC = {"projector": {"0": "fc1", "3": "fc2", "6": "fc3"}, "predictor": {"0": "fc1", "3": "fc2"}}


def factored_dims(shape):
    """optax's ``_factored_dims``: ``(d1, d0)``, the second-largest and the
    largest axis, or None for a tensor of fewer than 2 axes or whose
    second-largest axis is under ``MIN_DIM_SIZE_TO_FACTOR``."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < MIN_DIM_SIZE_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


def is_factored_kernel(name: str, p: torch.Tensor, shape=None) -> bool:
    """True for the inter-head ``Linear`` weights that optax would factor
    (2-D, both sides at least ``MIN_DIM_SIZE_TO_FACTOR``): the weights the
    fused path updates. ``name`` is the parameter's name in ``MSFWSI``;
    ``shape`` its full shape where ``p`` is this rank's slice of a split
    weight (the rule reads the whole weight, as under GSPMD)."""
    shape = tuple(p.shape if shape is None else shape)
    return name.startswith("inter_") and len(shape) == 2 and min(shape) >= MIN_DIM_SIZE_TO_FACTOR


def fac_path_str(name: str) -> str:
    """The JAX package's path string of an inter-head weight:
    ``inter_projector.0.3.weight`` -> ``inter_projector_0/fc2``."""
    module, scale, index, _ = name.split(".")
    return f"{module}_{scale}/{_FC[module.split('_')[1]][index]}"


class FactorStash:
    """The ``(X, dY)`` gradient factors that tapped layers add in their
    backward, per weight, until the optimizer takes them. ``dy_scale`` is
    1/accum after accumulated microbatches (set by the train step). The
    train step empties it after every step, also one that raises."""

    def __init__(self):
        self._parts: dict[torch.Tensor, list] = {}
        self.dy_scale = 1.0

    def add(self, weight: torch.Tensor, x: torch.Tensor, dy: torch.Tensor) -> None:
        self._parts.setdefault(weight, []).append((x, dy))

    def take(self, weight: torch.Tensor):
        """``(X, dY)`` of ``weight``, every call's rows concatenated and dY
        scaled by ``dy_scale`` in its own dtype, in place on the
        concatenation, as the JAX step scales the concatenated dY."""
        parts = self._parts.pop(weight, None)
        if not parts:
            raise RuntimeError("no (X, dY) factors for a fused-Adafactor weight: its layer "
                               "was not tapped or took no backward this step")
        dy = torch.cat([dy for _, dy in parts])
        if self.dy_scale != 1.0:
            dy.mul_(self.dy_scale)
        return torch.cat([x for x, _ in parts]), dy

    def clear(self) -> None:
        self._parts.clear()
        self.dy_scale = 1.0

    def __len__(self) -> int:
        return len(self._parts)


def _decay(step: int) -> float:
    """optax's ``_decay_rate_pow``: ``1 - (step + 1)^-DECAY_RATE`` in fp32."""
    t = torch.tensor(step + 1, dtype=torch.float32)
    return float(1.0 - t ** (-DECAY_RATE))


def _ema(decay: float, v: torch.Tensor, inst: torch.Tensor) -> torch.Tensor:
    """``decay * v + (1 - decay) * inst`` in fp32, stored in ``v``'s dtype."""
    return (decay * v.float() + (1.0 - decay) * inst).to(v.dtype)


def _rsqrt(v: torch.Tensor) -> torch.Tensor:
    """``v ** -0.5`` rounded once to ``v``'s dtype, as XLA computes it
    (torch's bf16 ``pow`` on the CPU can be an ulp off)."""
    return (v.float() ** -0.5).to(v.dtype)


def _mean(t: torch.Tensor, dim: int, shard, keepdim: bool = False) -> torch.Tensor:
    """``t.mean(dim)``, the axis split over ``shard.group`` when ``shard``
    is given (then ``shard.full`` long in all)."""
    if shard is None:
        return t.mean(dim, keepdim=keepdim)
    out = t.sum(dim, keepdim=keepdim)
    dist.all_reduce(out, group=shard.group)
    return out / shard.full


def _init_step(state: dict) -> int:
    if "step" not in state:
        state["step"] = torch.tensor(0.0)
    return int(state["step"])


class Adafactor(torch.optim.Optimizer):
    """optax's Adafactor without parameter scaling, clipping or momentum;
    see the module's docstring. State per parameter: ``step`` and, for a
    factored one (:func:`factored_dims`), ``v_row`` (the shape without the
    largest axis) and ``v_col`` (without the second-largest), else ``v``,
    all but ``step`` in the parameter's dtype."""

    def __init__(self, params, lr: float, shards: dict | None = None):
        super().__init__(params, dict(lr=lr))
        self.shards = shards or {}

    @staticmethod
    def state_axes(full_shape) -> dict:
        """The parameter axis each factor of a parameter of ``full_shape``
        keeps: ``v_row`` the second-largest axis ``d1``, ``v_col`` the
        largest ``d0`` (none where the parameter is not factored)."""
        dims = factored_dims(full_shape)
        return {} if dims is None else {"v_row": dims[0], "v_col": dims[1]}

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                step = _init_step(state)
                shard = self.shards.get(p)
                dims = factored_dims(shard.full_shape(p.shape) if shard else p.shape)
                if "v" not in state and "v_row" not in state:
                    if dims is None:
                        state["v"] = torch.zeros_like(p)
                    else:
                        d1, d0 = dims
                        shape = list(p.shape)
                        state["v_row"] = p.new_zeros(shape[:d0] + shape[d0 + 1:])
                        state["v_col"] = p.new_zeros(shape[:d1] + shape[d1 + 1:])
                decay = _decay(step)
                g = p.grad.float()
                g2 = g * g + EPS
                if dims is None:
                    state["v"] = v = _ema(decay, state["v"], g2)
                    u = g * _rsqrt(v)
                else:
                    d1, d0 = dims

                    def on(d):  # the shard when it splits axis d
                        return shard if shard is not None and shard.dim == d else None

                    state["v_row"] = v_row = _ema(decay, state["v_row"], _mean(g2, d0, on(d0)))
                    state["v_col"] = v_col = _ema(decay, state["v_col"], _mean(g2, d1, on(d1)))
                    reduced_d1 = d1 - 1 if d1 > d0 else d1
                    row_factor = _rsqrt(v_row / _mean(v_row, reduced_d1, on(d1), keepdim=True))
                    u = g * row_factor.unsqueeze(d0) * _rsqrt(v_col).unsqueeze(d1)
                del g, g2
                p.copy_(p.float() - group["lr"] * u)
                state["step"] += 1
        return loss


class FusedOuterAdafactor(torch.optim.Optimizer):
    """:class:`Adafactor` for ``Linear`` weights (``(d_out, d_in)``) whose
    gradient arrives as ``(X, dY)`` factors in ``stash``; their ``.grad``
    must be None (the dense gradient is never formed). State per weight:
    ``step``, ``v_row`` (d_in,) and ``v_col`` (d_out,) in its dtype."""

    def __init__(self, params, lr: float, stash: FactorStash, shards: dict | None = None,
                 data_group=None):
        super().__init__(params, dict(lr=lr))
        self.stash = stash
        self.shards = shards or {}
        self.data_group = data_group

    @staticmethod
    def state_axes(full_shape) -> dict:
        """The weight axis each factor keeps: ``v_row`` the input axis,
        ``v_col`` the output axis."""
        return {"v_row": 1, "v_col": 0}

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr = group["lr"]
            for w in group["params"]:
                if w.grad is not None:
                    raise RuntimeError("a fused-Adafactor weight has a dense gradient: its "
                                       "layer's factor tap is missing")
                state = self.state[w]
                step = _init_step(state)
                shard = self.shards.get(w)
                n_out, n_in = shard.full_shape(w.shape) if shard else w.shape
                if "v_row" not in state:
                    state["v_row"] = w.new_zeros(w.shape[1])
                    state["v_col"] = w.new_zeros(w.shape[0])
                x, dy = self.stash.take(w)
                if self.data_group is not None:
                    x, dy = gather_rows(x, self.data_group), gather_rows(dy, self.data_group)
                xf, dyf = x.float(), dy.float()
                if self.data_group is not None:
                    dyf = dyf / dist.get_world_size(self.data_group)
                # Row and column mean squares of dW = xf^T dyf (Gram trick);
                # the Gram matrix over a split axis is summed over the shards.
                gram_dy, gram_x = dyf @ dyf.T, xf @ xf.T
                if shard is not None:
                    dist.all_reduce(gram_dy if shard.dim == 0 else gram_x, group=shard.group)
                row_sq = (xf * (gram_dy @ xf)).sum(0)
                col_sq = (dyf * (gram_x @ dyf)).sum(0)
                decay = _decay(step)
                state["v_row"] = v_row = _ema(decay, state["v_row"], row_sq / n_out + EPS)
                state["v_col"] = v_col = _ema(decay, state["v_col"], col_sq / n_in + EPS)
                # The factors in the state's dtype, as optax; applied in fp32.
                in_split = shard if shard is not None and shard.dim == 1 else None
                xs = xf * _rsqrt(v_row / _mean(v_row, 0, in_split)).float()
                dys = dyf * _rsqrt(v_col).float()
                for r in range(0, w.shape[0], BLOCK_ROWS):
                    rows = w[r : r + BLOCK_ROWS]
                    rows.copy_(torch.addmm(rows.float(), dys[:, r : r + BLOCK_ROWS].T, xs,
                                           alpha=-lr))
                state["step"] += 1
        return loss


class OptimizerGroups:
    """Several optimizers stepped as one, by name: ``zero_grad``, ``step``,
    ``state_dict`` (``{name: state_dict}``) and ``load_state_dict``;
    ``param_groups`` and ``state`` are theirs, in order."""

    def __init__(self, optimizers: dict):
        self.optimizers = optimizers

    def zero_grad(self, set_to_none: bool = True) -> None:
        for opt in self.optimizers.values():
            opt.zero_grad(set_to_none=set_to_none)

    def step(self) -> None:
        for opt in self.optimizers.values():
            opt.step()

    @property
    def param_groups(self) -> list:
        return [g for opt in self.optimizers.values() for g in opt.param_groups]

    @property
    def state(self) -> dict:
        return {p: s for opt in self.optimizers.values() for p, s in opt.state.items()}

    def state_dict(self) -> dict:
        return {name: opt.state_dict() for name, opt in self.optimizers.items()}

    def load_state_dict(self, state_dict: dict) -> None:
        if state_dict.keys() != self.optimizers.keys():
            raise ValueError(f"optimizer state for {sorted(state_dict)}, this run has "
                             f"{sorted(self.optimizers)}")
        for name, opt in self.optimizers.items():
            opt.load_state_dict(state_dict[name])
