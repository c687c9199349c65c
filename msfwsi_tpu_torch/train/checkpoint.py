"""Weight conversion from the JAX package's MSFWSI variables to the port.

:func:`jax_msfwsi_to_torch` takes the ``params`` and ``batch_stats`` of the
JAX package's MSFWSI as nested dicts of numpy arrays and returns the port's
state dict: the reference's key names (torchvision ResNet layout,
``Sequential`` indices for the heads), conv kernels HWIO -> OIHW, dense
kernels (in, out) -> (out, in).
"""

from __future__ import annotations

import re

import numpy as np
import torch

__all__ = ["jax_msfwsi_to_torch"]

# Flax submodule name -> index in the reference's nn.Sequential heads.
_HEAD_INDEX = {
    "projector": {"fc1": "0", "bn1": "1", "fc2": "3", "bn2": "4", "fc3": "6", "bn3": "7"},
    "predictor": {"fc1": "0", "bn1": "1", "fc2": "3"},
}
_HEAD = re.compile(r"^(context|target|inter)_(projector|predictor)_(\d+)$")
_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def _module_name(path) -> str:
    """Torch module name of a flax module path (without the leaf)."""
    top, rest = path[0], list(path[1:])
    if top in ("context_encoder", "target_encoder"):
        parts = [top]
        for p in rest:
            if re.fullmatch(r"layer\d+_\d+", p):
                parts.extend(p.split("_"))
            elif p == "downsample_conv":
                parts.append("downsample.0")
            elif p == "downsample_bn":
                parts.append("downsample.1")
            else:
                parts.append(p)
        return ".".join(parts)
    m = _HEAD.match(top)
    if m is None or len(rest) != 1:
        raise ValueError(f"unexpected MSFWSI variable path {'/'.join(path)}")
    side, kind, idx = m.groups()
    return f"{side}_{kind}.{idx}.{_HEAD_INDEX[kind][rest[0]]}"


def jax_msfwsi_to_torch(variables: dict) -> dict:
    """``{"params": ..., "batch_stats": ...}`` of the JAX MSFWSI -> the
    port's ``MSFWSI.state_dict()`` (float32 CPU tensors)."""
    out = {}
    for collection in ("params", "batch_stats"):
        for path, value in _leaves(variables[collection]):
            mod, leaf = _module_name(path[:-1]), path[-1]
            if leaf == "kernel":
                value = value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.T
                name = "weight"
            else:
                name = _LEAF[leaf]
            out[f"{mod}.{name}"] = torch.from_numpy(np.ascontiguousarray(value, np.float32))
    return out
