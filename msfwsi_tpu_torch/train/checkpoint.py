"""Checkpoints of the port, and weight conversion from the JAX package.

Native format: the reference's ``checkpoint_{epoch:04d}.pth.tar``
(``ssl_train.py:375-387``), a ``torch.save`` of ``{epoch, arch, state_dict,
optimizer, scaler}`` with the state dict under the DDP ``module.`` prefix
and ``optimizer`` the Adam ``state_dict()``, so a resume restores weights,
BatchNorm statistics, Adam's moments and its step. A ``.pth.tar`` that the
JAX package wrote (``save_torch_file``) has no optimizer: it restores
weights and BatchNorm statistics only. The JAX package's Orbax directories
are not read; ``tools/export_torch.py`` converts them. Fine-tuning keeps
the reference's ``best_ft_model.pth.tar``, ``{epoch, arch, state_dict}``
of the HookNet under the ``module.`` prefix.

:func:`jax_msfwsi_to_torch` takes the ``params`` and ``batch_stats`` of the
JAX package's MSFWSI as nested dicts of numpy arrays and returns the port's
state dict: the reference's key names (torchvision ResNet layout,
``Sequential`` indices for the heads), conv kernels HWIO -> OIHW, dense
kernels (in, out) -> (out, in). :func:`jax_hooknet_to_torch` does the same
for the JAX package's HookNet, under smp's key names.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

__all__ = ["jax_msfwsi_to_torch", "jax_hooknet_to_torch", "checkpoint_path", "save_checkpoint",
           "resolve_checkpoint_arg", "latest_checkpoint", "load_torch_file", "restore_checkpoint",
           "BEST_FT_MODEL", "save_best_ft_model", "load_ft_model"]

BEST_FT_MODEL = "best_ft_model.pth.tar"


def checkpoint_path(log_dir: str, epoch: int) -> str:
    return os.path.join(log_dir, f"checkpoint_{epoch:04d}.pth.tar")


def _save_atomic(payload: dict, path: str) -> str:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def save_checkpoint(log_dir: str, state, epoch: int, arch: str) -> str:
    """Write ``state`` after (0-based) ``epoch`` as the reference's
    ``checkpoint_{epoch:04d}.pth.tar``, atomically (a temporary file, then
    ``os.replace``). ``epoch`` in the payload counts the epochs done, as
    the reference stores it; a resume takes its start epoch from the name."""
    path = checkpoint_path(log_dir, epoch)
    payload = {
        "epoch": epoch + 1,
        "arch": arch,
        "state_dict": {f"module.{k}": v for k, v in state.model.state_dict().items()},
        "optimizer": state.optimizer.state_dict(),
        "scaler": None,  # bf16 autocast needs no GradScaler
    }
    return _save_atomic(payload, path)


def save_best_ft_model(log_dir: str, model, epoch: int, arch: str) -> str:
    """Write a fine-tuned HookNet as the reference's
    ``<log_dir>/best_ft_model.pth.tar`` (``ssl_finetune.py:351-363``):
    ``{epoch, arch, state_dict}``, the state dict under ``module.``,
    atomically."""
    payload = {
        "epoch": epoch + 1,
        "arch": arch,
        "state_dict": {f"module.{k}": v for k, v in model.state_dict().items()},
    }
    return _save_atomic(payload, os.path.join(log_dir, BEST_FT_MODEL))


def load_ft_model(path: str, model, map_location="cpu"):
    """Load a fine-tuned HookNet file (``best_ft_model.pth.tar``, with or
    without ``module.``) into ``model`` in place; returns the model."""
    sd = {k.removeprefix("module."): v
          for k, v in load_torch_file(path, map_location, kind="hooknet").items()}
    model.load_state_dict(sd, strict=True)
    return model


def resolve_checkpoint_arg(path: str) -> str | None:
    """A user-supplied checkpoint path as found on disk: ``path`` itself if
    it exists, else the Orbax directory a ``.pth.tar``/``.pth`` name stands
    for in the JAX package's runs (which :func:`restore_checkpoint`
    refuses, naming the converter), else None."""
    if os.path.exists(path):
        return path
    for suffix in (".pth.tar", ".pth"):
        if path.endswith(suffix) and os.path.isdir(path[: -len(suffix)]):
            return path[: -len(suffix)]
    return None


def latest_checkpoint(ckpt_dir: str) -> str | None:
    """The ``checkpoint_NNNN.pth.tar`` of ``ckpt_dir`` with the highest
    epoch, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    # \d{4,}: {epoch:04d} widens past epoch 9999.
    pat = re.compile(r"checkpoint_(\d{4,})\.pth\.tar$")
    best = None
    for name in os.listdir(ckpt_dir):
        m = pat.match(name)
        if m and (best is None or int(m.group(1)) > best[0]):
            best = (int(m.group(1)), name)
    return os.path.join(ckpt_dir, best[1]) if best else None


_EXPORT_FLAGS = {"ssl": "--arch and --scale", "hooknet": "--arch and --classes"}


def _load(path: str, map_location, kind: str = "ssl") -> dict:
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory: an Orbax checkpoint of the JAX package, which the port "
            "does not read (it reads .pth.tar files). Convert it to a .pth.tar with `python "
            f"tools/export_torch.py --kind {kind} --checkpoint {path} --out <file>.pth.tar` "
            f"(with the run's {_EXPORT_FLAGS[kind]})."
        )
    obj = torch.load(path, map_location=map_location, weights_only=True)
    return obj if isinstance(obj, dict) else {"state_dict": obj}


def load_torch_file(path: str, map_location="cpu", kind: str = "ssl") -> dict:
    """The state dict of a torch checkpoint (its ``state_dict`` entry, or
    the whole file if it is a bare state dict), on ``map_location``;
    ``kind`` (``ssl`` or ``hooknet``) names the model in the error an
    Orbax directory raises."""
    obj = _load(path, map_location, kind)
    return obj.get("state_dict", obj)


def restore_checkpoint(path: str, state, map_location) -> bool:
    """Load a ``.pth.tar`` into ``state`` in place: the model's weights and
    BatchNorm statistics (keys with or without ``module.``) and, when the
    file has them, Adam's state and step. Returns whether the optimizer was
    restored (False for a file the JAX package wrote)."""
    obj = _load(path, map_location)
    sd = obj.get("state_dict", obj)
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    state.model.load_state_dict(sd, strict=True)
    opt = obj.get("optimizer")
    if not opt:
        return False
    state.optimizer.load_state_dict(opt)
    steps = [s["step"] for s in state.optimizer.state.values() if "step" in s]
    state.step = int(steps[0]) if steps else 0
    return True


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


def _encoder_name(parts) -> str:
    """Torchvision name of a flax ResNet module path: ``layer1_0`` ->
    ``layer1.0``, ``downsample_conv`` / ``downsample_bn`` ->
    ``downsample.0`` / ``downsample.1``."""
    out = []
    for p in parts:
        if re.fullmatch(r"layer\d+_\d+", p):
            out.extend(p.split("_"))
        elif p == "downsample_conv":
            out.append("downsample.0")
        elif p == "downsample_bn":
            out.append("downsample.1")
        else:
            out.append(p)
    return ".".join(out)


def _module_name(path) -> str:
    """Torch module name of a flax MSFWSI module path (without the leaf)."""
    top, rest = path[0], list(path[1:])
    if top in ("context_encoder", "target_encoder"):
        return f"{top}.{_encoder_name(rest)}"
    m = _HEAD.match(top)
    if m is None or len(rest) != 1:
        raise ValueError(f"unexpected MSFWSI variable path {'/'.join(path)}")
    side, kind, idx = m.groups()
    return f"{side}_{kind}.{idx}.{_HEAD_INDEX[kind][rest[0]]}"


def _hooknet_module_name(path) -> str:
    """Torch module name of a flax HookNet module path (without the leaf):
    ``<branch>/encoder/...`` as the SSL encoders,
    ``<branch>/decoder/block{i}/conv{n}/{conv|bn}`` ->
    ``<branch>.decoder.blocks.{i}.conv{n}.{0|1}``,
    ``<branch>/segmentation_head/conv`` -> ``<branch>.segmentation_head.0``."""
    branch, part, rest = path[0], path[1], list(path[2:])
    if part == "encoder":
        return f"{branch}.encoder.{_encoder_name(rest)}"
    if part == "decoder" and len(rest) == 3:
        block, convn, sub = rest
        idx = "0" if sub == "conv" else "1"
        return f"{branch}.decoder.blocks.{block.removeprefix('block')}.{convn}.{idx}"
    if part == "segmentation_head" and rest == ["conv"]:
        return f"{branch}.segmentation_head.0"
    raise ValueError(f"unexpected HookNet variable path {'/'.join(path)}")


def _convert(variables: dict, module_name) -> dict:
    out = {}
    for collection in ("params", "batch_stats"):
        for path, value in _leaves(variables[collection]):
            leaf = path[-1]
            if leaf == "kernel":
                value = value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.T
                name = "weight"
            else:
                name = _LEAF[leaf]
            out[f"{module_name(path[:-1])}.{name}"] = torch.from_numpy(
                np.ascontiguousarray(value, np.float32))
    return out


def jax_msfwsi_to_torch(variables: dict) -> dict:
    """``{"params": ..., "batch_stats": ...}`` of the JAX MSFWSI -> the
    port's ``MSFWSI.state_dict()`` (float32 CPU tensors)."""
    return _convert(variables, _module_name)


def jax_hooknet_to_torch(variables: dict) -> dict:
    """``{"params": ..., "batch_stats": ...}`` of the JAX HookNet (numpy
    dicts) -> the port's ``HookNet.state_dict()`` (float32 CPU tensors),
    under the reference's smp key names."""
    return _convert(variables, _hooknet_module_name)
