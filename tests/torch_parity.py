"""Shared helpers of the parity tests between the JAX package and the
PyTorch port (``tests/test_torch_*.py``).

Randomness is matched by parameters: :func:`jax_view_params` draws every
view parameter with the JAX package's own samplers, under exactly the key
tree of ``msfwsi_tpu/data/pipeline.py`` (``make_ssl_views`` ->
``_context_view`` / ``_target_view`` -> ``augment``), and returns them in
the structure of ``msfwsi_tpu_torch.data.pipeline.sample_ssl_views``.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import torch

from msfwsi_tpu.ops import augment as JA

_BLUR_LIMIT, _SIGMA_LIMIT = (19, 23), (0.1, 2.0)


def t(x) -> torch.Tensor:
    """numpy / JAX array -> CPU torch tensor (float64 stays float64)."""
    return torch.from_numpy(np.array(x))


def to_torch(tree):
    """A pytree of JAX arrays -> the same structure of CPU torch tensors."""
    return jax.tree.map(t, tree)


def blur_or_sharpen_draws(key, B: int, dtype):
    """JAX ``blur_or_sharpen``'s draws under ``key``, as port parameters."""
    k_apply, k_pick, k_blur, k_sharp = jax.random.split(key, 4)
    kmax = JA._blur_kmax(dtype, _BLUR_LIMIT, _SIGMA_LIMIT)
    return {
        "apply": jax.random.uniform(k_apply, (B, 1, 1, 1)) < 0.5,
        "pick_blur": jax.random.uniform(k_pick, (B, 1, 1, 1)) < 0.5,
        "taps": JA._blur_taps(k_blur, B, _BLUR_LIMIT, _SIGMA_LIMIT, kmax),
        "sharp": JA._sharpen_kern(k_sharp, B),
    }


def _context_draws(key, B: int, src_hw, cfg):
    k = jax.random.split(key, 5)
    return {
        "flip": jax.random.uniform(k[4], (B,)) < 0.5,
        "boxes": JA.sample_rrc_boxes(k[0], B, src_hw, cfg.rrc_scale),
        "jitter": JA._sample_jitter_params(k[1], B, JA.ColorJitterConfig(), cfg.dtype),
        "gray": jax.random.uniform(k[2], (B, 1, 1, 1)) < 0.2,
        "blur_or_sharpen": blur_or_sharpen_draws(k[3], B, cfg.dtype),
    }


def _target_draws(key, B: int, cfg):
    K = cfg.grid**2
    k = jax.random.split(key, 6)
    return {
        "jitter": JA._sample_jitter_params(k[0], B, JA.ColorJitterConfig(), cfg.dtype),
        "gray": jax.random.uniform(k[1], (B, 1, 1, 1)) < 0.2,
        "blur_or_sharpen": blur_or_sharpen_draws(k[2], B, cfg.dtype),
        "perm": jax.vmap(lambda kk: jax.random.permutation(kk, K))(jax.random.split(k[3], B)),
        "boxes": JA.sample_rrc_boxes(k[4], B * K, (cfg.tile_px, cfg.tile_px), cfg.rrc_scale),
        "flip": jax.random.uniform(k[5], (B * K,)) < 0.5,
    }


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def view_draws(key, B: int, src_hw, cfg):
    """All four views' draws of JAX ``make_ssl_views(key, ...)``, as JAX
    arrays (``jax_view_params`` converts them)."""
    kc1, kc2, kt1, kt2 = jax.random.split(key, 4)
    return {
        "context1": _context_draws(kc1, B, src_hw, cfg),
        "context2": _context_draws(kc2, B, src_hw, cfg),
        "target1": _target_draws(kt1, B, cfg),
        "target2": _target_draws(kt2, B, cfg),
    }


def jax_view_params(key, B: int, src_hw, cfg):
    """All four views' parameters of JAX ``make_ssl_views(key, ...)``;
    ``cfg`` is the JAX package's ``AugConfig``."""
    return to_torch(view_draws(key, B, tuple(src_hw), cfg))


def port_aug_config(cfg):
    """The port's AugConfig with the fields of a JAX ``AugConfig``."""
    from msfwsi_tpu_torch.data.pipeline import AugConfig

    return AugConfig(mean=tuple(cfg.mean), std=tuple(cfg.std), img_size=cfg.img_size,
                     grid=cfg.grid, tile_px=cfg.tile_px, rrc_scale=tuple(cfg.rrc_scale),
                     compute_dtype=cfg.compute_dtype)


def numpy_tree(tree):
    """A JAX variables pytree as nested dicts of numpy arrays."""
    return jax.tree.map(np.asarray, dict(tree))


def seg_view_draws(key, B: int, dtype):
    """JAX ``make_seg_train_views(key, ...)``'s draws (``split(key)`` into
    the jitter key and the flip key), as the port's parameters."""
    k_cj, k_flip = jax.random.split(key)
    flip = jax.random.uniform(k_flip, (B, 1, 1, 1)) < 0.5
    jitter = JA._sample_jitter_params(k_cj, B, JA.ColorJitterConfig(), dtype)
    return {"flip": t(flip[:, 0, 0, 0]), "jitter": [t(p) for p in jitter]}


def state_numpy(module) -> dict:
    """A module's state dict as numpy copies: a ``Tensor.numpy()`` view
    would let a later in-place update of the module (a train-mode
    BatchNorm's running stats) reach a JAX computation still reading the
    buffer asynchronously."""
    return {k: w.detach().numpy().copy() for k, w in module.state_dict().items()}
