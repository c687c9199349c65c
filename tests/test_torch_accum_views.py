"""Accumulation through the fused steps against the JAX package: the SSL
fused step building each microbatch's views from its own slice of the
uint8 tiles (JAX's ``make_jitted_fused_step`` at accum 2, its views drawn
with ``fold_in(key, i)``), and the HookNet fine-tuning step at accum 2 with
an all-padding microbatch, against ``make_jitted_finetune_step``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from msfwsi_tpu.data import pipeline as JP
from msfwsi_tpu.train import finetune as JFT
from msfwsi_tpu.train import ssl as JS
from msfwsi_tpu.train.checkpoint import torch_hooknet_to_flax
from msfwsi_tpu_torch.models.hooknet import build_hooknet
from msfwsi_tpu_torch.train import finetune as FT
from msfwsi_tpu_torch.train import ssl as S
from msfwsi_tpu_torch.train.checkpoint import jax_hooknet_to_torch, jax_msfwsi_to_torch
from torch_parity import (jax_ssl_state_from_port, jax_suite_distances, jax_view_params,
                          numpy_tree, port_aug_config, state_numpy, t)

torch.set_num_threads(2)


def _buffers_close(model, want):
    for k, v in model.named_buffers():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-3, atol=1e-5, err_msg=k)


def test_fused_step_views_per_microbatch_match_jax():
    """One fused SSL step at b16, accum 2 (microbatches of 8), amp off, from
    the same weights: the port fed, for microbatch i, the view parameters
    JAX draws under ``fold_in(key, i)`` on tile slice i (``view_params`` a
    list). The loss within ``tests/test_torch_ssl.py``'s rtol 1e-4 / atol
    1e-5, every running stat (four updates each) within rtol 1e-3 / atol
    1e-5, every weight within ``jax_suite_distances``' Adam bounds (2.5 lr,
    5% of a tensor outside tol 5e-5). K1's launches are made once per view
    per microbatch (8 a step on the card)."""
    B = 16
    jcfg = JS.SSLConfig(arch="resnet10", scale=2, img_size=32, batch_size=B, amp=False,
                        accum_steps=2)
    jaug = JP.AugConfig(img_size=32, grid=2, tile_px=32)
    cfg = S.SSLConfig(arch="resnet10", scale=2, batch_size=B, amp=False, accum_steps=2)
    state = S.create_ssl_state(cfg, device="cpu")
    jstate = jax_ssl_state_from_port(jcfg, state.model)
    tiles = np.random.default_rng(0).integers(0, 256, (B, 64, 64, 3), dtype=np.uint8)
    key = jax.random.key(1)
    jstate, jm = JS.make_jitted_fused_step(jcfg, jaug, donate=False)(jstate, jnp.asarray(tiles),
                                                                     key)
    params = [jax_view_params(jax.random.fold_in(key, i), B // 2, (64, 64), jaug)
              for i in range(2)]
    m = S.make_fused_step(cfg, port_aug_config(jaug), device="cpu")(state, t(tiles),
                                                                    view_params=params)
    for k in jm:
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-4, abs=1e-5), k
    jax_suite_distances(state.model, jstate, cfg.init_lr, bf16=False, adafactor_heads=False)
    _buffers_close(state.model, jax_msfwsi_to_torch(numpy_tree(
        {"params": jstate.params, "batch_stats": jstate.batch_stats})))


ARCH, CLASSES, SEG = "resnet10", ("a", "b", "c"), 64


def test_finetune_accum_matches_jax():
    """One fine-tuning step at b4, accum 2, amp off, lam 1, with ``valid``
    False on samples 1 and 3: microbatch 1 (the odd samples) is all padding
    and adds loss 0. Against ``make_jitted_finetune_step`` from the same
    weights: the loss within rtol 1e-4, the per-sample counts exact and in
    the batch's sample order, ``valid`` echoed, every running stat within
    rtol 1e-3 / atol 1e-5 and every weight within 2 lr with at most 5% of a
    tensor outside rtol 1e-3 / atol 1e-5 (``tests/test_torch_finetune.py``'s
    bounds for Adam's first step)."""
    _finetune_accum_against_jax(4, np.array([True, False, True, False]))


def test_finetune_short_trailing_batch_matches_jax():
    """The epoch's trailing batch that accum divides, as ``ssl_finetune``
    passes it on one device: 2 samples at b4, accum 2, unpadded and without
    ``valid`` (two microbatches of 1), against the JAX step on the same
    short batch, which is what the JAX CLI runs there (``pad_last`` off on
    one device). The bounds of ``test_finetune_accum_matches_jax``."""
    _finetune_accum_against_jax(2, None)


def _finetune_accum_against_jax(B, valid):
    jcfg = JFT.FinetuneConfig(arch=ARCH, class_names=CLASSES, batch_size=B, amp=False,
                              seg_size=SEG, accum_steps=2)
    cfg = FT.FinetuneConfig(arch=ARCH, class_names=CLASSES, batch_size=B, amp=False,
                            accum_steps=2)
    model = build_hooknet(torch.Generator().manual_seed(0), arch=ARCH, classes=len(CLASSES) + 1)
    v = torch_hooknet_to_flax(state_numpy(model))
    jparams = jax.tree.map(jnp.asarray, v["params"])
    tx = optax.adam(jcfg.init_lr, b1=0.9, b2=0.999, eps=1e-8)
    jstate = JFT.SegTrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                               batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]),
                               opt_state=tx.init(jparams), tx=tx, model=jcfg.build_model())
    state = FT.create_finetune_state(cfg, device="cpu", model=model)
    rng = np.random.default_rng(17)
    batch = {"context": rng.normal(size=(B, SEG, SEG, 3)).astype(np.float32),
             "target": rng.normal(size=(B, SEG, SEG, 3)).astype(np.float32),
             "context_mask": rng.integers(0, 4, (B, SEG, SEG)).astype(np.int32),
             "target_mask": rng.integers(0, 4, (B, SEG, SEG)).astype(np.int32)}
    if valid is not None:
        batch["valid"] = valid
    jstate, jm = JFT.make_jitted_finetune_step(jcfg, donate=False)(
        jstate, {k: jnp.asarray(a) for k, a in batch.items()})
    m = FT.finetune_train_step(state, {k: t(a) for k, a in batch.items()}, 1.0, len(CLASSES),
                               accum_steps=2)
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4)
    for k in ("tp", "fp", "fn", "tn"):
        assert tuple(m[k].shape) == (B, len(CLASSES))
        np.testing.assert_array_equal(m[k].numpy(), np.asarray(jm[k]), err_msg=k)
    if valid is None:
        assert "valid" not in m and "valid" not in jm
    else:
        assert torch.equal(m["valid"], t(valid))
    want = jax_hooknet_to_torch(numpy_tree({"params": jstate.params,
                                            "batch_stats": jstate.batch_stats}))
    _buffers_close(state.model, want)
    for k, p in state.model.named_parameters():
        close = np.isclose(p.detach().numpy(), want[k].numpy(), rtol=1e-3, atol=1e-5)
        assert (~close).mean() <= 0.05, (k, float((~close).mean()))
        assert float((p.detach() - want[k]).abs().max()) <= 2 * cfg.init_lr + 1e-6, k


def test_finetune_duplicated_halves_match_unaccumulated():
    """accum 2 on the adjacent-duplicated batch gives accum 1's loss (rel
    1e-6) and weights (rtol / atol 1e-6; ``tests/test_accum.py``'s), and its
    per-sample counts as adjacent duplicate rows."""
    cfgs = [FT.FinetuneConfig(arch=ARCH, class_names=CLASSES, batch_size=4, amp=False,
                              accum_steps=a) for a in (1, 2)]
    states = [FT.create_finetune_state(c, device="cpu") for c in cfgs]
    rng = np.random.default_rng(17)
    b = {"context": torch.randn(4, SEG, SEG, 3, generator=torch.Generator().manual_seed(1)),
         "target": torch.randn(4, SEG, SEG, 3, generator=torch.Generator().manual_seed(2)),
         "context_mask": t(rng.integers(0, 4, (4, SEG, SEG))),
         "target_mask": t(rng.integers(0, 4, (4, SEG, SEG)))}
    dup = {k: v.repeat_interleave(2, dim=0) for k, v in b.items()}
    m1 = FT.finetune_train_step(states[0], b, 1.0, len(CLASSES))
    m2 = FT.finetune_train_step(states[1], dup, 1.0, len(CLASSES), accum_steps=2)
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-6)
    for k in ("tp", "fp", "fn", "tn"):
        assert torch.equal(m2[k][0::2], m1[k]) and torch.equal(m2[k][1::2], m1[k])
    p1, p2 = (dict(s.model.named_parameters()) for s in states)
    for k in p1:
        torch.testing.assert_close(p2[k], p1[k], rtol=1e-6, atol=1e-6)
