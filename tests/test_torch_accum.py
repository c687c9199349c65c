"""Gradient accumulation of the port's SSL train step (``accum_steps``)
against the JAX package's (``tests/test_accum.py``'s semantics): the
interleaved microbatch partition, accumulation on an adjacent-duplicated
batch against no accumulation, and accum 2 against JAX's with Adam and with
the fused Adafactor (resnet10, scale 2, 32 px, b16 in microbatches of 8,
amp off: over 4 samples a BatchNorm then ReLU of the fuser head can sit at
a kink where the jitted JAX gradient stands 8% from float64's, see
``test_torch_factored.py``). The fused step's per-microbatch views and
fine-tuning: ``test_torch_accum_views.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msfwsi_tpu.train import ssl as JS
from msfwsi_tpu_torch.data.pipeline import AugConfig
from msfwsi_tpu_torch.train import ssl as S
from msfwsi_tpu_torch.train.checkpoint import jax_msfwsi_to_torch
from torch_parity import numpy_tree, ssl_random_views, ssl_steps_against_jax

torch.set_num_threads(2)

CONFIG = dict(arch="resnet10", scale=2, batch_size=16, amp=False)
FW = (0.1, 0.4, 0.7, 1.0)


def duplicate_batch(batch: dict) -> dict:
    """Every sample twice, adjacently (``tests/test_accum.py``'s
    ``duplicate_batch``): each interleaved microbatch of the doubled batch
    at accum 2 is the original batch."""
    B = min(v.shape[0] for v in batch.values())
    return {k: v.reshape(B, 1, -1, *v.shape[1:]).expand(B, 2, -1, *v.shape[1:])
            .reshape(-1, *v.shape[1:]) for k, v in batch.items()}


def test_slice_microbatch_matches_jax():
    """The port's partition equals ``JS.slice_microbatch`` on leaves with B
    and sample-major B*K leading axes, at accum 2 and 4, for a dict and a
    bare tensor; an accum that does not divide B raises."""
    rng = np.random.default_rng(0)
    batch = {"a": rng.normal(size=(8, 3, 2)).astype(np.float32),
             "b": rng.integers(0, 9, (32, 5)).astype(np.int32)}
    for accum in (2, 4):
        for i in range(accum):
            want = JS.slice_microbatch({k: jnp.asarray(v) for k, v in batch.items()}, accum, i)
            got = S.slice_microbatch({k: torch.from_numpy(v) for k, v in batch.items()}, accum, i)
            for k in batch:
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
            np.testing.assert_array_equal(
                S.slice_microbatch(torch.from_numpy(batch["a"]), accum, i).numpy(),
                np.asarray(want["a"]))
    with pytest.raises(ValueError, match="batch size 8 not divisible by accum_steps 3"):
        S.slice_microbatch(torch.from_numpy(batch["a"]), 3, 0)


@pytest.mark.parametrize("inter_opt", ["adam", "fused_adafactor"])
def test_duplicated_halves_match_unaccumulated(inter_opt):
    """accum 2 on the adjacent-duplicated batch gives the loss and weights
    of accum 1 on the batch (``tests/test_accum.py``'s tolerances: rtol 1e-6
    / atol 1e-6 with Adam, measured bit for bit; rtol 1e-5 / atol 1e-6 for
    the fused Adafactor, whose Gram sums run over twice the rows), and the
    running stats take each microbatch's updates: a microbatch moves every
    running stat by one affine map (two views, so ``r -> 0.81 r + c``), so
    where accum 1 gives ``r1 = 0.81 r0 + c``, accum 2 gives ``0.81 r1 + c``
    (within rtol 1e-5 / atol 1e-6)."""
    cfg = S.SSLConfig(**CONFIG, inter_opt=inter_opt)
    one, two = (S.create_ssl_state(cfg, device="cpu") for _ in range(2))
    before = {k: v.clone() for k, v in one.model.state_dict().items()}
    b = {k: torch.from_numpy(v) for k, v in ssl_random_views(8, 2, 32, 7).items()}
    m1 = S.ssl_train_step(one, b, FW)
    m2 = S.ssl_train_step(two, duplicate_batch(b), FW, accum_steps=2)
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-6)
    rtol = 1e-6 if inter_opt == "adam" else 1e-5
    s1, s2 = one.model.state_dict(), two.model.state_dict()
    buffers = {n for n, _ in one.model.named_buffers()}
    for k in s1:
        if k in buffers:
            c = s1[k] - 0.81 * before[k]
            torch.testing.assert_close(s2[k], 0.81 * s1[k] + c, rtol=1e-5, atol=1e-6)
        else:
            torch.testing.assert_close(s2[k].float(), s1[k].float(), rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("inter_opt", ["adam", "fused_adafactor"])
def test_accum_two_matches_jax(inter_opt):
    """Two train steps at accum 2, port against ``make_jitted_train_step``,
    each from equal states (``ssl_steps_against_jax``): the losses within
    rtol 1e-3 / atol 1e-5 and every parameter within
    ``tests/test_factored.py``'s bounds (``jax_suite_distances``), the
    running stats after each step's two microbatches included."""
    cfg = S.SSLConfig(**CONFIG, inter_opt=inter_opt, accum_steps=2)
    state = S.create_ssl_state(cfg, device="cpu")
    jcfg = JS.SSLConfig(img_size=32, mask_ratio=50, **CONFIG, inter_opt=inter_opt,
                        accum_steps=2)
    losses, _, jstate = ssl_steps_against_jax(jcfg, state, 2)
    got, want = zip(*losses)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)
    stats = jax_msfwsi_to_torch(numpy_tree({"params": jstate.params,
                                            "batch_stats": jstate.batch_stats}))
    for k, v in state.model.named_buffers():
        np.testing.assert_allclose(v.numpy(), stats[k].numpy(), rtol=1e-3, atol=1e-5, err_msg=k)


def test_indivisible_batch_raises():
    """A batch that ``accum_steps`` does not divide raises, in the train
    step and in the fused step (whose view parameters must come one set per
    microbatch)."""
    cfg = S.SSLConfig(**CONFIG, accum_steps=3)
    state = S.create_ssl_state(cfg, device="cpu")
    b = {k: torch.from_numpy(v) for k, v in ssl_random_views(4, 2, 32, 0).items()}
    with pytest.raises(ValueError, match="not divisible by accum_steps 3"):
        S.ssl_train_step(state, b, FW, accum_steps=3)
    aug = AugConfig(img_size=32, grid=2, tile_px=32)
    step = S.make_fused_step(cfg, aug, device="cpu")
    tiles = torch.zeros((4, 64, 64, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="not divisible by accum_steps 3"):
        step(state, tiles, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="1 view parameter sets for 3 microbatches"):
        step(state, tiles, view_params=[{}])
    assert state.step == 0
