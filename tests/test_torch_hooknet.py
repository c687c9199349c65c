"""The port's HookNet and seg views against the JAX package: the pyramid
encoder, HookNet's logits and BatchNorm statistics (fp32 and bf16, against
both of JAX's decoder layouts), the smp init, the weight converter, and the
seg ops and views (resnet10, 64 px views, 3 classes plus background).

Weights are drawn by the port's init and carried into JAX by the JAX
package's own converter (``torch_hooknet_to_flax``), which is cheaper than
tracing JAX's init. fp32 outputs are held to 1e-4 in eval mode (a
convolution sums in another order: measured below 6e-6); in train mode the
BatchNorms over a 4-sample batch amplify that rounding, so logits are held
to 5e-3 as in ``test_torch_models.py``, and running stats to 1e-5 in the
encoders and 1e-4 in the decoders (the same reasons as there).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msfwsi_tpu.data import pipeline as JP
from msfwsi_tpu.models.hooknet import HookNet as JHookNet
from msfwsi_tpu.models.resnet import get_encoder as j_get_encoder
from msfwsi_tpu.ops import augment as JA
from msfwsi_tpu.train.checkpoint import (flax_hooknet_to_torch, torch_hooknet_to_flax,
                                         torch_resnet_to_flax)
from msfwsi_tpu_torch.data import pipeline as P
from msfwsi_tpu_torch.models.hooknet import HookNet, build_hooknet
from msfwsi_tpu_torch.models.resnet import get_encoder, torch_style_init
from msfwsi_tpu_torch.ops import augment as A
from msfwsi_tpu_torch.train.checkpoint import jax_hooknet_to_torch, jax_msfwsi_to_torch
from torch_parity import numpy_tree, seg_view_draws, state_numpy, t

torch.set_num_threads(2)

B, SEG, CLASSES = 4, 64, 4
ARCH = "resnet10"


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=atol)


def _cuda_autocast_policy(monkeypatch):
    """Autocast on CUDA runs ``rsqrt`` (see ``test_torch_models.py``) and
    the nearest upsample in fp32, where the CPU's keeps bf16: do the same
    here, so that an activation that would leave bf16 on the card shows."""
    real_rsqrt, real_interpolate = torch.rsqrt, torch.nn.functional.interpolate
    monkeypatch.setattr(torch, "rsqrt", lambda x: real_rsqrt(x.float()))

    def interpolate(x, *a, **kw):
        return real_interpolate(x.float() if torch.is_autocast_enabled("cpu") else x, *a, **kw)

    monkeypatch.setattr(torch.nn.functional, "interpolate", interpolate)


# ---- the pyramid encoder ----------------------------------------------------

@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_pyramid_encoder_matches_jax(train):
    """The five maps (stem/2 before the max-pool, then layer1-4) and the
    running stats, fp32: maps within 1e-5 in eval mode; in train mode each
    BatchNorm normalizes by the batch's own statistics, which carries the
    ~1e-6 relative rounding of the convolutions through every layer at the
    activations' size (up to 7 here): maps within 1e-4 there, as the pooled
    features of ``test_torch_models.py`` (measured 3.7e-5). Eval maps and
    every stat within 1e-5 (measured 4.3e-6)."""
    x = np.random.default_rng(2).normal(size=(B, SEG, SEG, 3)).astype(np.float32)
    port = torch_style_init(get_encoder(ARCH), torch.Generator().manual_seed(2))
    params, stats = torch_resnet_to_flax(state_numpy(port))
    enc = j_get_encoder(ARCH)
    want, mutated = jax.jit(lambda v: enc.apply(v, jnp.asarray(x), train=train,
                                                features="pyramid", mutable=["batch_stats"]))(
        jax.tree.map(jnp.asarray, {"params": params, "batch_stats": stats}))
    port.train(train)
    got = port(t(x), features="pyramid")
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want] == [
        (B, 32, 32, 64), (B, 16, 16, 64), (B, 8, 8, 128), (B, 4, 4, 256), (B, 2, 2, 512)]
    for g, w in zip(got, want):
        _close(g, w, atol=1e-4 if train else 1e-5)
    new = jax_msfwsi_to_torch({"params": {}, "batch_stats": {"context_encoder":
                                                              mutated["batch_stats"]}})
    buffers = dict(port.named_buffers())
    for k, w in new.items():
        _close(buffers[k.split(".", 1)[1]], w.numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="features mode"):
        port(t(x), features="logits")


# ---- HookNet ---------------------------------------------------------------

@pytest.fixture(scope="module")
def hooknet():
    """Port HookNet weights, as JAX variables and as the port model."""
    model = build_hooknet(torch.Generator().manual_seed(0), arch=ARCH, classes=CLASSES)
    variables = torch_hooknet_to_flax(state_numpy(model))
    return model, numpy_tree(variables)


@pytest.fixture(scope="module")
def views():
    rng = np.random.default_rng(0)
    return [rng.normal(size=(B, SEG, SEG, 3)).astype(np.float32) for _ in range(2)]


def test_converter_matches_jax_converter(hooknet):
    """``jax_hooknet_to_torch`` gives ``flax_hooknet_to_torch``'s keys and
    values, which are the port module's own names, and round-trips the
    port's weights exactly."""
    model, variables = hooknet
    ours = jax_hooknet_to_torch(variables)
    theirs = flax_hooknet_to_torch(variables, ddp_prefix=False)
    assert sorted(ours) == sorted(theirs) == sorted(model.state_dict())
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)
        assert torch.equal(ours[k], model.state_dict()[k]), k
    assert any(".decoder.blocks.4.conv2.1.running_var" in k for k in ours)
    assert "target_branch.segmentation_head.0.bias" in ours


def _jax_forward(variables, x1, x2, train, dtype=jnp.float32, packed_tail=False):
    m = JHookNet(arch=ARCH, classes=CLASSES, dtype=dtype, packed_tail=packed_tail,
                 packed_logits=False)
    return jax.jit(lambda v: m.apply(v, jnp.asarray(x1), jnp.asarray(x2), train=train,
                                     mutable=["batch_stats"]))(
        jax.tree.map(jnp.asarray, variables))


@pytest.mark.parametrize("packed_tail", [False, True], ids=["unpacked", "packed"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_hooknet_forward_matches_jax(hooknet, views, train, packed_tail):
    """Both logits and every running stat, fp32, against JAX's unpacked
    decoder and its space-to-depth tail (``packed_tail=True,
    packed_logits=False``) on the same variables, the port's decoder
    unpacked and packed in turn. Logits within 1e-4 in
    eval mode, 5e-3 in train mode (measured 1.0e-4); stats within 1e-5 in
    the encoders (measured 6.1e-6) and 1e-4 in the decoders (measured, with
    the eval logits, 5.4e-6)."""
    model, variables = hooknet
    (jctx, jtgt), mutated = _jax_forward(variables, *views, train, packed_tail=packed_tail)
    port = HookNet(arch=ARCH, classes=CLASSES, packed_tail=packed_tail)
    port.load_state_dict(model.state_dict())
    port.train(train)
    ctx, tgt = port(t(views[0]), t(views[1]))
    assert tuple(ctx.shape) == tuple(tgt.shape) == (B, SEG, SEG, CLASSES)
    atol = 5e-3 if train else 1e-4
    _close(ctx, jctx, atol)
    _close(tgt, jtgt, atol)
    new = jax_hooknet_to_torch({"params": {}, "batch_stats": numpy_tree(mutated["batch_stats"])})
    buffers = dict(port.named_buffers())
    assert sorted(new) == sorted(buffers)
    for k, w in new.items():
        _close(buffers[k], w.numpy(), atol=1e-5 if ".encoder." in k else 1e-4)


def test_hooknet_bf16_autocast_matches_jax_bf16(hooknet, views, monkeypatch):
    """Under ``torch.autocast`` bf16 (with autocast's CUDA policy for
    rsqrt and the nearest upsample) against JAX at dtype bf16, eval mode:
    the decoder's BatchNorm gives bf16 as flax's does, and every decoder
    convolution takes bf16 (the upsample stays bf16, as JAX's repeat). The
    logits (up to 1.6) are held to 3e-2:
    two bf16 networks of 26 layers that round in different places differ
    by as much as JAX's own bf16 logits differ from its fp32 ones (2.1e-2
    on these inputs); measured 2.4e-2, at 1 of 65536 values."""
    _cuda_autocast_policy(monkeypatch)
    model, variables = hooknet
    (jctx, jtgt), _ = _jax_forward(variables, *views, False, dtype=jnp.bfloat16)
    model.eval()
    seen = []
    hooks = [m.register_forward_pre_hook(lambda m, args: seen.append(args[0].dtype))
             for name, m in model.named_modules()
             if ".decoder." in f".{name}." and isinstance(m, torch.nn.Conv2d)]
    with torch.autocast("cpu", dtype=torch.bfloat16):
        ctx, tgt = model(t(views[0]), t(views[1]))
    for h in hooks:
        h.remove()
    assert len(seen) == 20 and set(seen) == {torch.bfloat16}
    assert ctx.dtype == tgt.dtype == torch.bfloat16
    _close(ctx, jctx.astype(jnp.float32), atol=3e-2)
    _close(tgt, jtgt.astype(jnp.float32), atol=3e-2)


def test_context_hook_reaches_the_target_logits(hooknet, views):
    """The hook is the centre H/4 crop of context decoder block 1 (rows and
    columns 3:5 of 8 at 64 px): a change of the context image outside
    that region's receptive field still moves the target logits, and the
    target decoder's block 0 takes 512 + 128 channels."""
    model, _ = hooknet
    model.eval()
    conv = model.target_branch.decoder.blocks[0].conv1[0]
    assert conv.in_channels == 512 + 128 + 256
    with torch.no_grad():
        _, a = model(t(views[0]), t(views[1]))
        _, b = model(t(views[0]) * 0.5, t(views[1]))
    assert float((a - b).abs().max()) > 1e-4


def test_smp_init_statistics():
    """A fresh port HookNet at resnet18 width: each decoder conv's std within
    10% of kaiming-uniform's sqrt(2/fan_in), each head's of xavier's
    sqrt(2/(fan_in+fan_out)), head biases 0, every encoder conv within 10%
    of torch's sqrt(2/fan_out), decoder BatchNorms at 1 and 0."""
    model = build_hooknet(torch.Generator().manual_seed(5), arch="resnet18", classes=6)
    n = 0
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            k = m.kernel_size[0] * m.kernel_size[1]
            if ".segmentation_head." in f".{name}.":
                want = (2.0 / (k * (m.in_channels + m.out_channels))) ** 0.5
                assert float(m.bias.abs().max()) == 0.0
            elif ".decoder." in name:
                want = (2.0 / (k * m.in_channels)) ** 0.5
            else:
                want = (2.0 / (k * m.out_channels)) ** 0.5
            std = float(m.weight.std())
            assert abs(std / want - 1) < 0.1, (name, std, want)
            n += 1
    assert n == 2 * (20 + 10 + 1)
    bn = model.context_branch.decoder.blocks[2].conv2[1]
    assert bn.normalize_fp32 and float(bn.weight.min()) == float(bn.weight.max()) == 1.0
    assert float(bn.bias.abs().max()) == 0.0


# ---- seg ops ---------------------------------------------------------------

def test_center_crop_and_resizes_match_jax():
    """``center_crop`` and ``resize_nearest`` (with and without the folded
    flip, on odd and even sizes, so ties occur) exact; ``resize_bilinear``
    with the flip within fp32 1e-5 (measured 6.0e-8); the folded flip of the
    nearest resize differs from flipping its output at ties."""
    rng = np.random.default_rng(3)
    img = rng.random((3, 37, 50, 3)).astype(np.float32)
    mask = rng.integers(0, 6, (3, 37, 50)).astype(np.uint8)
    flip = np.array([True, False, True])
    for size in (16, 24, 25):
        np.testing.assert_array_equal(A.center_crop(t(img), size).numpy(),
                                      np.asarray(JA.center_crop(jnp.asarray(img), size)))
        for f in (None, flip):
            jf = None if f is None else jnp.asarray(f)
            tf = None if f is None else t(f)
            want = JA.resize_nearest(jnp.asarray(mask)[..., None], size, flip=jf)[..., 0]
            np.testing.assert_array_equal(A.resize_nearest(t(mask), size, flip=tf).numpy(),
                                          np.asarray(want))
            want = JA.resize_nearest(jnp.asarray(img), size, flip=jf)
            np.testing.assert_array_equal(A.resize_nearest(t(img), size, flip=tf).numpy(),
                                          np.asarray(want))
            _close(A.resize_bilinear(t(img), size, flip=tf),
                   JA.resize_bilinear(jnp.asarray(img), size, flip=jf), atol=1e-5)
    # 50 -> 25 columns samples at x = 2i + 0.5: every column is a tie
    folded = A.resize_nearest(t(mask), 25, flip=t(flip))
    flipped = torch.where(t(flip)[:, None, None], A.resize_nearest(t(mask), 25).flip(2),
                          A.resize_nearest(t(mask), 25))
    assert not torch.equal(folded, flipped)


def test_color_jitter_means_match_jax():
    """``return_means`` gives JAX's (mg, mg2) and ``means=`` applies injected
    means as JAX does, fp32: images within 1e-5 (measured 1.2e-7), means
    within 1e-6 (measured 2.4e-7)."""
    rng = np.random.default_rng(4)
    img = rng.random((B, 16, 16, 3)).astype(np.float32)
    crop = img[:, 4:12, 4:12]
    params = JA._sample_jitter_params(jax.random.key(4), B, JA.ColorJitterConfig(), jnp.float32)
    tparams = [t(p) for p in params]
    want, (mg, mg2) = JA.apply_color_jitter(jnp.asarray(img), *params, return_means=True)
    got, (tmg, tmg2) = A.apply_color_jitter(t(img), *tparams, return_means=True)
    _close(got, want, 1e-5)
    _close(tmg, mg, 1e-6)
    _close(tmg2, mg2, 1e-6)
    want = JA.apply_color_jitter(jnp.asarray(crop), *params, means=(mg, mg2))
    _close(A.apply_color_jitter(t(crop), *tparams, means=(tmg, tmg2)), want, 1e-5)


# ---- seg views -------------------------------------------------------------

def _seg_batch(seed=5, n=B, size=4 * SEG):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    masks = rng.integers(0, CLASSES, (n, size, size), dtype=np.uint8)
    return imgs, masks


@pytest.mark.parametrize("seed", [0, 1])
def test_seg_train_views_match_jax(seed):
    """Fed JAX's flip and jitter draws: images within fp32 1e-5 (measured
    6.0e-6: the hue op and the resampling sums round differently), both
    masks exact, int32, both flips present."""
    imgs, masks = _seg_batch(seed)
    jcfg = JP.AugConfig(seg_size=SEG)
    key = jax.random.key(seed)
    (jctx, jtgt), (jcm, jtm) = jax.jit(lambda k, i, m: JP.make_seg_train_views(k, i, m, jcfg))(
        key, jnp.asarray(imgs), jnp.asarray(masks))
    p = seg_view_draws(key, B, jnp.float32)
    assert 0 < int(p["flip"].sum()) < B
    (ctx, tgt), (cm, tm) = P.make_seg_train_views(t(imgs), t(masks), P.AugConfig(seg_size=SEG),
                                                  params=p)
    _close(ctx, jctx, 1e-5)
    _close(tgt, jtgt, 1e-5)
    assert cm.dtype == tm.dtype == torch.int32
    np.testing.assert_array_equal(cm.numpy(), np.asarray(jcm))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jtm))


def test_seg_train_views_draw_from_a_generator():
    imgs, masks = _seg_batch(6, n=8)
    cfg = P.AugConfig(seg_size=SEG)
    gen = torch.Generator().manual_seed(0)
    a = P.make_seg_train_views(t(imgs), t(masks), cfg, gen)
    b = P.make_seg_train_views(t(imgs), t(masks), cfg,
                               params=P.sample_seg_train_views(torch.Generator().manual_seed(0),
                                                               8, cfg))
    for x, y in zip((*a[0], *a[1]), (*b[0], *b[1])):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="generator"):
        P.make_seg_train_views(t(imgs), t(masks), cfg)


def test_seg_val_views_match_jax(monkeypatch):
    """Device views against JAX's ``make_seg_val_views`` (images within
    1e-5, measured 7.2e-7; masks exact) and host views equal to JAX's numpy
    path bit for bit (cv2 made unimportable so that JAX takes it)."""
    imgs, masks = _seg_batch(7, n=3, size=150)
    jcfg = JP.AugConfig(seg_size=SEG)
    (jctx, jtgt), (jcm, jtm) = JP.make_seg_val_views(jnp.asarray(imgs), jnp.asarray(masks), jcfg)
    cfg = P.AugConfig(seg_size=SEG)
    (ctx, tgt), (cm, tm) = P.make_seg_val_views(t(imgs), t(masks), cfg)
    _close(ctx, jctx, 1e-5)
    _close(tgt, jtgt, 1e-5)
    np.testing.assert_array_equal(cm.numpy(), np.asarray(jcm))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jtm))

    monkeypatch.setitem(sys.modules, "cv2", None)
    want = JP.make_seg_val_views_host(imgs, masks, jcfg)
    got = P.make_seg_val_views_host(imgs, masks, cfg, num_threads=2)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
