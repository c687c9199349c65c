"""The port's packed decoder tail against the JAX package: the space-to-depth
functions and packed kernels (``ops/s2d.py``), the packed decoder block
(fused and unfused entry), the packed HookNet (eval and train,
``packed_from`` 2 and 3, packed logits, bf16 autocast), its state dict,
the export-block check, the packed custom-backward Dice, one packed
fine-tuning step at accum 1 and 2 and at world 2 (with its mean
gradient), the CLIs' ``--packed-tail`` and the bench's
``BENCH_PACKED_TAIL`` (resnet10, 64 px views, 3 classes plus background,
as ``test_torch_hooknet.py``).

Bounds: a packed conv against the logical conv within 1e-5 in fp32, as
``tests/test_s2d.py``; the packed HookNet within ``test_torch_hooknet.py``'s
fp32 bounds (logits 1e-4 in eval mode, 5e-3 in train mode; running stats
1e-5 in the encoders, 1e-4 in the decoders); the Dice value and gradient
within 1e-6 in fp32; the fine-tuning step within
``test_torch_finetune.py``'s bounds.
"""

import copy
import json
import logging
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from msfwsi_tpu.data import pipeline as JP
from msfwsi_tpu.models import hooknet as JH
from msfwsi_tpu.ops import losses as JL
from msfwsi_tpu.ops import s2d as JS2D
from msfwsi_tpu.parallel import MeshSpec, make_mesh
from msfwsi_tpu.train import evaluate as JEV
from msfwsi_tpu.train import finetune as JFT
from msfwsi_tpu.train.checkpoint import torch_hooknet_to_flax
from msfwsi_tpu.utils.logger import setup_logger as jax_setup_logger
from msfwsi_tpu_torch import bench, evaluate, ssl_finetune
from msfwsi_tpu_torch.data import pipeline as P
from msfwsi_tpu_torch.diag import packed_check as PC
from msfwsi_tpu_torch.diag.datapath import smooth_tiles, write_bcss_dataset, write_bcss_masks
from msfwsi_tpu_torch.models import hooknet as H
from msfwsi_tpu_torch.ops import losses as L
from msfwsi_tpu_torch.ops import s2d
from msfwsi_tpu_torch.train import checkpoint as C
from msfwsi_tpu_torch.train import evaluate as EV
from msfwsi_tpu_torch.train import finetune as FT
from msfwsi_tpu_torch.train.checkpoint import jax_hooknet_to_torch
from msfwsi_tpu_torch.utils import close_logger
from torch_dist import cases, finetune_step, run_world
from torch_parity import jax_tool, numpy_tree, seg_view_draws, state_numpy, t

torch.set_num_threads(2)

B, SEG, CLASSES = 4, 64, 4
NUM_FG = CLASSES - 1
ARCH = "resnet10"
CLASS_NAMES = ("a", "b", "c")


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=atol)


def _nchw(x):
    """NHWC numpy -> NCHW torch."""
    return t(x).permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1).detach().numpy()


def _hwio(w):
    """OIHW torch weight -> HWIO JAX kernel."""
    return jnp.asarray(w.permute(2, 3, 1, 0).numpy())


# ---- s2d ----------------------------------------------------------------------

def test_space_to_depth_functions_match_jax():
    """The round trip, the sub-position-major order (not
    ``F.pixel_unshuffle``'s), the upsample tile, the packed upsample, the
    parameter tile and the BatchNorm view, exact against the JAX module on
    the same values; a ``channels_last`` input stays ``channels_last``."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 10, 5)).astype(np.float32)
    got = s2d.space_to_depth(_nchw(x))
    np.testing.assert_array_equal(_nhwc(got), np.asarray(JS2D.space_to_depth(jnp.asarray(x))))
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert not torch.equal(got, F.pixel_unshuffle(_nchw(x), 2))
    assert torch.equal(s2d.depth_to_space(got), _nchw(x))
    packed = rng.normal(size=(2, 4, 5, 12)).astype(np.float32)
    np.testing.assert_array_equal(_nhwc(s2d.depth_to_space(_nchw(packed))),
                                  np.asarray(JS2D.depth_to_space(jnp.asarray(packed))))
    np.testing.assert_array_equal(_nhwc(s2d.upsample2x_packed(_nchw(x))),
                                  np.asarray(JS2D.upsample2x_packed(jnp.asarray(x))))
    up = np.repeat(np.repeat(x, 2, axis=1), 2, axis=2)
    assert torch.equal(s2d.upsample2x_packed(_nchw(x)), s2d.space_to_depth(_nchw(up)))
    np.testing.assert_array_equal(_nhwc(H._packed_upsample2x(_nchw(packed))),
                                  np.asarray(JH._packed_upsample2x(jnp.asarray(packed))))
    p = rng.normal(size=(6,)).astype(np.float32)
    np.testing.assert_array_equal(s2d.tile_params(t(p)).numpy(),
                                  np.asarray(JS2D.tile_params(jnp.asarray(p))))
    view = s2d.packed_bn_view(_nchw(packed).contiguous(memory_format=torch.channels_last), 3)
    want = np.asarray(JS2D.packed_bn_reduce_axes(jnp.asarray(packed), 3))  # (B, h, w, 4, C)
    np.testing.assert_array_equal(view.permute(0, 3, 4, 1, 2).numpy(), want)


def _conv(x, w, **kw):
    return F.conv2d(x, w, padding=1, **kw)


@pytest.mark.parametrize("kind", ["plain", "up", "skip", "grouped"])
def test_packed_kernels_match_jax_and_the_logical_conv(kind):
    """Each kernel builder against the JAX one after conversion to HWIO
    (the up kernel unflipped from ``conv_transpose2d``'s layout), within
    1e-6; and each packed conv against the logical conv composed with
    space-to-depth within 1e-5, as ``tests/test_s2d.py``. The inputs are
    offset so the SAME boundary shows."""
    rng = np.random.default_rng(1)
    x = t(rng.normal(size=(2, 5, 12, 16)).astype(np.float32) + 1.0)
    w = t(rng.normal(size=(4, 5, 3, 3)).astype(np.float32))
    if kind == "plain":
        k = s2d.pack_conv3x3_kernel(w)
        want_k = JS2D.pack_conv3x3_kernel(_hwio(w))
        got = _conv(s2d.space_to_depth(x), k)
        want = s2d.space_to_depth(_conv(x, w))
    elif kind == "up":
        k = s2d.pack_upconv3x3_kernel(w)  # (4Cin, 4Cout, 4, 4), flipped
        want_k = JS2D.pack_upconv3x3_kernel(_hwio(w))
        got = F.conv_transpose2d(s2d.space_to_depth(x), k, stride=2, padding=1)
        want = s2d.space_to_depth(_conv(F.interpolate(x, scale_factor=2, mode="nearest"), w))
        k = k.flip(2, 3).permute(1, 0, 2, 3)  # to OIHW of the lhs-dilated conv
    elif kind == "skip":
        k = s2d.pack_skipconv3x3_kernel(w)
        want_k = JS2D.pack_skipconv3x3_kernel(_hwio(w))
        got = F.conv2d(x, k, stride=2, padding=1)
        want = s2d.space_to_depth(_conv(x, w))
    else:
        w = t(rng.normal(size=(6, 8, 3, 3)).astype(np.float32))
        a, b = x[:, :3], t(rng.normal(size=(2, 5, 12, 16)).astype(np.float32))
        k = H._pack_grouped_kernel(w, (3, 5))
        want_k = JH._pack_grouped_kernel(_hwio(w), (3, 5))
        got = _conv(torch.cat([s2d.space_to_depth(a), s2d.space_to_depth(b)], 1), k)
        want = s2d.space_to_depth(_conv(torch.cat([a, b], 1), w))
    np.testing.assert_allclose(k.permute(2, 3, 1, 0).numpy(), np.asarray(want_k), atol=1e-6)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


def test_kernel_gradient_reaches_the_logical_weight():
    """The builders are einsums: a loss on the packed conv gives the logical
    weight the gradient of the logical conv (within 1e-4 of its norm)."""
    rng = np.random.default_rng(2)
    x = t(rng.normal(size=(2, 3, 8, 8)).astype(np.float32))
    w = t(rng.normal(size=(4, 3, 3, 3)).astype(np.float32)).requires_grad_(True)
    g = t(rng.normal(size=(2, 16, 4, 4)).astype(np.float32))
    (_conv(s2d.space_to_depth(x), s2d.pack_conv3x3_kernel(w)) * g).sum().backward()
    got = w.grad.clone()
    w.grad = None
    (s2d.space_to_depth(_conv(x, w)) * g).sum().backward()
    assert float((got - w.grad).norm() / w.grad.norm()) < 1e-4


# ---- the packed HookNet ---------------------------------------------------------

@pytest.fixture(scope="module")
def hooknet():
    model = H.build_hooknet(torch.Generator().manual_seed(0), arch=ARCH, classes=CLASSES)
    return model, numpy_tree(torch_hooknet_to_flax(state_numpy(model)))


@pytest.fixture(scope="module")
def views():
    rng = np.random.default_rng(0)
    return [rng.normal(size=(B, SEG, SEG, 3)).astype(np.float32) for _ in range(2)]


_JAX_FORWARDS: dict = {}


def _jax_forward(variables, views, train, packed_from, packed_logits, dtype=jnp.float32):
    """JAX's packed HookNet, once per configuration."""
    key = (train, packed_from, packed_logits, str(dtype))
    if key not in _JAX_FORWARDS:
        m = JH.HookNet(arch=ARCH, classes=CLASSES, dtype=dtype, packed_tail=True,
                       packed_from=packed_from, packed_logits=packed_logits)
        _JAX_FORWARDS[key] = jax.jit(lambda v: m.apply(
            v, jnp.asarray(views[0]), jnp.asarray(views[1]), train=train,
            mutable=["batch_stats"]))(jax.tree.map(jnp.asarray, variables))
    return _JAX_FORWARDS[key]


@pytest.mark.parametrize("packed_from,packed_logits", [(3, False), (2, False), (3, True)],
                         ids=["from3", "from2", "from3-logits"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_packed_hooknet_matches_jax(hooknet, views, train, packed_from, packed_logits):
    """Both logits and every running stat, fp32, against JAX's packed
    HookNet on the same variables, within ``test_torch_hooknet.py``'s
    bounds; the packed logits are (B, H/2, W/2, 4*classes) as JAX's."""
    model, variables = hooknet
    (jctx, jtgt), mutated = _jax_forward(variables, views, train, packed_from, packed_logits)
    port = H.HookNet(arch=ARCH, classes=CLASSES, packed_tail=True, packed_from=packed_from,
                     packed_logits=packed_logits)
    port.load_state_dict(model.state_dict())
    port.train(train)
    ctx, tgt = port(t(views[0]), t(views[1]))
    want_shape = (B, SEG // 2, SEG // 2, 4 * CLASSES) if packed_logits else (B, SEG, SEG, CLASSES)
    assert tuple(ctx.shape) == tuple(tgt.shape) == want_shape == tuple(jtgt.shape)
    assert port.emits_packed_logits == packed_logits
    atol = 5e-3 if train else 1e-4
    _close(ctx, jctx, atol)
    _close(tgt, jtgt, atol)
    new = jax_hooknet_to_torch({"params": {}, "batch_stats": numpy_tree(mutated["batch_stats"])})
    buffers = dict(port.named_buffers())
    assert sorted(new) == sorted(buffers)
    for k, w in new.items():
        _close(buffers[k], w.numpy(), atol=1e-5 if ".encoder." in k else 1e-4)


def _flax_block(block):
    """A port ``DecoderBlock``'s variables as JAX's ``PackedDecoderBlock``
    tree (``conv{1,2}/{conv,bn}``)."""
    sd = {k: v.numpy() for k, v in block.state_dict().items()}
    params, stats = {}, {}
    for n in ("conv1", "conv2"):
        params[n] = {"conv": {"kernel": sd[f"{n}.0.weight"].transpose(2, 3, 1, 0)},
                     "bn": {"scale": sd[f"{n}.1.weight"], "bias": sd[f"{n}.1.bias"]}}
        stats[n] = {"bn": {"mean": sd[f"{n}.1.running_mean"], "var": sd[f"{n}.1.running_var"]}}
    return jax.tree.map(jnp.asarray, {"params": params, "batch_stats": stats})


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("x_packed,with_skip", [(False, True), (True, True), (True, False)],
                         ids=["logical-skip", "packed-skip", "packed"])
@pytest.mark.parametrize("fused_entry", [True, False], ids=["fused", "unfused"])
def test_packed_decoder_block_matches_jax(fused_entry, x_packed, with_skip, train):
    """``DecoderBlock.forward_packed`` with the fused or the unfused entry
    against JAX's ``PackedDecoderBlock`` with the same ``fused_entry``, on
    the same variables (random BatchNorm parameters and running stats):
    the packed output and the running stats within 1e-5 in fp32, and the
    output within 1e-5 of the port's other entry, as ``tests/test_s2d.py``
    holds the two JAX entries."""
    rng = np.random.default_rng(5)
    in_ch, skip_ch, out_ch, h = 6, 5, 4, 8
    skip_ch = skip_ch if with_skip else 0
    block = H.DecoderBlock(in_ch, skip_ch, out_ch).train(train)
    with torch.no_grad():
        for k, v in block.state_dict().items():
            r = t(rng.normal(size=v.shape).astype(np.float32))
            v.copy_({"weight": 0.3 * r if v.dim() == 4 else 1 + 0.1 * r, "bias": 0.1 * r,
                     "running_mean": 0.1 * r, "running_var": 1 + 0.1 * r.abs()}[k.split(".")[-1]])
    variables = _flax_block(block)
    x = rng.normal(size=(2, h, h, 4 * in_ch if x_packed else in_ch)).astype(np.float32)
    skip_h = 4 * h if x_packed else 2 * h
    skip = rng.normal(size=(2, skip_h, skip_h, skip_ch)).astype(np.float32) if with_skip else None
    m = JH.PackedDecoderBlock(out_ch=out_ch, in_ch=in_ch, skip_ch=skip_ch, x_packed=x_packed,
                              fused_entry=fused_entry)
    want, mutated = m.apply(variables, jnp.asarray(x), None if skip is None else jnp.asarray(skip),
                            train=train, mutable=["batch_stats"])
    other = copy.deepcopy(block)
    args = (_nchw(x), None if skip is None else _nchw(skip))
    with torch.no_grad():
        got = block.forward_packed(*args, x_packed=x_packed, fused_entry=fused_entry)
        alt = other.forward_packed(*args, x_packed=x_packed, fused_entry=not fused_entry)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), alt.numpy(), rtol=0, atol=1e-5)
    want_stats = _flax_block(block)["batch_stats"] if not train else mutated["batch_stats"]
    for n in ("conv1", "conv2"):
        bn = getattr(block, n)[1]
        _close(bn.running_mean, want_stats[n]["bn"]["mean"], 1e-5)
        _close(bn.running_var, want_stats[n]["bn"]["var"], 1e-5)


def test_packed_hooknet_bf16_autocast_matches_jax_bf16(hooknet, views, monkeypatch):
    """Under ``torch.autocast`` bf16 (autocast's CUDA policy for rsqrt)
    against JAX's packed HookNet at dtype bf16, eval mode, held to
    ``test_torch_hooknet.py``'s bf16 bound, 3e-2. Every packed BatchNorm
    takes bf16 (so each packed conv ran in bf16) and gives bf16, and the
    logits are bf16."""
    real_rsqrt = torch.rsqrt
    monkeypatch.setattr(torch, "rsqrt", lambda x: real_rsqrt(x.float()))
    seen = []
    real_bn = H.packed_batch_norm

    def spy(bn, xp):
        y = real_bn(bn, xp)
        seen.append((xp.dtype, y.dtype))
        return y

    monkeypatch.setattr(H, "packed_batch_norm", spy)
    model, variables = hooknet
    (jctx, jtgt), _ = _jax_forward(variables, views, False, 3, False, dtype=jnp.bfloat16)
    port = H.configure_tail(copy.deepcopy(model).eval(), True, 3)
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        ctx, tgt = port(t(views[0]), t(views[1]))
    assert len(seen) == 2 * 4 and set(seen) == {(torch.bfloat16, torch.bfloat16)}
    assert ctx.dtype == tgt.dtype == torch.bfloat16
    _close(ctx, jctx.astype(jnp.float32), atol=3e-2)
    _close(tgt, jtgt.astype(jnp.float32), atol=3e-2)


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "bf16"])
def test_packed_train_step_matches_unpacked(hooknet, views, amp):
    """The packed tail against the unpacked decoder on one model, train
    mode, forward and backward, lam 0.5 (every parameter takes a
    gradient), within ``diag/packed_check.py``'s bounds (those
    ``chip_smoke.py`` holds the card to at full width)."""
    model, _ = hooknet
    rng = np.random.default_rng(9)
    batch = {"context": t(views[0]), "target": t(views[1]),
             "context_mask": t(rng.integers(0, CLASSES, (B, SEG, SEG))),
             "target_mask": t(rng.integers(0, CLASSES, (B, SEG, SEG)))}
    d = PC.packed_against_unpacked(copy.deepcopy(model), batch, amp)
    assert PC.within_bounds(d, PC.BOUNDS["bf16" if amp else "fp32"]), d


def test_state_dicts_are_the_same_packed_or_not(hooknet, views):
    """Identical keys and shapes packed and unpacked; each loads strictly
    into the other; a packed eval forward equals the unpacked one within
    1e-4, and ``unpacked`` restores the tail after."""
    model, _ = hooknet
    packed = H.HookNet(arch=ARCH, classes=CLASSES, packed_tail=True, packed_logits=True)
    plain = H.HookNet(arch=ARCH, classes=CLASSES)
    assert {k: v.shape for k, v in packed.state_dict().items()} == {
        k: v.shape for k, v in plain.state_dict().items()}
    packed.load_state_dict(model.state_dict(), strict=True)
    plain.load_state_dict(packed.state_dict(), strict=True)
    packed.eval()
    with torch.no_grad():
        with H.unpacked(packed):
            a = packed(t(views[0]), t(views[1]))
        assert packed.emits_packed_logits
        H.configure_tail(packed, True, packed_logits=False)
        b = packed(t(views[0]), t(views[1]))
    for x, y in zip(a, b):
        assert x.shape == (B, SEG, SEG, CLASSES)
        _close(x, y.numpy(), 1e-4)


def test_export_block_check_raises_as_jax(hooknet, views):
    """A packed tail that would reach the hook's block raises JAX's
    ``ValueError``, word for word."""
    model, variables = hooknet
    port = H.configure_tail(copy.deepcopy(model), True, 1)
    with pytest.raises(ValueError) as ours:
        port(t(views[0]), t(views[1]))
    m = JH.HookNet(arch=ARCH, classes=CLASSES, packed_tail=True, packed_from=1)
    with pytest.raises(ValueError) as theirs:
        m.apply(jax.tree.map(jnp.asarray, variables), jnp.asarray(views[0][:1]),
                jnp.asarray(views[1][:1]), train=False)
    assert str(ours.value) == str(theirs.value) == (
        "hook export block 1 must run in the logical domain (packed_from=1)")


# ---- the packed Dice ---------------------------------------------------------------

def _dice_case(seed=0, n=B, absent=None):
    rng = np.random.default_rng(seed)
    logits = (2 * rng.normal(size=(n, 8, 8, 4 * CLASSES))).astype(np.float32)
    target = rng.integers(0, CLASSES, (n, 16, 16)).astype(np.int32)
    if absent is not None:
        target[target == absent] = 0
    return logits, target


@pytest.mark.parametrize("classes,smooth,masked,absent", [
    (None, 0.0, False, None), ([1, 2, 3], 0.0, False, 2), ([1, 2, 3], 1.0, True, None),
    (None, 1.0, True, 1)], ids=["all", "fg-absent", "fg-smooth-mask", "all-smooth-mask-absent"])
def test_dice_loss_packed_matches_jax(classes, smooth, masked, absent):
    """Value and gradient against JAX's ``dice_loss_packed`` and
    ``jax.grad``, fp32 within 1e-6; equal to ``dice_loss`` on the logical
    logits within 1e-6; a masked sample gets a zero gradient."""
    logits, target = _dice_case(absent=absent)
    mask = np.array([True, False, True, True]) if masked else None
    jm = None if mask is None else jnp.asarray(mask)

    def jdice(z):
        return JL.dice_loss_packed(z, jnp.asarray(target), classes=classes, smooth=smooth,
                                   sample_mask=jm)

    z = t(logits).requires_grad_(True)
    tm = None if mask is None else t(mask)
    loss = L.dice_loss_packed(z, t(target), classes=classes, smooth=smooth, sample_mask=tm)
    loss.backward()
    assert float(loss) == pytest.approx(float(jdice(jnp.asarray(logits))), abs=1e-6)
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(jax.grad(jdice)(jnp.asarray(logits))),
                               atol=1e-6)
    logical = s2d.depth_to_space(t(logits).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert float(loss) == pytest.approx(float(L.dice_loss(logical, t(target), classes=classes,
                                                          smooth=smooth, sample_mask=tm)),
                                        abs=1e-6)
    if masked:
        assert float(z.grad[1].abs().max()) == 0.0


def test_dice_loss_packed_bf16_keeps_bf16():
    """bf16 logits: the value against JAX's on the same bf16 logits within
    1e-6 (the sums run in fp32 in both), ``dz`` stays bf16 and equals
    JAX's bf16 gradient within one bf16 rounding of it (both round one fp32
    result), and the function saves no fp32 copy of the logits."""
    logits, target = _dice_case(seed=3)
    zb = jnp.asarray(logits, jnp.bfloat16)
    classes = [1, 2, 3]

    def jdice(z):
        return JL.dice_loss_packed(z, jnp.asarray(target), classes=classes)

    z = t(np.asarray(zb.astype(jnp.float32))).to(torch.bfloat16).requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda x: saved.append((x.dtype, x.numel())) or x, lambda x: x):
        loss = L.dice_loss_packed(z, t(target), classes=classes)
    loss.backward()
    assert float(loss) == pytest.approx(float(jdice(zb)), abs=1e-6)
    assert z.grad.dtype == torch.bfloat16 and (torch.bfloat16, z.numel()) in saved
    assert not [n for dt, n in saved if dt == torch.float32 and n >= z.numel()]
    want = np.asarray(jax.grad(jdice)(zb).astype(jnp.float32))
    got = z.grad.float().numpy()
    np.testing.assert_allclose(got, want, rtol=2**-7, atol=1e-9)


# ---- the packed fine-tuning step ------------------------------------------------------

def _jax_state(jconfig, model):
    v = torch_hooknet_to_flax(state_numpy(model))
    params = jax.tree.map(jnp.asarray, v["params"])
    tx = optax.adam(jconfig.init_lr, b1=0.9, b2=0.999, eps=1e-8)
    return JFT.SegTrainState(step=jnp.zeros((), jnp.int32), params=params,
                             batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]),
                             opt_state=tx.init(params), tx=tx, model=jconfig.build_model())


def _tiles(seed, n=B):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, 4 * SEG, 4 * SEG, 3), dtype=np.uint8),
            rng.integers(0, CLASSES, (n, 4 * SEG, 4 * SEG), dtype=np.uint8))


def _check_state(state, jstate, lr):
    """``test_torch_finetune.py``'s bounds: every running stat rtol 1e-3 /
    atol 1e-5; each weight within 2 lr, at most 5% of a tensor outside
    rtol 1e-3 / atol 1e-5."""
    want = jax_hooknet_to_torch(numpy_tree({"params": jstate.params,
                                            "batch_stats": jstate.batch_stats}))
    got = state if isinstance(state, dict) else state.model.state_dict()
    buffers = {k for k in got if "running_" in k}
    for k, w in want.items():
        close = np.isclose(got[k].numpy(), w.numpy(), rtol=1e-3, atol=1e-5)
        if k in buffers:
            assert close.all(), (k, float((got[k] - w).abs().max()))
        else:
            assert (~close).mean() <= 0.05, (k, float((~close).mean()))
            assert float((got[k] - w).abs().max()) <= 2 * lr + 1e-6, k


@pytest.mark.parametrize("accum", [1, 2])
def test_packed_finetune_step_matches_jax(accum):
    """One fp32 fused step, packed tail and packed logits (the CLI's
    default), from the same weights and JAX's view draws against JAX's
    packed step: the loss to a relative 1e-4, the train counts exact (the
    packed argmax put back in sample order under accumulation), the
    running stats and weights within ``test_torch_finetune.py``'s bounds."""
    kw = dict(arch=ARCH, class_names=CLASS_NAMES, batch_size=B, amp=False, accum_steps=accum,
              packed_tail=True, packed_logits=True)
    jconfig = JFT.FinetuneConfig(seg_size=SEG, **kw)
    config = FT.FinetuneConfig(**kw)
    model = H.build_hooknet(torch.Generator().manual_seed(0), arch=ARCH, classes=CLASSES)
    jstate = _jax_state(jconfig, model)
    state = FT.create_finetune_state(config, device="cpu", model=model)
    assert state.model.emits_packed_logits
    imgs, masks = _tiles(accum)
    key = jax.random.key(3)
    jstate, jm = JFT.make_jitted_fused_finetune_step(jconfig, JP.AugConfig(seg_size=SEG),
                                                     donate=False)(
        jstate, jnp.asarray(imgs), jnp.asarray(masks), key)
    step = FT.make_fused_finetune_step(config, P.AugConfig(seg_size=SEG), device="cpu")
    m = step(state, t(imgs), t(masks), view_params=seg_view_draws(key, B, jnp.float32))
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4)
    for k in ("tp", "fp", "fn", "tn"):
        assert tuple(m[k].shape) == (B, NUM_FG)
        np.testing.assert_array_equal(m[k].numpy(), np.asarray(jm[k]), err_msg=k)
    _check_state(state, jstate, config.init_lr)


def _ft_batch():
    """``test_torch_distributed.py``'s trailing batch: 5 real tiles
    wrap-padded per rank to 4 + 4."""
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, (5, 4 * SEG, 4 * SEG, 3), dtype=np.uint8)
    masks = rng.integers(0, CLASSES, (5, 4 * SEG, 4 * SEG), dtype=np.uint8)
    order = [0, 1, 2, 0, 3, 4, 3, 4]
    return imgs[order], masks[order], np.array([1, 1, 1, 0, 1, 1, 0, 0], bool)


def test_packed_finetune_step_world_two_matches_jax_mesh(tmp_path):
    """The packed step at world 2 over gloo (the packed BatchNorm's
    statistics and the packed Dice's sums reduced over the data group) on
    a wrap-padded trailing batch, against JAX's packed ``MeshSpec(data=2)``
    step with the same ``valid``: equal losses on both ranks, JAX's loss to
    a relative 1e-4, the counts exact, the states within
    ``test_torch_finetune.py``'s bounds and equal on both ranks. Adam's
    first update does not see a scale of the gradient, so the mean
    gradient before the optimizer is also held, leaf by leaf within a
    relative norm of 1e-4 (measured: 2.5e-6 at most), to the unpacked
    ``dice_loss(group=)`` step at world 2 in the same run: the packed
    Dice's backward must scale as that differentiable all-reduce does. Its
    scale against the one-process packed step on the whole batch (the
    least-squares factor over all leaves) is 1 within 1e-3 (measured:
    1 - 9e-6; single leaves differ up to 5e-3 there, packed or not, as the
    split reorders the sums)."""
    kw = dict(arch=ARCH, class_names=CLASS_NAMES, batch_size=8, amp=False, packed_tail=True,
              packed_logits=True)
    imgs, masks, valid = _ft_batch()
    key = jax.random.key(7)
    params = seg_view_draws(key, 8, jnp.float32)
    plain_kw = {**kw, "packed_tail": False, "packed_logits": False}
    world = run_world(cases, 2, tmp_path, {
        "ft": (finetune_step, (kw, SEG, imgs, masks, valid, params, 2, True)),
        "plain": (finetune_step, (plain_kw, SEG, imgs, masks, valid, params, 2, True))})
    ranks = [r["ft"] for r in world]
    grads, plain = ranks[0]["grads"], world[0]["plain"]["grads"]
    assert sorted(grads) == sorted(plain) and len(plain) > 100
    for k, g in plain.items():
        assert float((grads[k] - g).norm()) <= 1e-4 * float(g.norm()), k
    whole = finetune_step(0, kw, SEG, imgs, masks, valid, params, 1, True)["grads"]
    scale = (sum(float((grads[k] * g).sum()) for k, g in whole.items())
             / sum(float(g.square().sum()) for g in whole.values()))
    assert scale == pytest.approx(1.0, abs=1e-3)
    jcfg = JFT.FinetuneConfig(seg_size=SEG, **kw)
    model = H.build_hooknet(torch.Generator().manual_seed(0), arch=ARCH, classes=CLASSES)
    mesh = make_mesh(MeshSpec(data=2), devices=jax.devices()[:2])
    jstep = JFT.make_jitted_fused_finetune_step(jcfg, JP.AugConfig(seg_size=SEG), mesh=mesh,
                                                donate=False)
    jstate, jm = jstep(_jax_state(jcfg, model), jnp.asarray(imgs), jnp.asarray(masks), key,
                       jnp.asarray(valid))
    m0, m1 = ranks[0]["metrics"], ranks[1]["metrics"]
    assert float(m0["loss"]) == float(m1["loss"])
    assert float(m0["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4)
    for k in ("tp", "fp", "fn", "tn"):
        np.testing.assert_array_equal(torch.cat([m0[k], m1[k]]).numpy(), np.asarray(jm[k]))
    assert ranks[0]["digests"] == ranks[1]["digests"]
    _check_state(ranks[0]["state"], jstate, jcfg.init_lr)


# ---- the CLIs and the bench ------------------------------------------------------------

class _Stop(Exception):
    pass


def _jax_finetune_configs(argv, tmp_path, monkeypatch):
    """The JAX CLI on ``argv`` up to its validation model: its train
    config and whether the validation model is packed (it stops there,
    before any compile of a step)."""
    seen = {}

    def capture_step(config, *a, **kw):
        seen["config"] = config
        return None

    def capture_val(model, *a, **kw):
        seen["val_packed"] = model.packed_tail
        raise _Stop

    monkeypatch.setattr(JFT, "make_jitted_fused_finetune_step", capture_step)
    monkeypatch.setattr(JEV, "make_chunk_stats_for_views", capture_val)
    cli = jax_tool("ssl_finetune")
    args = cli.build_parser().parse_args(argv + ["--log-dir", str(tmp_path)])
    Path(args.log_dir).mkdir(parents=True)
    try:
        with pytest.raises(_Stop):
            cli.main_worker(args)
    finally:
        close_logger(logging.getLogger("MSF-WSI"))
        jax_setup_logger.cache_clear()
    return seen


@pytest.mark.parametrize("flag", [[], ["--no-packed-tail"]], ids=["default", "no-packed-tail"])
def test_ssl_finetune_trains_packed_and_validates_unpacked(flag, tmp_path, monkeypatch):
    """The CLI with its default trains through the packed tail with packed
    logits and the packed Dice, and validates the same module unpacked, as
    the JAX CLI's config and validation model on the same flags say;
    ``--no-packed-tail`` trains unpacked as JAX's does. The
    ``best_ft_model.pth.tar`` of the run loads strictly into a HookNet of
    either tail, whose eval logits agree within 1e-4."""
    argv = ["-a", ARCH, "--seg-size", str(SEG), "-b", "4", "--synthetic", "4", "--epochs", "1",
            "-p", "1", "--seed", "0", *flag]
    want = _jax_finetune_configs(argv, tmp_path / "jax", monkeypatch)
    seen = {"train": set(), "val": set(), "loss": set()}
    real_loss, real_counts = FT.finetune_loss_fn, EV._chunk_counts

    def loss_spy(model, *a, **kw):
        seen["train"].add(model.emits_packed_logits)
        out = real_loss(model, *a, **kw)
        seen["loss"].add(tuple(out[1].shape))
        return out

    def counts_spy(model, *a, **kw):
        seen["val"].add(model.packed_tail)
        return real_counts(model, *a, **kw)

    monkeypatch.setattr(FT, "finetune_loss_fn", loss_spy)
    monkeypatch.setattr(EV, "_chunk_counts", counts_spy)
    out = ssl_finetune.main(argv + ["--device", "cpu", "--log-dir", str(tmp_path / "port")])
    packed = not flag
    jcfg = want["config"]
    assert (jcfg.packed_tail, jcfg.packed_logits, want["val_packed"]) == (packed, packed, False)
    assert seen["train"] == {packed} and seen["val"] == {False}
    n = len(ssl_finetune.CLASS_NAMES["bcss"]) + 1
    assert seen["loss"] == {(4, SEG // 2, SEG // 2, 4 * n) if packed else (4, SEG, SEG, n)}
    e = out["epochs"][0]
    assert np.isfinite(e["loss"]) and e["steps"] == 3
    assert out["state"].model.emits_packed_logits == packed  # restored after validation
    log = (Path(out["log_dir"]) / "log.txt").read_text()
    assert ("--packed-tail: training with decoder blocks 3-4" in log) == packed
    best = str(Path(out["log_dir"]) / C.BEST_FT_MODEL)
    x = t(np.random.default_rng(5).normal(size=(2, SEG, SEG, 3)).astype(np.float32))
    logits = []
    for tail in (True, False):
        m = C.load_ft_model(best, H.HookNet(arch=ARCH, classes=n, packed_tail=tail)).eval()
        with torch.no_grad():
            logits.append(m(x, x)[1])
    _close(logits[0], logits[1].numpy(), 1e-4)


@pytest.fixture(scope="module")
def bcss(tmp_path_factory):
    """``test_torch_eval_cli.py``'s BCSS-style directory and a port
    ``best_ft_model.pth.tar`` of a seeded resnet10 HookNet."""
    base = tmp_path_factory.mktemp("packed_eval")
    root = str(base / "data")
    tiles = smooth_tiles(14, 2 * SEG, seed=3)
    files = write_bcss_dataset(root, tiles)
    write_bcss_masks(root, files, (tiles[..., 0] // 43).astype(np.uint8), n_val=4)
    model = H.build_hooknet(torch.Generator().manual_seed(1), arch=ARCH, classes=6)
    (base / "ft").mkdir()
    return root, C.save_best_ft_model(str(base / "ft"), model, epoch=0, arch=ARCH)


def test_evaluate_packed_tail_matches_the_jax_cli(bcss, tmp_path, monkeypatch):
    """``evaluate --packed-tail`` against ``tools/evaluate.py
    --packed-tail`` on the same file, fp32 host views from both packages'
    numpy paths: the port's model runs packed with logical logits, and every
    summary score is within 1e-6 of JAX's."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    root, weights = bcss
    argv = ["-a", ARCH, "--seg-size", str(SEG), "--data-name", "bcss", "--train-data", root,
            "--weights", weights, "--val-chunk", "4", "--packed-tail"]
    seen = set()
    real_counts = EV._chunk_counts

    def counts_spy(model, *a, **kw):
        seen.add((model.packed_tail, model.emits_packed_logits))
        return real_counts(model, *a, **kw)

    monkeypatch.setattr(EV, "_chunk_counts", counts_spy)
    got = evaluate.main(argv + ["--device", "cpu", "--log-dir", str(tmp_path / "port")])
    jev = jax_tool("evaluate")
    args = jev.PARSER.parse_args(argv + ["--log-dir", str(tmp_path / "jax")])
    Path(args.log_dir).mkdir(parents=True)
    try:
        want = jev.main_worker(args)
    finally:
        close_logger(logging.getLogger("MSF-WSI"))
        jax_setup_logger.cache_clear()
    assert seen == {(True, False)}
    assert sorted(got["summary"]) == sorted(want)
    for k in want:
        assert got["summary"][k] == pytest.approx(want[k], abs=1e-6), k
    assert "--packed-tail: the model runs" in (Path(got["log_dir"]) / "log.txt").read_text()


def test_bench_packed_tail_names_the_metric(capsys):
    """``BENCH_PACKED_TAIL=1`` in modes ``hooknet`` (packed logits) and
    ``infer`` (logical logits) on the CPU: finite rates, the metric named
    ``,packed`` as ``bench.py`` names it."""
    env = {"BENCH_ARCH": ARCH, "BENCH_BATCH": "2", "BENCH_ITERS": "1", "BENCH_WARMUP": "1",
           "BENCH_REPEATS": "1", "BENCH_PACKED_TAIL": "1"}
    for mode, metric in (("hooknet", "hooknet_finetune_pairs_per_sec_per_chip"
                                     "[resnet10,b2,256px,packed]"),
                         ("infer", "hooknet_inference_tiles_per_sec_per_chip"
                                   "[resnet10,chunk2,256px,packed]")):
        bench.main(["--device", "cpu"], env={**env, "BENCH_MODE": mode}, seg_size=SEG)
        last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert last["metric"] == metric and np.isfinite(last["value"]) and last["value"] > 0
