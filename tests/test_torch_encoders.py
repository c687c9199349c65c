"""The port's Bottleneck encoders against the JAX package: the block with
groups and width variants, resnet50's pooled features and pyramid, the
weight converter's keys and shapes for every arch of ``ARCH_SPECS`` (from
``jax.eval_shape``, no forward), ``feature_dims`` and the ImageNet lookup.

fp32: a convolution sums in another order (~1e-6 relative). A single
block's output is held to 1e-5 in eval mode and 1e-4 in train mode, where
every BatchNorm normalizes by its batch's own statistics, as
``tests/test_torch_hooknet.py`` holds the pyramid encoder; running stats to
1e-5. resnet50's bounds are given at its test."""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msfwsi_tpu.models import resnet as JR
from msfwsi_tpu.models.backbone import MSFWSI as JMSFWSI
from msfwsi_tpu.models.hooknet import HookNet as JHookNet
from msfwsi_tpu.train.checkpoint import (flax_hooknet_to_torch, flax_msfwsi_to_torch,
                                         torch_resnet_to_flax)
from msfwsi_tpu_torch.models import resnet as R
from msfwsi_tpu_torch.models.backbone import MSFWSI
from msfwsi_tpu_torch.models.hooknet import HookNet
from msfwsi_tpu_torch.train.checkpoint import jax_hooknet_to_torch, jax_msfwsi_to_torch
from msfwsi_tpu_torch.utils import imagenet
from torch_parity import numpy_tree, state_numpy, t

torch.set_num_threads(2)


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=atol)


def _encoder_sd(params, stats, prefix="context_encoder"):
    """Flax encoder variables -> the port's names through the port's MSFWSI
    converter, with the encoder prefix taken off."""
    sd = jax_msfwsi_to_torch({"params": {prefix: params}, "batch_stats": {prefix: stats}})
    return {k.split(".", 1)[1]: v for k, v in sd.items()}


# (inplanes, planes, stride, projection, groups, base_width)
BLOCKS = {
    "plain": (64, 16, 1, False, 1, 64),
    "strided-grouped": (32, 16, 2, True, 4, 8),
    "wide": (64, 16, 1, False, 1, 128),
    "resnext": (48, 16, 2, True, 8, 4),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", list(BLOCKS))
def test_bottleneck_matches_flax(case, train):
    inplanes, planes, stride, proj, groups, base_width = BLOCKS[case]
    norm = functools.partial(JR.BatchNormNamedStats, momentum=0.9, epsilon=1e-5)
    block = JR.Bottleneck(planes=planes, strides=stride, use_projection=proj, groups=groups,
                          base_width=base_width, norm=norm)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(4, 8, 8, inplanes)).astype(np.float32)
    v = numpy_tree(block.init(jax.random.key(1), jnp.asarray(x)))
    v["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.normal(0, 0.1, a.shape) if p[-1].key == "mean"
                      else rng.uniform(0.5, 1.5, a.shape)).astype(np.float32), v["batch_stats"])
    want, mutated = block.apply(jax.tree.map(jnp.asarray, v), jnp.asarray(x), train,
                                mutable=["batch_stats"])
    port = R.Bottleneck(inplanes, planes, stride, proj, groups=groups, base_width=base_width)
    sd = _encoder_sd({"layer1_0": v["params"]}, {"layer1_0": v["batch_stats"]})
    assert sorted(k.split(".", 2)[2] for k in sd) == sorted(port.state_dict())
    port.load_state_dict({k.split(".", 2)[2]: w for k, w in sd.items()})
    assert port.conv2.groups == groups
    assert port.conv2.out_channels == int(planes * base_width / 64) * groups
    port.train(train)
    got = port(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, want, atol=1e-4 if train else 1e-5)
    new = _encoder_sd({"layer1_0": {}}, {"layer1_0": numpy_tree(mutated["batch_stats"])})
    buffers = dict(port.named_buffers())
    for k, w in new.items():
        _close(buffers[k.split(".", 2)[2]], w.numpy(), atol=1e-5)


@pytest.fixture(scope="module")
def resnet50():
    port = R.torch_style_init(R.get_encoder("resnet50"), torch.Generator().manual_seed(5))
    params, stats = torch_resnet_to_flax(state_numpy(port))
    return port, {"params": params, "batch_stats": stats}


def _rel_err(got, want) -> float:
    """max |got - want| over max |want| (over 1e-12 if want is all 0)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def test_basic_block_refuses_groups_and_widths():
    """As torchvision's: a BasicBlock arch given a Bottleneck's groups or
    width raises instead of building plain blocks."""
    with pytest.raises(ValueError, match="groups=1 and base_width=64"):
        R.BasicBlock(64, 64, groups=32)
    with pytest.raises(ValueError, match="groups=1 and base_width=64"):
        R.ResNet((1, 1, 1, 1), R.BasicBlock, width_per_group=128)
    assert R.ResNet((1, 1, 1, 1), R.BasicBlock).layer1[0].conv1.groups == 1


class _Float64Jnp:
    """``jax.numpy`` with ``float32`` read as ``float64``. Put in place of the
    JAX resnet module's ``jnp`` under ``jax.enable_x64``, it runs that
    module's own code in float64, the BatchNorm statistics it casts to
    float32 included."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


# resnet50 at 32 px, train mode: per pyramid level (stem, layer1-4; the
# pooled features take layer1-4's), the bound on the port's fp32 output
# against JAX's fp32 output, and against JAX's float64 output (the truth),
# each relative to the level's largest value. Measured: 4.7e-7, 4.9e-6,
# 1.5e-5, 1.1e-4, 2.9e-2 from JAX fp32 (the pooled features: 1.9e-6,
# 8.4e-6, 1.0e-4, 2.9e-2) and 5.1e-7, 2.1e-6, 6.7e-6, 5.7e-5, 7.8e-3 from
# JAX float64 (JAX fp32 stands 7.7e-7 to 2.9e-2 from it).
TRAIN_FP32_BOUNDS = (2e-6, 2e-5, 6e-5, 5e-4, 6e-2)
TRAIN_TRUTH_BOUNDS = (2e-6, 1e-5, 3e-5, 2.5e-4, 2e-2)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_resnet50_pooled_and_pyramid_match_jax(resnet50, train, monkeypatch):
    """Both frameworks run resnet50 in fp32 and in float64 (JAX's own module
    under x64, with its statistics in float64 too; the port's modules
    ``.double()``). In float64 the port's maps and pooled features stand
    within 1e-9 of JAX's (measured 7.1e-11) and its running stats within
    1e-6 (measured 5.5e-8), relative to each tensor's largest value.

    fp32, eval mode: every map and pooled feature within 1e-5 of JAX's
    (measured 3e-6; without a zero-init residual the maps reach ~37), the
    running stats unchanged to 1e-5. fp32, train mode: each BatchNorm
    normalizes by its batch's own statistics, and at 32 px the deep stages
    hold few values a channel (layer4: 4), whose spread is small beside
    their mean, so fp32 rounding grows by mean/std at every stage. Each
    level is held to fixed bounds, ``TRAIN_FP32_BOUNDS`` against JAX's
    fp32 and ``TRAIN_TRUTH_BOUNDS`` against JAX's float64; the running
    stats to 3e-3 of JAX's fp32 ones (measured 1.3e-3) and 1.5e-3 of its
    float64 ones (measured 5.7e-4; JAX's fp32 ones stand 1.5e-3 away)."""
    drawn, v = resnet50
    x = np.random.default_rng(6).normal(size=(4, 32, 32, 3)).astype(np.float32)

    def run(enc, v, x):
        pyr, mut = enc.apply(v, x, train=train, features="pyramid", mutable=["batch_stats"])
        pooled, _ = enc.apply(v, x, train=train, mutable=["batch_stats"])
        return pyr, pooled, mut

    enc = JR.get_encoder("resnet50")
    pyr, pooled, mutated = jax.jit(lambda v: run(enc, v, jnp.asarray(x)))(
        jax.tree.map(jnp.asarray, v))
    with jax.enable_x64(True), monkeypatch.context() as m:
        m.setattr(JR, "jnp", _Float64Jnp())
        enc64 = JR.get_encoder("resnet50", dtype=jnp.float64)
        v64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)), v)
        pyr64, pooled64, mutated64 = jax.tree.map(np.asarray, jax.jit(
            lambda v: run(enc64, v, jnp.asarray(x, jnp.float64)))(v64))
    assert pyr64[-1].dtype == mutated64["batch_stats"]["bn1"]["var"].dtype == np.float64

    port = R.get_encoder("resnet50")
    sd = _encoder_sd(numpy_tree(v["params"]), numpy_tree(v["batch_stats"]))
    port.load_state_dict(sd)
    assert all(torch.equal(a, b) for a, b in zip(port.state_dict().values(),
                                                 drawn.state_dict().values()))
    exact = copy.deepcopy(port).double().train(train)
    port.train(train)
    with torch.no_grad():
        got = port(t(x), features="pyramid")
        got64 = exact(t(x).double(), features="pyramid")
    assert [tuple(g.shape) for g in got] == [(4, 16, 16, 64), (4, 8, 8, 256),
                                             (4, 4, 4, 512), (4, 2, 2, 1024), (4, 1, 1, 2048)]
    fp32_bounds = TRAIN_FP32_BOUNDS if train else (1e-5,) * 5
    for g, g64, w, w64, b32, b64 in zip(got, got64, pyr, pyr64, fp32_bounds,
                                       TRAIN_TRUTH_BOUNDS):
        assert _rel_err(g64, w64) <= 1e-9
        assert _rel_err(g, w) <= b32
        if train:
            assert _rel_err(g, w64) <= b64
    new = _encoder_sd({}, numpy_tree(mutated["batch_stats"]))
    new64 = _encoder_sd({}, mutated64["batch_stats"])
    buffers, buffers64 = dict(port.named_buffers()), dict(exact.named_buffers())
    assert sorted(new) == sorted(new64) == sorted(k for k in buffers if "running" in k)
    for k, w in new.items():
        assert _rel_err(buffers64[k], new64[k]) <= 1e-6
        if train:
            assert _rel_err(buffers[k], w) <= 3e-3
            assert _rel_err(buffers[k], new64[k]) <= 1.5e-3
        else:
            _close(buffers[k], w.numpy(), atol=1e-5)
    port.load_state_dict(sd)
    exact.load_state_dict(sd)
    with torch.no_grad():
        got, got64 = port(t(x)), exact(t(x).double())
    for g, g64, w, w64, b32, b64 in zip(got, got64, pooled, pooled64, fp32_bounds[1:],
                                       TRAIN_TRUTH_BOUNDS[1:]):
        assert tuple(g.shape) == w.shape
        assert _rel_err(g64, w64) <= 1e-9
        assert _rel_err(g, w) <= b32
        if train:
            assert _rel_err(g, w64) <= b64


def _zeros(tree):
    """numpy zeros of a tree of shapes, one byte of memory each (stride 0)."""
    return jax.tree.map(lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), tree)


def _keys_and_shapes(sd):
    return {k: tuple(v.shape) for k, v in sd.items()}


@pytest.mark.parametrize("arch", list(R.ARCH_SPECS))
def test_converters_cover_every_arch(arch):
    """The converters' keys and shapes against the JAX package's for the
    MSFWSI (scale 1, whose heads are the smallest) and the HookNet of
    ``arch``, and against the port's own modules (built on the meta
    device)."""
    key = jax.random.key(0)
    x, img = jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 64, 64, 3))
    rev = jnp.zeros((1, 1), jnp.int32)
    v = _zeros(jax.eval_shape(lambda: JMSFWSI(arch=arch, scale=1).init(
        key, (x, x), (x, x), (rev, rev), train=False)))
    ours = _keys_and_shapes(jax_msfwsi_to_torch(v))
    assert ours == _keys_and_shapes(flax_msfwsi_to_torch(v, ddp_prefix=False))
    with torch.device("meta"):
        assert ours == _keys_and_shapes(MSFWSI(arch=arch, scale=1).state_dict())
    if R.ARCH_SPECS[arch][0] is R.Bottleneck:
        assert "context_encoder.layer4.2.conv3.weight" in ours
        assert "target_encoder.layer1.0.downsample.1.running_var" in ours
    del v
    v = _zeros(jax.eval_shape(lambda: JHookNet(arch=arch, classes=6).init(
        key, img, img, train=False)))
    ours = _keys_and_shapes(jax_hooknet_to_torch(v))
    assert ours == _keys_and_shapes(flax_hooknet_to_torch(v, ddp_prefix=False))
    with torch.device("meta"):
        assert ours == _keys_and_shapes(HookNet(arch=arch, classes=6).state_dict())


@pytest.mark.parametrize("arch", list(R.ARCH_SPECS))
def test_feature_dims_and_imagenet_lookup(arch, tmp_path, monkeypatch):
    assert R.feature_dims(arch) == JR.feature_dims(arch)
    with torch.device("meta"):
        enc = R.get_encoder(arch)
    assert enc.feature_dims == JR.get_encoder(arch).feature_dims
    assert enc.pyramid_dims == JR.get_encoder(arch).pyramid_dims
    # every arch finds its <arch>-<hash>.pth, and no other arch's file
    monkeypatch.setenv("MSFWSI_IMAGENET_DIR", str(tmp_path))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    for other in R.ARCH_SPECS:
        (tmp_path / f"{other}-0123abcd.pth").write_bytes(b"")
    assert imagenet.resolve_imagenet_weights(arch) == str(tmp_path / f"{arch}-0123abcd.pth")


def test_a_bottleneck_arch_runs_through_the_fine_tuning_cli(tmp_path):
    """``-a`` takes the whole table: a resnext50_32x4d HookNet fine-tunes
    through the CLI (one step, 64 px views) and its best model loads back."""
    from msfwsi_tpu_torch import ssl_finetune
    from msfwsi_tpu_torch.train import checkpoint as C

    res = ssl_finetune.main(["-a", "resnext50_32x4d", "--seg-size", "64", "-b", "2",
                             "--synthetic", "1", "--epochs", "1", "--steps-per-epoch", "1",
                             "--device", "cpu", "-p", "1", "--seed", "0",
                             "--log-dir", str(tmp_path / "ft")])
    assert np.isfinite(res["epochs"][0]["loss"])
    model = C.load_ft_model(str(tmp_path / "ft" / C.BEST_FT_MODEL),
                            HookNet(arch="resnext50_32x4d", classes=6))
    assert model.target_branch.encoder.layer1[0].conv2.groups == 32
