"""Port parity of the SSL view pipeline: jigsaw geometry (exact), every
augmentation apply op on JAX-sampled parameters (fp32, atol 1e-5), the
port's samplers against the JAX samplers' distributions, and
``make_ssl_views`` as a whole."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msfwsi_tpu.data import pipeline as JP
from msfwsi_tpu.ops import augment as JA
from msfwsi_tpu.ops import geometry as JG
from msfwsi_tpu_torch.data import pipeline as P
from msfwsi_tpu_torch.ops import augment as A
from msfwsi_tpu_torch.ops import geometry as G
from torch_parity import blur_or_sharpen_draws, port_aug_config, t, to_torch, view_draws

torch.set_num_threads(2)

ATOL = 1e-5


def _img(shape, seed=0):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=atol)


# ---------------------------------------------------------------- geometry


def test_geometry_is_exact():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 255, (3, 64, 96, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        G.batched_blockshaped(t(x), 32, 32).numpy(), np.asarray(JG.batched_blockshaped(x, 32, 32))
    )
    perm = np.stack([rng.permutation(16) for _ in range(5)])
    inv = G.invert_permutation(t(perm)).numpy()
    np.testing.assert_array_equal(inv, JG.invert_permutation(perm))
    feats = rng.normal(size=(5, 16, 7)).astype(np.float32)
    np.testing.assert_array_equal(
        G.unshuffle_features(t(feats), t(inv)).numpy(), JG.unshuffle_features(feats, inv)
    )
    with pytest.raises(ValueError):
        G.batched_blockshaped(t(x), 30, 32)
    for pad in (1, 8):  # reflect-101 == numpy "reflect"
        np.testing.assert_array_equal(
            G.reflect_pad_hw(t(x), pad).numpy(),
            np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)), mode="reflect"),
        )


# ---------------------------------------------------------------- apply ops


def test_grayscale_and_normalize():
    img = _img((2, 8, 8, 3))
    _close(A.rgb_to_grayscale(t(img)), JA.rgb_to_grayscale(jnp.asarray(img)))
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    _close(A.normalize(t(img), mean, std), JA.normalize(jnp.asarray(img), mean, std))


def test_color_jitter_on_jax_params():
    B = 16
    img = _img((B, 16, 16, 3), seed=1)
    key = jax.random.key(3)
    cfg = JA.ColorJitterConfig(p=1.0)  # every sample jittered

    @jax.jit
    def oracle(k, x):  # the default p=0.8 leaves some samples untouched
        every = JA._sample_jitter_params(k, B, cfg, jnp.float32)
        default = JA._sample_jitter_params(k, B, JA.ColorJitterConfig(), jnp.float32)
        return every, JA.apply_color_jitter(x, *every), default, JA.color_jitter(k, x)

    every, want_every, default, want = to_torch(oracle(key, jnp.asarray(img)))
    _close(A.apply_color_jitter(t(img), *every), want_every)
    _close(A.apply_color_jitter(t(img), *default), want)


def test_to_gray_on_jax_params():
    B = 16
    img = _img((B, 8, 8, 3), seed=2)
    key = jax.random.key(4)
    apply = t(jax.random.uniform(key, (B, 1, 1, 1)) < 0.2)
    _close(A.apply_to_gray(t(img), apply), JA.to_gray(key, jnp.asarray(img)))


def test_gaussian_blur_and_sharpen_on_jax_params():
    B = 4
    img = _img((B, 32, 24, 3), seed=3)
    taps, blurred, sharp, sharpened = to_torch(jax.jit(lambda k, x: (
        JA._blur_taps(k, B, (19, 23), (0.1, 2.0), 23), JA.gaussian_blur(k, x),
        JA._sharpen_kern(k, B), JA.sharpen(k, x),
    ))(jax.random.key(5), jnp.asarray(img)))
    _close(A.apply_gaussian_blur(t(img), taps), blurred)
    _close(A.apply_sharpen(t(img), sharp), sharpened)


def _jax_blur_or_sharpen(key, img, dtype):
    """JAX ``blur_or_sharpen`` of ``img`` in ``dtype`` (returned as fp32)
    and its draws."""
    B = img.shape[0]
    return to_torch(jax.jit(lambda k, x: (
        blur_or_sharpen_draws(k, B, dtype),
        JA.blur_or_sharpen(k, x.astype(dtype)).astype(jnp.float32),
    ))(key, jnp.asarray(img)))


def test_blur_or_sharpen_on_jax_params():
    B = 8
    img = _img((B, 32, 32, 3), seed=4)
    params, want = _jax_blur_or_sharpen(jax.random.key(6), img, jnp.float32)
    assert params["taps"].shape == (B, 23)
    _close(A.apply_blur_or_sharpen(t(img), params), want)


def test_blur_or_sharpen_dispatch(monkeypatch):
    """Half precision with C=3 and 8-aligned H, W > 8 goes through the fused
    op (its plain version on the CPU) and stays within the JAX suite's bf16
    bound of the JAX op; fp32 or unaligned shapes compute both ops."""
    calls = []
    real = A.blur_or_sharpen_fused
    monkeypatch.setattr(A, "blur_or_sharpen_fused", lambda *a: calls.append(1) or real(*a))
    B = 8
    img = _img((B, 32, 32, 3), seed=5)
    params, want = _jax_blur_or_sharpen(jax.random.key(7), img, jnp.bfloat16)
    assert params["taps"].shape == (B, 17)
    got = A.apply_blur_or_sharpen(t(img).bfloat16(), params)
    assert calls and got.dtype == torch.bfloat16
    _close(got, want, atol=2e-2)

    calls.clear()
    A.apply_blur_or_sharpen(t(img), A.sample_blur_or_sharpen(_gen(), B, torch.float32))
    A.apply_blur_or_sharpen(t(_img((B, 20, 32, 3))).bfloat16(), params)  # H % 8 != 0
    assert not calls


def test_blur_taps_and_sharpen_kernels_from_draws():
    B = 64

    @jax.jit
    def oracle(key):
        k_size, k_sigma = jax.random.split(key)
        k_a, k_l = jax.random.split(key)
        return {
            "ksize": 19 + 2 * jax.random.randint(k_size, (B,), 0, 3),
            "sigma": jax.random.uniform(k_sigma, (B,), minval=0.1, maxval=2.0),
            "taps": {kmax: JA._blur_taps(key, B, (19, 23), (0.1, 2.0), kmax) for kmax in (23, 17)},
            "a": jax.random.uniform(k_a, (B, 1, 1), minval=0.2, maxval=0.5)[:, 0, 0],
            "li": jax.random.uniform(k_l, (B, 1, 1), minval=0.5, maxval=1.0)[:, 0, 0],
            "sharp": JA._sharpen_kern(key, B),
        }

    d = to_torch(oracle(jax.random.key(8)))
    for kmax, want in d["taps"].items():
        _close(A.blur_taps_from_draws(d["ksize"], d["sigma"], kmax), want, atol=1e-6)
    _close(A.sharpen_kern_from_draws(d["a"], d["li"]), d["sharp"], atol=1e-6)


@pytest.mark.parametrize(
    "src_hw,scale", [((64, 64), (0.5, 1.0)), ((48, 96), (0.08, 1.0)), ((32, 64), (1.5, 2.0))],
    ids=["square", "wide", "fallback"],
)
def test_rrc_boxes_from_draws_exact(src_hw, scale):
    B, attempts = 256, 10
    key = jax.random.key(9)
    ratio = (3 / 4, 4 / 3)
    k_area, k_ratio, k_i, k_j = jax.random.split(key, 4)
    area_frac = jax.random.uniform(k_area, (B, attempts), minval=scale[0], maxval=scale[1])
    log_ratio = jax.random.uniform(k_ratio, (B, attempts), minval=math.log(ratio[0]),
                                   maxval=math.log(ratio[1]))
    got = A.rrc_boxes_from_draws(
        t(area_frac), t(log_ratio), t(jax.random.uniform(k_i, (B,))),
        t(jax.random.uniform(k_j, (B,))), src_hw, ratio,
    )
    want = JA.sample_rrc_boxes(key, B, src_hw, scale, ratio)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_crop_and_resize_on_jax_boxes():
    B = 6
    img = _img((B, 40, 56, 3), seed=6)
    key = jax.random.key(10)
    boxes = JA.sample_rrc_boxes(key, B, (40, 56))
    flip = jax.random.uniform(jax.random.key(11), (B,)) < 0.5
    want = jax.jit(lambda x, b, f: JA.crop_and_resize_mxu(x, b, 24, flip=f))(
        jnp.asarray(img), boxes, flip
    )
    got = A.crop_and_resize_mxu(t(img), tuple(t(b) for b in boxes), 24, flip=t(flip))
    _close(got, want)


# ---------------------------------------------------------------- samplers


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_jitter_and_gray_samplers_match_jax_distributions():
    n = 4000
    cfg = A.ColorJitterConfig()
    fb, fc, fs, fh, perm, apply = A.sample_jitter_params(_gen(), n, cfg, torch.float32)
    jfb, _, _, jfh, jperm, japply = JA._sample_jitter_params(jax.random.key(0), n, cfg, jnp.float32)
    for ours, theirs, lo, hi in ((fb, jfb, 0.6, 1.4), (fc, jfb, 0.6, 1.4), (fs, jfb, 0.6, 1.4),
                                 (fh, jfh, -0.1, 0.1)):
        assert float(ours.min()) >= lo and float(ours.max()) < hi
        assert abs(float(ours.mean()) - float(jnp.mean(theirs))) < 0.02
        assert abs(float(ours.std()) - float(jnp.std(theirs))) < 0.02
    assert (perm.sort(dim=1).values == torch.arange(4)).all()
    for pos in range(4):  # each op equally likely at each position, as in JAX
        ours = np.bincount(perm[:, pos].numpy(), minlength=4) / n
        theirs = np.bincount(np.asarray(jperm[:, pos]), minlength=4) / n
        np.testing.assert_allclose(ours, theirs, atol=0.04)
    assert abs(float(apply.float().mean()) - float(jnp.mean(japply))) < 0.03
    assert abs(float(A.sample_to_gray(_gen(1), n).float().mean()) - 0.2) < 0.03


def test_blur_or_sharpen_sampler_distribution():
    n = 3000
    p = A.sample_blur_or_sharpen(_gen(2), n, torch.float32)
    assert abs(float(p["apply"].float().mean()) - 0.5) < 0.03
    assert abs(float(p["pick_blur"].float().mean()) - 0.5) < 0.03
    taps = p["taps"]
    assert taps.shape == (n, 23)
    torch.testing.assert_close(taps.sum(1), torch.ones(n))
    torch.testing.assert_close(taps, taps.flip(1))  # symmetric
    # wide sigmas keep every tap inside the drawn ksize above zero
    ksize = (A.sample_blur_taps(_gen(6), n, sigma_limit=(20.0, 30.0)) > 0).sum(1)
    np.testing.assert_allclose(
        [float((ksize == k).float().mean()) for k in (19, 21, 23)], [1 / 3] * 3, atol=0.03
    )
    assert A.sample_blur_or_sharpen(_gen(3), 8, torch.bfloat16)["taps"].shape == (8, 17)
    sk = p["sharp"]
    a = -sk[:, 0, 0]
    assert float(a.min()) >= 0.2 and float(a.max()) < 0.5
    li = (sk[:, 1, 1] - (1 - a)) / a - 8
    assert float(li.min()) >= 0.5 - 1e-4 and float(li.max()) < 1.0 + 1e-4


def test_rrc_sampler_matches_jax_distribution():
    n, src = 4000, (64, 64)
    top, left, h, w = A.sample_rrc_boxes(_gen(4), n, src)
    jt, jl, jh, jw = (np.asarray(b) for b in JA.sample_rrc_boxes(jax.random.key(1), n, src))
    assert (top >= 0).all() and (left >= 0).all()
    assert (top + h <= 64).all() and (left + w <= 64).all()
    area = (h * w).float() / 64**2
    jarea = jh * jw / 64**2
    assert abs(float(area.mean()) - jarea.mean()) < 0.01
    aspect = (w.float() / h.float()).log()
    assert abs(float(aspect.mean()) - np.log(jw / jh).mean()) < 0.02
    assert abs(float(top.float().mean()) - jt.mean()) < 0.5


# ---------------------------------------------------------------- views


@pytest.fixture(scope="module")
def jax_views():
    """JAX ``make_ssl_views`` in both jigsaw modes and its draws, from one compile."""
    B = 2
    jcfg = JP.AugConfig(img_size=32, grid=2, tile_px=32)
    tiles = np.random.default_rng(7).integers(0, 256, (B, 64, 64, 3), dtype=np.uint8)
    both, draws = jax.jit(lambda k, x: (
        {s: JP.make_ssl_views(k, x, jcfg, shuffle_views=s) for s in (True, False)},
        view_draws(k, B, (64, 64), jcfg),
    ))(jax.random.key(12), jnp.asarray(tiles))
    return tiles, jcfg, to_torch(draws), both


@pytest.mark.parametrize("shuffle_views", [True, False], ids=["shuffled", "spatial"])
def test_make_ssl_views_on_jax_params(jax_views, shuffle_views):
    tiles, jcfg, params, both = jax_views
    want = both[shuffle_views]
    got = P.make_ssl_views(
        t(tiles), port_aug_config(jcfg), shuffle_views=shuffle_views, params=params
    )
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        _close(got[k], want[k])


def test_make_ssl_views_samples_when_given_a_generator():
    cfg = P.AugConfig(img_size=32, grid=2, tile_px=32)
    tiles = torch.from_numpy(np.random.default_rng(8).integers(0, 256, (2, 64, 64, 3), np.uint8))
    a = P.make_ssl_views(tiles, cfg, _gen(5), shuffle_views=False)
    b = P.make_ssl_views(tiles, cfg, _gen(5), shuffle_views=False)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert a["target1_spatial"].shape == (8, 32, 32, 3)
    with pytest.raises(ValueError):
        P.make_ssl_views(tiles, cfg)
