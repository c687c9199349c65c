"""The port's tile features and probes against the JAX package: the feature
layout, context and target features on weights carried across from a JAX
MSFWSI, the sub-tile order, the output dtype, the ``random`` control's
encoders, the weighted kNN, the probe's fit and its scores (resnet10,
scale 2, 64 px tiles, 32 px encoder inputs)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msfwsi_tpu.data import pipeline as JP
from msfwsi_tpu.models.backbone import MSFWSI as JMSFWSI
from msfwsi_tpu.ops.geometry import batched_blockshaped as j_blockshaped
from msfwsi_tpu.train import features as JF
from msfwsi_tpu.train import ssl as JS
from msfwsi_tpu_torch import extract_features as XF
from msfwsi_tpu_torch import linear_probe as LP
from msfwsi_tpu_torch.data.pipeline import AugConfig
from msfwsi_tpu_torch.data.slides import iter_synthetic
from msfwsi_tpu_torch.models.backbone import MSFWSI
from msfwsi_tpu_torch.ops import augment as A
from msfwsi_tpu_torch.ops.geometry import batched_blockshaped
from msfwsi_tpu_torch.train import features as F
from msfwsi_tpu_torch.train import ssl as S
from msfwsi_tpu_torch.train.checkpoint import jax_msfwsi_to_torch
from torch_parity import jax_tool, numpy_tree, t

torch.set_num_threads(2)

ARCH, SCALE, IMG, TILE = "resnet10", 2, 32, 64


@pytest.mark.parametrize("arch", ["resnet10", "resnet18"])
def test_feature_spec_matches_jax(arch):
    for branches, scales in ((F.BRANCHES, (1, 2, 3, 4)), (("target",), (2, 4)),
                             (("context",), (3,))):
        with torch.device("meta"):  # the layout needs no weights
            model = MSFWSI(arch=arch, scale=4)
        got = F.feature_spec(model, branches, scales)
        want = JF.feature_spec(JMSFWSI(arch=arch, scale=4), branches, scales)
        assert got == [tuple(x) for x in want]
    with pytest.raises(ValueError, match="branches"):
        F.feature_spec(model, ("fuser",))
    with pytest.raises(ValueError, match="scales"):
        F.feature_spec(model, scales=(0,))


@pytest.fixture(scope="module")
def feat_setup():
    """A JAX MSFWSI's variables (running stats drawn away from 0 and 1),
    the port model holding them through ``jax_msfwsi_to_torch``, and 5
    tiles."""
    jcfg = JS.SSLConfig(arch=ARCH, scale=SCALE, img_size=IMG, batch_size=1, amp=False)
    jmodel = jcfg.build_model()
    x1, x2, revs = JS.batch_views(JS.make_example_batch(jcfg), jmodel.views_shuffled)
    init = jax.jit(lambda k: jmodel.init(k, x1, x2, revs, train=False))(jax.random.key(1))
    rng = np.random.default_rng(4)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(0.5, 2.0, a.shape) if path[-1].key == "var"
                         else rng.normal(0, 0.2, a.shape)).astype(np.float32),
        numpy_tree(init["batch_stats"]))
    variables = {"params": jax.tree.map(np.array, numpy_tree(init["params"])),
                 "batch_stats": stats}
    model = MSFWSI(arch=ARCH, scale=SCALE)
    model.load_state_dict(jax_msfwsi_to_torch(variables), strict=True)
    model.eval()
    tiles = rng.integers(0, 256, (5, TILE, TILE, 3), dtype=np.uint8)
    jvars = jax.tree.map(jnp.asarray, variables)
    return jmodel, jvars, model, tiles


def test_features_match_jax_fp32(feat_setup):
    """Context (B, C_i) and target (B, K, C_i) features of every stage, fp32,
    equal JAX's ``make_chunk_features`` within rtol 1e-4 / atol 1e-5."""
    jmodel, jvars, model, tiles = feat_setup
    fn = F.make_chunk_features(model, AugConfig(img_size=IMG), out_dtype=torch.float32)
    jfn = JF.make_chunk_features(jmodel, JP.AugConfig(img_size=IMG), out_dtype=jnp.float32)
    got = fn(t(tiles))
    want = jfn(jvars, jnp.asarray(tiles))
    spec = F.feature_spec(model)
    assert len(got) == len(want) == len(spec) == 8
    for (b, s, c), g, w in zip(spec, got, want):
        shape = (5, c) if b == "context" else (5, SCALE**2, c)
        assert tuple(g.shape) == shape and g.dtype == torch.float32, (b, s)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5,
                                   err_msg=f"{b}_s{s}")


def test_target_sub_tile_order_is_blockshaped(feat_setup):
    """``batched_blockshaped`` equals JAX's bit for bit, and each target
    entry k is the target encoder's feature of the sub-tile in row k // s,
    column k % s."""
    _, _, model, tiles = feat_setup
    h = TILE // SCALE
    np.testing.assert_array_equal(batched_blockshaped(t(tiles), h, h).numpy(),
                                  np.asarray(j_blockshaped(jnp.asarray(tiles), h, h)))
    cfg = AugConfig(img_size=IMG)
    got = F.make_chunk_features(model, cfg, ("target",), (4,), torch.float32)(t(tiles))[0]
    for k in range(SCALE**2):
        r, c = divmod(k, SCALE)
        sub = t(tiles[:, r * h : (r + 1) * h, c * h : (c + 1) * h]).float() / 255.0
        x = A.normalize(A.resize_bilinear(sub, IMG), cfg.mean, cfg.std)
        with torch.no_grad():
            want = model.encode_target(x)[3]
        np.testing.assert_allclose(got[:, k].numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


def test_float16_output_is_the_fp32_result_cast(feat_setup):
    _, _, model, tiles = feat_setup
    cfg = AugConfig(img_size=IMG)
    half = F.make_chunk_features(model, cfg)(t(tiles))
    full = F.make_chunk_features(model, cfg, out_dtype=torch.float32)(t(tiles))
    for h, f in zip(half, full):
        assert h.dtype == torch.float16
        assert torch.equal(h, f.to(torch.float16))


def test_indivisible_tiles_raise(feat_setup):
    _, _, model, _ = feat_setup
    fn = F.make_chunk_features(model, AugConfig(img_size=IMG))
    with pytest.raises(ValueError, match="not divisible by --scale 2"):
        fn(torch.zeros((1, 63, 64, 3), dtype=torch.uint8))
    # the context branch alone takes any tile
    ctx = F.make_chunk_features(model, AugConfig(img_size=IMG), ("context",))
    assert ctx(torch.zeros((1, 63, 64, 3), dtype=torch.uint8))[0].shape == (1, 64)


def test_weights_random_are_the_epoch0_ssl_encoders(tmp_path):
    """``--weights random`` extracts with the encoders the port's SSL
    training starts from for that ``--seed``: its features equal those of
    ``create_ssl_state``'s model on the same synthetic tiles."""
    out = XF.main(["--weights", "random", "--synthetic", "2", "--tile-px", str(TILE), "-a", ARCH,
                   "--scale", str(SCALE), "--img-sz", str(IMG), "--seed", "7", "--out-dtype",
                   "float32", "--device", "cpu", "--log-dir", str(tmp_path / "run")])
    state = S.create_ssl_state(S.SSLConfig(arch=ARCH, scale=SCALE, seed=7), device="cpu")
    fn = F.make_chunk_features(state.model, AugConfig(img_size=IMG), out_dtype=torch.float32)
    for name, stems, imgs in iter_synthetic(2, TILE, 6):
        z = np.load(Path(out["out_dir"]) / f"{name}.npz")
        assert list(z["stems"]) == stems
        for (b, s, _), want in zip(out["spec"], fn(t(imgs))):
            np.testing.assert_array_equal(z[f"{b}_s{s}"], want.numpy())


# ---- probes --------------------------------------------------------------------

def _clusters(seed, n=60, d=12, classes=4):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(classes, d)) * 2
    y = rng.integers(0, classes, n).astype(np.int32)
    X = (centers[y] + rng.normal(size=(n, d))).astype(np.float32)
    return X, y


@pytest.mark.parametrize("exclude_self", [False, True])
def test_knn_matches_jax(exclude_self):
    """Weighted kNN labels equal the JAX tool's ``_knn_predict`` on data
    with distinct similarities, the train split scored against itself
    (its own vote left out) or a held-out split; chunks smaller than the
    query set."""
    jlp = jax_tool("linear_probe")
    X_tr, y_tr = _clusters(0)
    X_va = X_tr if exclude_self else _clusters(1)[0]
    got = LP.knn_predict(X_tr, y_tr, X_va, 4, 7, 0.07, chunk=16, exclude_self=exclude_self)
    want = jlp._knn_predict(X_tr, y_tr, X_va, 4, 7, 0.07, chunk=16, exclude_self=exclude_self)
    np.testing.assert_array_equal(got, want)


def test_probe_fit_scores_and_ci_match_jax():
    """From the same W (JAX's draw for the seed) and b = 0, 50 epochs of
    full-batch Adam give JAX's ``_fit_probe`` parameters within 1e-5 and
    the same final loss; ``score`` and ``bootstrap_ci`` equal JAX's."""
    jlp = jax_tool("linear_probe")
    X, y = _clusters(2)
    mu, sigma = X.mean(0), X.std(0) + 1e-6
    X = (X - mu) / sigma
    W0 = np.asarray(jax.random.normal(jax.random.key(5), (X.shape[1], 4)) * 0.01)
    (W, b), loss = LP.fit_probe(X, y, 4, 50, 1e-2, 1e-4, 5, init=(W0, np.zeros(4, np.float32)))
    (jW, jb), jloss = jlp._fit_probe(X, y, 4, 50, 1e-2, 1e-4, 5)
    np.testing.assert_allclose(W, np.asarray(jW), atol=1e-5)
    np.testing.assert_allclose(b, np.asarray(jb), atol=1e-5)
    assert loss == pytest.approx(jloss, abs=1e-5)
    pred = np.argmax(X @ W + b, axis=1).astype(np.int32)
    assert LP.score(X, y, (W, b), 4, pred=pred) == jlp._score(X, y, (W, b), 4, pred=pred)
    assert LP.score(X, y, (W, b), 4) == jlp._score(X, y, (W, b), 4)
    assert LP.bootstrap_ci(pred, y, n_boot=500) == jlp._bootstrap_ci(pred, y, n_boot=500)
    # its own init: W ~ N(0, 0.01^2) from the seed's generator
    (W1, _), _ = LP.fit_probe(X, y, 4, 0, 1e-2, 1e-4, 5)
    torch_w = torch.randn((X.shape[1], 4), generator=torch.Generator().manual_seed(5)) * 0.01
    np.testing.assert_array_equal(W1, torch_w.numpy())
