"""The port's prediction path against the JAX package: the prep grid's
geometry, chunked predictions of both heads from both kinds of views, the
stitching, the one-call ``validate``, and the palette PNG writer (resnet10
HookNet, 128 px tiles, 64 px views, 3 classes plus background)."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from msfwsi_tpu.data import pipeline as JP
from msfwsi_tpu.models.hooknet import HookNet as JHookNet
from msfwsi_tpu.ops import augment as JA
from msfwsi_tpu.ops.geometry import TileGrid as JTileGrid
from msfwsi_tpu.train import evaluate as JEV
from msfwsi_tpu.train import predict as JPR
from msfwsi_tpu.train.checkpoint import torch_hooknet_to_flax
from msfwsi_tpu_torch import native
from msfwsi_tpu_torch.data import pipeline as P
from msfwsi_tpu_torch.data.png import png_size, write_png
from msfwsi_tpu_torch.models.hooknet import build_hooknet
from msfwsi_tpu_torch.ops.geometry import TileGrid
from msfwsi_tpu_torch.predict import PALETTE, save_pred_png
from msfwsi_tpu_torch.train import evaluate as EV
from msfwsi_tpu_torch.train import predict as PR
from torch_parity import state_numpy, t

torch.set_num_threads(2)

SEG, NUM_FG, ARCH = 64, 3, "resnet10"
CLASS_NAMES = ("a", "b", "c")


# ---- TileGrid ----------------------------------------------------------------

@pytest.mark.parametrize("h,w,size,sh,sw", [
    (1000, 900, 256, 0, 0), (1024, 1024, 256, 0, 0), (1000, 900, 256, 128, 0),
    (1000, 900, 256, 0, 200), (1023, 1025, 512, 256, 256), (300, 700, 128, 100, 27),
    (64, 64, 64, 0, 0), (65, 63, 64, 1, 63),
])
def test_tile_grid_matches_jax(h, w, size, sh, sw):
    """``num_h/num_w/pad/origin`` equal and every tile extracted bit for bit."""
    ours, theirs = TileGrid(h, w, size, sh, sw), JTileGrid(h, w, size, sh, sw)
    for attr in ("num_h", "num_w", "pad_h", "pad_w"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr
    assert len(ours) == len(theirs)
    rng = np.random.default_rng(h + w)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    mask = rng.integers(0, 6, (h, w), dtype=np.uint8)
    for idx in range(len(ours)):
        assert ours.origin(idx) == theirs.origin(idx)
        np.testing.assert_array_equal(ours.extract(img, idx), theirs.extract(img, idx))
        np.testing.assert_array_equal(ours.extract(mask, idx), theirs.extract(mask, idx))


# ---- chunked predictions -------------------------------------------------------

@pytest.fixture(scope="module")
def pred_setup():
    model = build_hooknet(torch.Generator().manual_seed(0), arch=ARCH, classes=NUM_FG + 1)
    model.eval()
    variables = jax.tree.map(jnp.asarray, torch_hooknet_to_flax(state_numpy(model)))
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (7, 2 * SEG, 2 * SEG, 3), dtype=np.uint8)
    return model, variables, imgs


def _jax_logits(variables, val_views, imgs, jcfg, host_views):
    """The JAX HookNet's (context, target) logits on the same views."""
    if val_views == "host":
        ctx_u8, tgt_u8 = host_views
        ctx = JA.normalize(JP._to_float(jnp.asarray(ctx_u8), jnp.float32), jcfg.mean, jcfg.std)
        tgt = JA.normalize(JP._to_float(jnp.asarray(tgt_u8), jnp.float32), jcfg.mean, jcfg.std)
    else:
        zeros = jnp.zeros(imgs.shape[:3], jnp.int32)
        (ctx, tgt), _ = JP.make_seg_val_views(jnp.asarray(imgs), zeros, jcfg)
    out = JHookNet(arch=ARCH, classes=NUM_FG + 1).apply(variables, ctx, tgt, train=False)
    return [np.asarray(o, np.float32) for o in out]


@pytest.mark.parametrize("val_views", ["host", "device"])
def test_chunked_predictions_match_jax(pred_setup, val_views, monkeypatch):
    """Both heads, fp32, a slide of 7 tiles in chunks of 4: the port's uint8
    predictions equal JAX's ``predict_slide`` on every pixel where JAX's
    top-two logits differ by more than 1e-4, and those pixels are at least
    99.9% of all (host views from both packages' numpy paths)."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    model, variables, imgs = pred_setup
    cfg, jcfg = P.AugConfig(seg_size=SEG), JP.AugConfig(seg_size=SEG)
    zeros = np.zeros(imgs.shape[:3], np.uint8)
    if val_views == "host":
        ours_in = P.make_seg_val_views_host(imgs, zeros, cfg, num_threads=2)[:2]
        theirs_in = JP.make_seg_val_views_host(imgs, zeros, jcfg)[:2]
        for a, b in zip(ours_in, theirs_in):
            np.testing.assert_array_equal(a, b)
    else:
        ours_in = theirs_in = (imgs,)
    fn = PR.make_chunk_preds_for_views(model, val_views, cfg, heads=PR.HEADS)
    got = PR.predict_slide(fn, ours_in, chunk=4, device="cpu")
    jfn = JPR.make_chunk_preds_for_views(JHookNet(arch=ARCH, classes=NUM_FG + 1), val_views,
                                         cfg=jcfg, heads=JPR.HEADS)
    want = JPR.predict_slide(jfn, variables, theirs_in, chunk=4)
    logits = _jax_logits(variables, val_views, imgs, jcfg, theirs_in)
    for head, g, w, z in zip(PR.HEADS, got, want, logits):
        assert g.dtype == np.uint8 and g.shape == w.shape == z.shape[:3], head
        top2 = np.sort(z, axis=-1)[..., -2:]
        clear = (top2[..., 1] - top2[..., 0]) > 1e-4
        assert clear.mean() >= 0.999, (head, clear.mean())
        np.testing.assert_array_equal(g[clear], w[clear], err_msg=head)


def test_chunking_and_padding_equal_one_forward(pred_setup):
    """A slide of 2 * chunk + 3 tiles (two full chunks and a padded one)
    gives the predictions of one direct forward of all its tiles."""
    model, _, _ = pred_setup
    chunk = 4
    rng = np.random.default_rng(9)
    imgs = rng.integers(0, 256, (2 * chunk + 3, 2 * SEG, 2 * SEG, 3), dtype=np.uint8)
    cfg = P.AugConfig(seg_size=SEG)
    fn = PR.make_chunk_preds_u8(model, cfg, heads=("context", "target"))
    got = PR.predict_slide(fn, (imgs,), chunk=chunk, device="cpu")
    (ctx, tgt), _ = P.make_seg_val_views(t(imgs), torch.zeros(imgs.shape[:3], dtype=torch.int32),
                                         cfg)
    with torch.no_grad():
        logits = model(ctx, tgt)
    for g, z in zip(got, logits):
        assert g.shape[0] == len(imgs)
        np.testing.assert_array_equal(g, z.argmax(dim=-1).to(torch.uint8).numpy())


def test_bad_heads_raise(pred_setup):
    model = pred_setup[0]
    for heads in ((), ("target", "both"), ("logits",)):
        with pytest.raises(ValueError, match="heads must be"):
            PR.make_chunk_preds_hostviews(model, heads=heads)
    with pytest.raises(ValueError, match="val_views"):
        PR.make_chunk_preds_for_views(model, "disk")


# ---- stitching -----------------------------------------------------------------

@pytest.mark.parametrize("h,w,tile,seg", [(1000, 900, 256, 64), (512, 512, 128, 32),
                                          (300, 470, 128, 64)])
def test_stitching_matches_jax_bit_for_bit(h, w, tile, seg):
    """Both stitch functions on a grid with a ragged last row and column,
    some tiles dropped, equal JAX's exactly."""
    rng = np.random.default_rng(h)
    grid, jgrid = TileGrid(h, w, tile), JTileGrid(h, w, tile)
    indices = sorted(rng.choice(len(grid), size=max(1, len(grid) - 2), replace=False).tolist())
    preds = rng.integers(0, 6, (len(indices), seg, seg), dtype=np.uint8)
    for ours, theirs in ((PR.stitch_context_preds, JPR.stitch_context_preds),
                         (PR.stitch_target_preds, JPR.stitch_target_preds)):
        got = ours(preds, indices, grid, seg_size=seg)
        want = theirs(preds, indices, jgrid, seg_size=seg)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


# ---- validate ------------------------------------------------------------------

def test_validate_matches_jax(pred_setup):
    """``validate`` over two slides of normalized views (5 and 3 tiles,
    chunk 4) is within 1e-6 of JAX's ``validate`` on the same weights."""
    model, variables, _ = pred_setup
    rng = np.random.default_rng(12)
    slides = []
    for n in (5, 3):
        ctx, tgt = (rng.normal(size=(n, SEG, SEG, 3)).astype(np.float32) for _ in range(2))
        masks = rng.integers(0, NUM_FG + 1, (n, SEG, SEG)).astype(np.int32)
        slides.append((ctx, tgt, masks))
    got = EV.validate(model, iter(slides), CLASS_NAMES, chunk=4, device="cpu")
    want = JEV.validate(JHookNet(arch=ARCH, classes=NUM_FG + 1), variables,
                        [tuple(a.copy() for a in s) for s in slides], CLASS_NAMES, chunk=4)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k


# ---- the PNG writer ------------------------------------------------------------

@pytest.mark.parametrize("filters", [(0,), (0, 1, 2, 3, 4)])
def test_palette_png_reads_back_as_the_indices(tmp_path, filters):
    """A palette PNG reads back through PIL (mode "P", the writer's
    palette) and through the port's decoder as the same indices, bit for
    bit; the IHDR size reader agrees with PIL's ``Image.size``."""
    rng = np.random.default_rng(3)
    pred = rng.integers(0, len(PALETTE), (37, 53), dtype=np.uint8)
    path = str(tmp_path / "pred.png")
    write_png(path, pred, filters=filters, palette=PALETTE)
    with Image.open(path) as im:
        assert im.mode == "P" and im.size == png_size(path) == (53, 37)
        back = np.asarray(im)
        pal = im.getpalette()
    np.testing.assert_array_equal(back, pred)
    assert pal[: 3 * len(PALETTE)] == [v for rgb in PALETTE for v in rgb]
    np.testing.assert_array_equal(native.load_image(path), back)
    save_pred_png(str(tmp_path / "saved.png"), pred)
    np.testing.assert_array_equal(native.load_image(str(tmp_path / "saved.png")), pred)
    rgb = rng.integers(0, 256, (9, 11, 3), dtype=np.uint8)
    write_png(str(tmp_path / "rgb.png"), rgb)
    with Image.open(tmp_path / "rgb.png") as im:
        assert im.size == png_size(str(tmp_path / "rgb.png")) == (11, 9)
    with pytest.raises(ValueError, match="palette"):
        write_png(path, rgb, palette=PALETTE)
    (tmp_path / "x.png").write_bytes(b"not a png at all, 24+ bytes")
    with pytest.raises(ValueError, match="not a PNG"):
        png_size(str(tmp_path / "x.png"))
