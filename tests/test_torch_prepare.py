"""The port's data preparation against the JAX package: ``bcss_prepare`` on
``tests/test_data.py``'s raw fixture (three PIL-written 8-bit regions,
``tile_size=128, shift=64``) and on 16-bit and palette masks, the label
remap, the manifests on both outputs, the CLI's flags, the decoder's size
limits, and ``make_synthetic_slides`` in both layouts. Everything is exact:
``data.csv`` byte for byte, every tile and mask pixel for pixel (read back
by PIL and by the port's decoder), the synthetic arrays element for
element."""

import argparse
import json
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from msfwsi_tpu.data import prepare as JPR
from msfwsi_tpu.ops import geometry as JG
from msfwsi_tpu_torch import bcss_prepare, make_synthetic_slides, native
from msfwsi_tpu_torch.data import datasets as D
from msfwsi_tpu_torch.data import prepare as PR
from msfwsi_tpu_torch.ops import geometry as G
from torch_parity import jax_tool

NAMES = ["TCGA-OL-1", "TCGA-E2-2", "TCGA-XX-3"]


def _raw(root, masks):
    """A raw BCSS layout under ``root``: ``masks[i]`` is (array, PIL mode)."""
    os.makedirs(root / "images")
    os.makedirs(root / "masks")
    rng = np.random.default_rng(0)
    for name, (mask, mode) in zip(NAMES, masks):
        img = rng.integers(0, 255, size=mask.shape + (3,), dtype=np.uint8)
        Image.fromarray(img).save(root / "images" / f"{name}.png")
        m = Image.fromarray(mask)
        if mode == "P":
            m = m.convert("P")
            m.putpalette([v for c in range(256) for v in (c, 255 - c, (7 * c) % 256)])
        m.save(root / "masks" / f"{name}.png")
    return str(root)


def _fixture_masks():
    """``tests/test_data.py``'s regions: 21-code 8-bit masks."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(3):
        h, w = 300 + 37 * i, 280 + 11 * i
        rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)  # the image's draw
        out.append((rng.integers(0, 22, size=(h, w)).astype(np.uint8), "L"))
    return out


def _prepare_both(raw, tmp_path, **kw):
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    df = JPR.prepare_bcss(raw, jax_out, tile_size=128, shift=64, workers=0, **kw)
    rows = PR.prepare_bcss(raw, port_out, tile_size=128, shift=64, workers=0, **kw)
    return jax_out, port_out, df, rows


def _assert_same_library(jax_out, port_out, df, rows):
    with open(os.path.join(jax_out, "data.csv"), "rb") as f:
        want = f.read()
    with open(os.path.join(port_out, "data.csv"), "rb") as f:
        assert f.read() == want
    assert [list(r) for r in df.itertuples(index=False)] == rows
    for rel in [r[0] for r in rows] + [r[1] for r in rows]:
        a = np.asarray(Image.open(os.path.join(jax_out, rel)))
        b = np.asarray(Image.open(os.path.join(port_out, rel)))
        assert a.dtype == b.dtype and np.array_equal(a, b), rel
        assert np.array_equal(native.load_image(os.path.join(jax_out, rel)), a), rel
        assert np.array_equal(native.load_image(os.path.join(port_out, rel)), a), rel


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("prep")
    raw = _raw(tmp / "raw", _fixture_masks())
    return raw, *_prepare_both(raw, tmp)


def test_prepare_matches_jax_byte_for_byte(prepared):
    raw, jax_out, port_out, df, rows = prepared
    assert len(rows) > 50
    assert {r[2] for r in rows} == {f"{n}{s}" for n in NAMES
                                    for s in ("", "_shiftW_64", "_shiftH_64", "_shiftHW_64")}
    _assert_same_library(jax_out, port_out, df, rows)


def test_manifests_read_both_outputs_alike(prepared):
    _, jax_out, port_out, _, _ = prepared
    for fold in (0, 2):
        assert D.bcss_pretrain_files(port_out, fold=fold, threshold=0.3, frac=0.5) == \
            D.bcss_pretrain_files(jax_out, fold=fold, threshold=0.3, frac=0.5)
        assert D.bcss_seg_samples(port_out, fold=fold) == D.bcss_seg_samples(jax_out, fold=fold)
        assert D.bcss_seg_val_slides(port_out, fold=fold) == \
            D.bcss_seg_val_slides(jax_out, fold=fold)
    assert D.bcss_seg_val_slides(port_out, fold=0)  # OL is in fold 0's validation set


@pytest.mark.parametrize("kind", ["uint16", "palette"])
def test_16_bit_and_palette_masks_match_jax(kind, tmp_path):
    """A 16-bit mask (with codes >= 256, which the remap leaves as they
    are) gives 16-bit mask tiles on both sides; a palette mask gives its
    indices as 8-bit grey tiles."""
    rng = np.random.default_rng(5)
    masks = []
    for i in range(3):
        shape = (200 + 13 * i, 190 + 7 * i)
        if kind == "uint16":
            m = rng.integers(0, 22, size=shape).astype(np.uint16)
            m[rng.random(shape) < 0.05] = 300 + 1000 * i
            masks.append((m, "I;16"))
        else:
            masks.append((rng.integers(0, 22, size=shape).astype(np.uint8), "P"))
    raw = _raw(tmp_path / "raw", masks)
    want_mode = "I;16" if kind == "uint16" else "P"
    assert Image.open(os.path.join(raw, "masks", f"{NAMES[0]}.png")).mode == want_mode
    jax_out, port_out, df, rows = _prepare_both(raw, tmp_path)
    tile = os.path.join(port_out, rows[0][1])
    assert native.load_image(tile).dtype == (np.uint16 if kind == "uint16" else np.uint8)
    _assert_same_library(jax_out, port_out, df, rows)


def test_threads_write_what_one_thread_writes(prepared, tmp_path):
    raw, _, port_out, _, rows = prepared
    out = str(tmp_path / "threads")
    assert PR.prepare_bcss(raw, out, tile_size=128, shift=64, workers=3) == rows
    with open(os.path.join(out, "data.csv"), "rb") as a, \
            open(os.path.join(port_out, "data.csv"), "rb") as b:
        assert a.read() == b.read()
    for r in rows[::7]:
        for rel in r[:2]:
            assert np.array_equal(native.load_image(os.path.join(out, rel)),
                                  native.load_image(os.path.join(port_out, rel)))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_remap_bcss_labels_matches_jax(dtype):
    rng = np.random.default_rng(3)
    top = 22 if dtype == np.uint8 else 4000  # 16-bit codes >= 256 stay as they are
    mask = rng.integers(0, top, size=(64, 48)).astype(dtype)
    mask.flat[:22] = np.arange(22)
    got, want = G.remap_bcss_labels(mask), JG.remap_bcss_labels(mask)
    assert got.dtype == want.dtype == dtype and np.array_equal(got, want)
    assert G.BCSS_CLASS_REMAP == JG.BCSS_CLASS_REMAP
    assert np.array_equal(G.remap_bcss_labels(np.zeros((0, 3), dtype)), np.zeros((0, 3), dtype))


def _jax_parser(monkeypatch, script: str) -> argparse.ArgumentParser:
    """The parser a JAX tool builds under ``__main__``, caught at its
    ``parse_args``."""
    import runpy

    class Caught(Exception):
        pass

    seen = {}

    def catch(self, *a, **kw):
        seen["parser"] = self
        raise Caught

    tools = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
    monkeypatch.syspath_prepend(tools)  # the tools' own `import _common`
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(Caught):
        runpy.run_path(os.path.join(tools, script), run_name="__main__")
    monkeypatch.undo()
    return seen["parser"]


def _flags(parser):
    return [(a.option_strings, a.dest, a.default, a.type, a.choices, a.required)
            for a in parser._actions]


def test_cli_flags_equal_the_jax_tool_and_it_prints_the_shape(prepared, monkeypatch, capsys,
                                                              tmp_path):
    assert _flags(bcss_prepare.build_parser()) == _flags(_jax_parser(monkeypatch,
                                                                     "bcss_prepare.py"))
    raw, jax_out, _, df, _ = prepared
    out = str(tmp_path / "cli")
    shape = bcss_prepare.main(["-p", raw, "-o", out, "-s", "128", "--overlap", "64"])
    assert shape == df.shape and capsys.readouterr().out.strip() == str(df.shape)
    with open(os.path.join(out, "data.csv"), "rb") as a, \
            open(os.path.join(jax_out, "data.csv"), "rb") as b:
        assert a.read() == b.read()


def _crafted_png(path, width, height):
    """A grey 8-bit PNG whose header claims ``width`` x ``height`` (its
    data is one empty row: the decoder must stop at the header)."""
    ihdr = struct.pack(">IIBBBBB", width, height, 8, 0, 0, 0, 0)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(b"\0")) + chunk(b"IEND", b""))
    return str(path)


@pytest.mark.parametrize("width,height,limit", [
    ((1 << 20) + 1, 1, r"side above the decoder's limit of 2\^20 pixels"),
    (1, (1 << 20) + 1, r"side above the decoder's limit of 2\^20 pixels"),
    (70000, 70000, r"limit of 4 GiB of raw image bytes"),
], ids=["wide", "tall", "4GiB"])
def test_decoder_limits_fail_naming_the_limit_and_the_file(tmp_path, width, height, limit):
    path = _crafted_png(tmp_path / "huge.png", width, height)
    for read in (native.load_image, native.probe):
        with pytest.raises(IOError, match=limit) as e:
            read(path)
        assert path in str(e.value)
    # just under both limits the header is accepted
    ok = _crafted_png(tmp_path / "ok.png", 1 << 20, 1)
    assert native.probe(ok) == (1, 1 << 20, 1)


def test_make_slide_matches_the_jax_tool():
    tool = jax_tool("make_synthetic_slides")
    for seed, size in ((0, 64), (7, 333), (11, 1024)):
        want = tool.make_slide(np.random.default_rng(seed), size)
        got = make_synthetic_slides.make_slide(np.random.default_rng(seed), size)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w), (seed, size)


def _same_pixels(root_a, root_b):
    files = sorted(os.path.relpath(os.path.join(d, f), root_a)
                   for d, _, fs in os.walk(root_a) for f in fs if f.endswith(".png"))
    assert files and files == sorted(
        os.path.relpath(os.path.join(d, f), root_b)
        for d, _, fs in os.walk(root_b) for f in fs if f.endswith(".png"))
    for rel in files:
        a = np.asarray(Image.open(os.path.join(root_a, rel)))
        assert np.array_equal(native.load_image(os.path.join(root_b, rel)), a), rel
    return files


def test_synthetic_bcss_layout_matches_the_jax_tool(tmp_path):
    tool = jax_tool("make_synthetic_slides")
    tool.main(argparse.Namespace(out=str(tmp_path / "jax"), slides=2, size=96, seed=4))
    names = make_synthetic_slides.main(["-o", str(tmp_path / "port"), "--slides", "2",
                                        "--size", "96", "--seed", "4"])
    assert names == [f"TCGA-{i}-S{n:02d}-DX1_xmin0_ymin0_MPP-0.2500"
                     for n, i in enumerate(("OL", "A1"))]
    assert len(_same_pixels(str(tmp_path / "jax"), str(tmp_path / "port"))) == 4


def test_synthetic_c16_layout_matches_the_jax_tool(tmp_path):
    tool = jax_tool("make_synthetic_slides")
    tool.main_c16(argparse.Namespace(out=str(tmp_path / "jax"), slides=2, seed=0,
                                     tiles_per_slide=3, tile_size=32))
    meta = make_synthetic_slides.main(["-o", str(tmp_path / "port"), "--layout", "c16",
                                       "--slides", "2", "--tiles-per-slide", "3",
                                       "--tile-size", "32"])
    with open(tmp_path / "jax" / "dataset.json", "rb") as a, \
            open(tmp_path / "port" / "dataset.json", "rb") as b:
        assert a.read() == b.read()
    assert meta == json.loads((tmp_path / "port" / "dataset.json").read_text())
    assert len(_same_pixels(str(tmp_path / "jax"), str(tmp_path / "port"))) == 4 * 3
    m = D.Camelyon16Manifest(str(tmp_path / "port"), n_sample=3, mode="all", seed=0)
    assert len(m.resample(0)) == 3 * 4


def test_synthetic_cli_flags_equal_the_jax_tool(monkeypatch):
    assert _flags(make_synthetic_slides.build_parser()) == _flags(
        _jax_parser(monkeypatch, "make_synthetic_slides.py"))
