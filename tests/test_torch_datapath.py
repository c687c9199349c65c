"""The port's tile datapath against the JAX package: manifests, the
decoder, the loader, the pack, and the small utilities of the CLI."""

import csv
import json
import struct
import threading
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from msfwsi_tpu.data import datasets as JD
from msfwsi_tpu.data import loader as JL
from msfwsi_tpu.data import packed as JPK
from msfwsi_tpu.utils import misc as JM
from msfwsi_tpu_torch import native
from msfwsi_tpu_torch.data import datasets as D
from msfwsi_tpu_torch.data import loader as L
from msfwsi_tpu_torch.data import packed as PK
from msfwsi_tpu_torch.data.png import write_png
from msfwsi_tpu_torch.diag import datapath as DP
from msfwsi_tpu_torch.utils import misc as M

torch.set_num_threads(2)

FRACS = (1.0, 0.5, 0.1)


def _write_csv(path, rows):
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)


@pytest.fixture(scope="module")
def manifests(tmp_path_factory):
    """A BCSS ``data.csv`` and a PAIP ``train_data.csv`` whose slides fall
    in and out of every fold's validation set, with ratios around the
    threshold, an empty ratio and names without a ``-``."""
    root = tmp_path_factory.mktemp("manifests")
    rng = np.random.default_rng(3)
    codes = sorted({c for fold in JD.BCSS_VAL_SET for c in fold}) + ["ZZ", "QQ", "K9"]
    bcss = []
    for i in range(240):
        name = "nodash" if i % 23 == 0 else f"TCGA-{codes[i % len(codes)]}-{i // 7:03d}"
        ratio = "" if i % 31 == 0 else f"{rng.uniform(0, 0.4):.4f}"
        bcss.append({"filename": name, "filename_img": f"img/{i:04d}.png",
                     "filename_mask": f"mask/{i:04d}.png", "ratio_masked_area": ratio})
    _write_csv(root / "data.csv", bcss)
    slides = sorted({s for fold in JD.PAIP_VAL_SET for s in fold}) + ["01_01_0001", "01_01_0002"]
    paip = [{"filename": slides[i % len(slides)], "filename_img": f"p/{i:04d}.png",
             "filename_mask": f"pm/{i:04d}.png", "ratio_masked_area": f"{rng.uniform(0, 0.3):.4f}"}
            for i in range(200)]
    _write_csv(root / "train_data.csv", paip)
    return str(root)


@pytest.mark.parametrize("frac", FRACS)
@pytest.mark.parametrize("fold", range(5))
def test_bcss_pretrain_files_match_jax(manifests, fold, frac):
    want = JD.bcss_pretrain_files(manifests, fold=fold, frac=frac)
    assert D.bcss_pretrain_files(manifests, fold=fold, frac=frac) == want
    assert len(want) > 5


@pytest.mark.parametrize("frac", FRACS)
@pytest.mark.parametrize("fold", [-1, *range(5)])
def test_paip_pretrain_files_match_jax(manifests, fold, frac):
    want = JD.paip_pretrain_files(manifests, fold=fold, frac=frac)
    assert D.paip_pretrain_files(manifests, fold=fold, frac=frac) == want
    assert len(want) > 2


def test_bcss_keeps_names_without_a_dash(manifests):
    """pandas gives such a name no slide code (NaN), which is in no fold:
    the row stays."""
    files = D.bcss_pretrain_files(manifests, fold=0, threshold=0.0)
    assert "img/0023.png" in files  # "nodash"
    assert files == JD.bcss_pretrain_files(manifests, fold=0, threshold=0.0)


@pytest.mark.parametrize("mode", ["train", "all"])
def test_camelyon16_resample_matches_jax(tmp_path, mode):
    for sub, slides in (("imagesTr", ("s0", "s1", "s2")), ("imagesTs", ("t0",))):
        for s in slides:
            d = tmp_path / sub / s
            d.mkdir(parents=True)
            for j in range(7):
                (d / f"{s}_{j}.png").write_bytes(b"")
    meta = {"train_ids": ["s0", "s2"], "val_ids": ["s1"], "test_ids": ["t0"]}
    (tmp_path / "dataset.json").write_text(json.dumps(meta))
    port = D.Camelyon16Manifest(str(tmp_path), n_sample=4, mode=mode, seed=11)
    jax_side = JD.Camelyon16Manifest(str(tmp_path), n_sample=4, mode=mode, seed=11)
    assert port.all_data == jax_side.all_data and port.file_ending == jax_side.file_ending
    for epoch in range(3):
        assert port.resample(epoch) == jax_side.resample(epoch)


# ---- decoder ------------------------------------------------------------

def _smooth(h, w, c, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([127 + 100 * np.sin((k + 1) * yy / h * 3 + (2 - k % 3) * xx / w * 2)
                    for k in range(c)], -1)
    img = (img + rng.normal(0, 6, img.shape)).clip(0, 255).astype(np.uint8)
    return img[..., 0] if c == 1 else img


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_decoder_equals_pil_on_every_filter_type(tmp_path, channels, filters):
    img = _smooth(37, 61, channels)
    path = str(tmp_path / "x.png")
    write_png(path, img, filters)
    want = JL.load_image(path)
    assert want.shape == img.shape and np.array_equal(want, img)
    got = native.load_image(path)
    assert got.dtype == np.uint8 and np.array_equal(got, want)


@pytest.mark.parametrize("mode", ["RGB", "L", "P"])
def test_decoder_equals_pil_on_pil_written_pngs(tmp_path, mode):
    """RGB tiles, 1-channel masks and a palette image (its indices), as
    PIL writes them."""
    rgb = _smooth(64, 48, 3, seed=1)
    im = Image.fromarray(rgb)
    if mode == "L":
        im = Image.fromarray((rgb[..., 0] // 40).astype(np.uint8))  # a label mask
    elif mode == "P":
        im = im.convert("P")
    path = str(tmp_path / f"{mode}.png")
    im.save(path)
    want = JL.load_image(path)
    assert np.array_equal(native.load_image(path), want)
    h, w, c = native.probe(path)
    assert (h, w) == want.shape[:2] and c == (1 if want.ndim == 2 else want.shape[2])


def _chunks(data: bytes) -> list[tuple[bytes, bytes]]:
    """(type, body) of each chunk of the PNG ``data``."""
    out, pos = [], 8
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        out.append((data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]))
        pos += 12 + n
    return out


def _rechunk_idat(data: bytes, tail: int) -> bytes:
    """The PNG ``data`` with its zlib stream in two IDATs, the second
    holding the stream's last ``tail`` bytes."""
    chunks = _chunks(data)
    stream = b"".join(body for kind, body in chunks if kind == b"IDAT")
    out = [data[:8]]
    for kind, body in [c for c in chunks if c[0] != b"IDAT"][:-1] + [
            (b"IDAT", stream[:-tail]), (b"IDAT", stream[-tail:]), (b"IEND", b"")]:
        out.append(struct.pack(">I", len(body)) + kind + body
                   + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    return b"".join(out)


def test_decoder_reads_a_stream_whose_end_lies_in_a_later_idat(tmp_path):
    """The last 1-6 bytes of the zlib stream (the adler32, the last block's
    end) in an IDAT of their own, after the one that completes the pixels:
    equal to PIL through ``load_image`` and through the loader."""
    img = _smooth(40, 52, 3, seed=4)
    good = tmp_path / "one.png"
    write_png(str(good), img)
    files = []
    for tail in range(1, 7):
        name = f"tail{tail}.png"
        (tmp_path / name).write_bytes(_rechunk_idat(good.read_bytes(), tail))
        assert [k for k, _ in _chunks((tmp_path / name).read_bytes())].count(b"IDAT") == 2
        want = JL.load_image(str(tmp_path / name))
        assert np.array_equal(want, img)
        assert np.array_equal(native.load_image(str(tmp_path / name)), want)
        files.append(name)
    loader = L.TileBatchLoader(str(tmp_path), files, 3, shuffle=False, device="cpu")
    for batch in loader.epoch(0):
        assert all(np.array_equal(b, img) for b in batch.numpy())


def test_decoder_reads_a_pil_written_tile_of_many_idats(tmp_path):
    """A 1024 px RGB tile as PIL writes it, its stream cut into many IDATs:
    equal to PIL through ``load_image`` and through the loader."""
    path = tmp_path / "tile.png"
    Image.fromarray(_smooth(1024, 1024, 3, seed=5)).save(path)
    assert [k for k, _ in _chunks(path.read_bytes())].count(b"IDAT") > 4
    want = JL.load_image(str(path))
    assert np.array_equal(native.load_image(str(path)), want)
    (batch,) = L.TileBatchLoader(str(tmp_path), ["tile.png"], 1, device="cpu").epoch(0)
    assert np.array_equal(batch[0].numpy(), want)


def test_decoder_on_jpeg(tmp_path):
    """Equal to PIL bit for bit where the build found libjpeg; a clear
    error where it did not."""
    path = str(tmp_path / "a.jpg")
    Image.fromarray(_smooth(40, 56, 3, seed=2)).save(path, quality=90)
    if native.has_jpeg():
        assert np.array_equal(native.load_image(path), JL.load_image(path))
    else:
        with pytest.raises(IOError, match="libjpeg"):
            native.load_image(path)


def test_decoder_raises_on_a_bad_file_naming_it(tmp_path):
    img = _smooth(32, 32, 3)
    good = str(tmp_path / "good.png")
    write_png(good, img)
    data = open(good, "rb").read()
    truncated, flipped, other = (str(tmp_path / n) for n in ("trunc.png", "flip.png", "big.png"))
    open(truncated, "wb").write(data[: len(data) // 2])
    corrupt = bytearray(data)
    corrupt[60] ^= 0xFF  # inside IDAT: the chunk's CRC no longer matches
    open(flipped, "wb").write(bytes(corrupt))
    write_png(other, _smooth(32, 40, 3))
    for bad, why in ((truncated, "corrupt or truncated"), (flipped, "corrupt or truncated"),
                     (other, "another shape"), (str(tmp_path / "missing.png"), "cannot be opened")):
        with pytest.raises(IOError, match=why) as err:
            native.decode_batch([good, bad, good], 32, 32, 3)
        assert bad in str(err.value)
    with pytest.raises(IOError, match="trunc.png"):
        native.load_image(truncated)


# ---- loader and pack ----------------------------------------------------

@pytest.fixture(scope="module")
def tiles(tmp_path_factory):
    """11 PIL-written 48 px RGB tiles."""
    root = tmp_path_factory.mktemp("tiles")
    files = []
    for i in range(11):
        name = f"t/{i:02d}.png"
        (root / "t").mkdir(exist_ok=True)
        Image.fromarray(_smooth(48, 48, 3, seed=10 + i)).save(root / name)
        files.append(name)
    return str(root), files


MODES = {
    "drop_last": dict(drop_last=True),
    "short_last": dict(drop_last=False),
    "pad_last": dict(drop_last=False, pad_last=True),
}


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("mode", [*MODES, "pack"])
def test_loader_batches_match_jax(tiles, tmp_path, mode, seed):
    """Order and content of two epochs, valid masks under pad_last; with a
    pack, each package reading its own pack."""
    root, files = tiles
    kw = MODES.get(mode, {})
    port_fn = jax_fn = None
    if mode == "pack":
        port_fn = PK.get_or_build_pack(root, files, str(tmp_path / "port")).load
        jax_fn = JPK.get_or_build_pack(root, files, str(tmp_path / "jax")).load
    port = L.TileBatchLoader(root, files, 3, seed=seed, load_fn=port_fn, device="cpu", **kw)
    ref = JL.TileBatchLoader(root, files, 3, seed=seed, load_fn=jax_fn, **kw)
    assert len(port) == len(ref) and port.last_batch_valid() == ref.last_batch_valid()
    for epoch in range(2):
        got, want = list(port.epoch(epoch)), list(ref.epoch(epoch))
        assert len(got) == len(want) == len(port)
        for g, w in zip(got, want):
            assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
            assert np.array_equal(g.numpy(), np.asarray(w))
    if mode == "pad_last":
        for i in range(len(port)):
            assert np.array_equal(port.valid_mask(i).numpy(), np.asarray(ref.valid_mask(i)))


@pytest.mark.parametrize("rank", [0, 1, 2])
def test_shard_files_match_jax(rank):
    files = [f"f{i}" for i in range(10)]
    seed = np.random.SeedSequence([7, 1])
    assert L._shard_files(files, seed, rank, 3, True) == JL._shard_files(files, seed, rank, 3, True)
    loader = L.TileBatchLoader("", files, 2, rank=rank, world_size=3, drop_last=False,
                               device="cpu")
    assert len(loader) == 2 and loader.last_batch_valid() == 2


def test_loader_tuple_records_and_errors(tiles):
    root, files = tiles
    pairs = [(f, f) for f in files[:4]]
    loader = L.TileBatchLoader(root, pairs, 2, shuffle=False, device="cpu")
    a, b = next(iter(loader.epoch(0)))
    assert torch.equal(a, b) and a.shape == (2, 48, 48, 3)
    bad = L.TileBatchLoader(root, files[:3] + ["t/none.png"], 2, shuffle=False, device="cpu")
    with pytest.raises(IOError, match="t/none.png"):
        list(bad.epoch(0))
    with pytest.raises(ValueError):
        L.TileBatchLoader(root, files, 2, pad_last=True, device="cpu")


def test_abandoned_epoch_joins_its_thread(tiles):
    root, files = tiles
    loader = L.TileBatchLoader(root, files, 2, prefetch=1, device="cpu")
    batches = loader.epoch(0)
    next(batches)
    assert any(t.name == "TileBatchLoader" for t in threading.enumerate())
    batches.close()
    assert not any(t.name == "TileBatchLoader" for t in threading.enumerate())


def test_pack_files_and_key_match_jax(tiles, tmp_path):
    root, files = tiles
    for fs, r in ((files, root), (files[::-1], root), (files, ""), (files[:3], "/x/y")):
        assert PK.pack_key(fs, r) == JPK.pack_key(fs, r)
    port = PK.build_pack(root, files, str(tmp_path / "port"))
    ref = JPK.build_pack(root, files, str(tmp_path / "jax"))
    for ext in (".npy", ".json"):
        assert open(port + ext, "rb").read() == open(ref + ext, "rb").read()
    pack = PK.PackedTiles(port)
    assert len(pack) == len(files) and np.array_equal(pack.load(files[4]), pack.load(4))


def test_synthetic_tile_library_matches_jax():
    got = L.synthetic_tile_library(n_slides=2, tiles_per_slide=2, tile_size=32, seed=4)
    want = JL.synthetic_tile_library(n_slides=2, tiles_per_slide=2, tile_size=32, seed=4)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


# ---- utilities ----------------------------------------------------------

def test_meters_and_paths_match_jax(tmp_path):
    port, ref = M.AverageMeter("Time", ":6.3f"), JM.AverageMeter("Time", ":6.3f")
    for v, n in ((0.5, 1), (1.25, 3)):
        port.update(v, n)
        ref.update(v, n)
    assert str(port) == str(ref)
    assert (M.ProgressMeter(120, [port], "Epoch: [3]").display(7)
            == JM.ProgressMeter(120, [ref], "Epoch: [3]").display(7))
    base = tmp_path / "run"
    got = [str(M.increment_path(base, sep="_", mkdir=True)) for _ in range(3)]
    assert got == [str(base), f"{base}_2", f"{base}_3"]
    assert str(JM.increment_path(base, sep="_")) == str(M.increment_path(base, sep="_"))


def test_prefetch_iter_order_errors_and_abandon():
    assert list(M.prefetch_iter(iter(range(20)), depth=3)) == list(range(20))

    def bad():
        yield 1
        raise KeyError("boom")

    it = M.prefetch_iter(bad())
    assert next(it) == 1
    with pytest.raises(KeyError, match="boom"):
        next(it)
    endless = M.prefetch_iter(iter(range(10**9)))
    assert next(endless) == 0
    endless.close()  # the producer stops instead of running on


def test_cli_rate_times_epochs_from_their_first_batch():
    """The datapath script's CLI rate skips the first epoch and each timed
    epoch's first-batch fill, which it reports apart."""
    result = {"epochs": [{"steps": 4, "seconds": 9.0, "fill_seconds": 3.0},
                         {"steps": 4, "seconds": 2.5, "fill_seconds": 0.5},
                         {"steps": 2, "seconds": 1.5, "fill_seconds": 0.5}]}
    assert DP.cli_rate(result, 8, scale=2) == 8 * 6 * 10 / 3.0
    assert DP.cli_fill_s(result) == 0.5
    first = {"epochs": result["epochs"][:1]}
    assert DP.cli_rate(first, 8, scale=2) == 8 * 4 * 10 / 6.0 and DP.cli_fill_s(first) == 3.0
