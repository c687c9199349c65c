"""The port's inference CLIs on the CPU: their flag surfaces against the JAX
tools', the PAIP recipe's evaluate command, ``evaluate`` against
``tools/evaluate.py`` on a BCSS-style directory, ``predict`` with
stitching scored against ``evaluate``'s counts, ``extract_features`` into
``linear_probe`` from a port SSL checkpoint, ``dataset_stats``,
``parity_check``, an Orbax directory as ``--weights``, the bench's
``eval_e2e`` mode and the device rule (resnet10 HookNet, 128 px tiles,
64 px views)."""

import json
import logging
import re
import shlex
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from msfwsi_tpu.data import datasets as JD
from msfwsi_tpu.train import evaluate as JEV
from msfwsi_tpu.utils.logger import setup_logger as jax_setup_logger
from msfwsi_tpu_torch import (bench, dataset_stats, evaluate, extract_features, linear_probe,
                              native, parity_check, predict, ssl_train)
from msfwsi_tpu_torch.data import datasets as D
from msfwsi_tpu_torch.data.loader import load_slide_arrays
from msfwsi_tpu_torch.data.pipeline import AugConfig, make_seg_val_views_host
from msfwsi_tpu_torch.data.png import write_png
from msfwsi_tpu_torch.diag.datapath import smooth_tiles, write_bcss_dataset, write_bcss_masks
from msfwsi_tpu_torch.models.hooknet import build_hooknet
from msfwsi_tpu_torch.ops.geometry import TileGrid
from msfwsi_tpu_torch.ops.metrics import get_stats
from msfwsi_tpu_torch.train import checkpoint as C
from msfwsi_tpu_torch.train import evaluate as EV
from msfwsi_tpu_torch.train import predict as PR
from msfwsi_tpu_torch.utils import close_logger
from torch_parity import jax_tool

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
ARCH, SEG = "resnet10", 64
CLIS = {"evaluate": evaluate, "predict": predict, "extract_features": extract_features,
        "linear_probe": linear_probe, "dataset_stats": dataset_stats,
        "parity_check": parity_check}


def _surface(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.nargs, type(a).__name__,
                     tuple(a.choices) if a.choices is not None else None,
                     getattr(a.type, "__name__", None))
            for a in parser._actions if a.option_strings and a.dest != "help"}


@pytest.mark.parametrize("name", sorted(CLIS))
def test_flag_surface_covers_the_jax_cli(name):
    """Every option of the JAX tool's parser, with its default, type, nargs,
    action and choices; the port adds ``--device`` only."""
    want = _surface(jax_tool(name).build_parser())
    got = _surface(CLIS[name].build_parser())
    assert {d: got.get(d) for d in want} == want
    assert set(got) - set(want) == {"device"}
    assert got["device"][1] == "cuda"


def test_paip_recipe_evaluate_command_parses():
    """``scripts/paip.sh``'s evaluation command, shell variables filled in."""
    text = (REPO / "scripts" / "paip.sh").read_text()
    cmds = re.findall(r"python tools/evaluate\.py((?:[^\n]*\\\n)*[^\n]*)", text)
    assert len(cmds) == 1
    cmd = cmds[0].replace("\\\n", " ").replace("${log_path_eval}", "logs/eval")
    cmd = cmd.replace("${frac}", "0.5").replace("${fold}", "2")
    args = evaluate.build_parser().parse_args(shlex.split(cmd))
    assert args.data_name == "paip" and args.fold == 2 and args.amp and args.frac == 0.5
    assert args.weights.endswith("best_ft_model.pth.tar") and args.device == "cuda"
    assert args.multiprocessing_distributed and args.world_size == 1


@pytest.fixture(scope="module")
def fold_csvs(tmp_path_factory):
    """A BCSS ``data.csv`` and a PAIP ``train_data.csv`` with slides in and
    out of every fold's validation set, ``shift`` variants, ratios around
    both thresholds, an empty ratio and names without a ``-``."""
    root = tmp_path_factory.mktemp("folds")
    rng = np.random.default_rng(8)
    codes = sorted({c for fold in JD.BCSS_VAL_SET for c in fold}) + ["ZZ", "K9"]
    rows = []
    for i in range(300):
        name = "nodash" if i % 29 == 0 else f"TCGA-{codes[i % len(codes)]}-{i // 9:03d}"
        name += "_shift" if i % 5 == 0 else ""
        ratio = "" if i % 37 == 0 else f"{rng.uniform(0, 1):.4f}"
        rows.append([name, f"img/{i:04d}.png", f"mask/{i:04d}.png", ratio])
    slides = sorted({x for fold in JD.PAIP_VAL_SET for x in fold}) + ["01_01_0001"]
    paip = [[slides[i % len(slides)] + ("_shift" if i % 7 == 0 else ""), f"p/{i:04d}.png",
             f"pm/{i:04d}.png", f"{rng.uniform(0, 1):.4f}"] for i in range(200)]
    for name, table in (("data.csv", rows), ("train_data.csv", paip)):
        with open(root / name, "w") as f:
            f.write("filename,filename_img,filename_mask,ratio_masked_area\n")
            f.writelines(",".join(r) + "\n" for r in table)
    return str(root)


@pytest.mark.parametrize("data_name", ["bcss", "paip"])
@pytest.mark.parametrize("split", ["val", "train"])
@pytest.mark.parametrize("fold", range(5))
def test_seg_slide_groups_match_jax(fold_csvs, data_name, split, fold):
    """Both sides of every fold, grouped by slide, equal the JAX package's;
    ``val`` equals the validation slides the fine-tuning reads."""
    got = D.seg_slide_groups(fold_csvs, data_name, fold=fold, split=split)
    want = JD.seg_slide_groups(fold_csvs, data_name, fold=fold, split=split)
    assert [(g.filename, [(x.img, x.mask) for x in g.samples]) for g in got] == [
        (g.filename, [(x.img, x.mask) for x in g.samples]) for g in want]
    assert len(got) > 0
    if split == "val":
        val = (D.bcss_seg_val_slides if data_name == "bcss" else D.paip_seg_val_slides)
        jval = (JD.bcss_seg_val_slides if data_name == "bcss" else JD.paip_seg_val_slides)
        assert val(fold_csvs, fold=fold) == got
        assert [g.filename for g in jval(fold_csvs, fold=fold)] == [g.filename for g in got]


@pytest.fixture(scope="module")
def bcss(tmp_path_factory):
    """A BCSS-style directory (14 tiles of 128 px, grey masks in 6 classes,
    the last 4 tiles one validation slide of fold 0) and a port
    ``best_ft_model.pth.tar`` of a seeded resnet10 HookNet."""
    base = tmp_path_factory.mktemp("eval_cli")
    root = str(base / "data")
    tiles = smooth_tiles(14, 2 * SEG, seed=3)
    files = write_bcss_dataset(root, tiles)
    write_bcss_masks(root, files, (tiles[..., 0] // 43).astype(np.uint8), n_val=4)
    model = build_hooknet(torch.Generator().manual_seed(1), arch=ARCH, classes=6)
    (base / "ft").mkdir()
    weights = C.save_best_ft_model(str(base / "ft"), model, epoch=0, arch=ARCH)
    return root, weights, tiles


def _eval_argv(root, weights, views, log_dir):
    return ["-a", ARCH, "--seg-size", str(SEG), "--data-name", "bcss", "--train-data", root,
            "--weights", weights, "--val-views", views, "--val-chunk", "4",
            "--log-dir", str(log_dir)]


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp"])
@pytest.mark.parametrize("views", ["host", "device"])
def test_evaluate_matches_the_jax_cli(bcss, views, amp, tmp_path, monkeypatch):
    """``python -m msfwsi_tpu_torch.evaluate --device cpu`` on the port's
    ``best_ft_model.pth.tar`` against ``tools/evaluate.py`` on the same
    file (read through ``torch_hooknet_to_flax``); host views from both
    packages' numpy paths. Both build the same view config (fp32, JAX's
    default ``AugConfig``) and fp32 views reach the port's model, with and
    without ``--amp``. Every summary score within 1e-6 in fp32; under
    ``--amp`` within 5e-3, where the model runs in bf16 and the two
    frameworks' bf16 convolutions round apart and flip near-tied pixels
    (1.4e-3 at most measured on these tiles)."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    root, weights, _ = bcss
    amp_flag = ["--amp"] if amp else []
    seen = {"cfg": [], "inputs": set()}

    def spy(make):
        def wrapped(model, num_classes, val_views, cfg=None, **kw):
            seen["cfg"].append(cfg)
            if isinstance(model, torch.nn.Module):
                model.register_forward_pre_hook(
                    lambda m, args: seen["inputs"].update(a.dtype for a in args))
            return make(model, num_classes, val_views, cfg=cfg, **kw)
        return wrapped

    monkeypatch.setattr(EV, "make_chunk_stats_for_views", spy(EV.make_chunk_stats_for_views))
    monkeypatch.setattr(JEV, "make_chunk_stats_for_views", spy(JEV.make_chunk_stats_for_views))
    got = evaluate.main(_eval_argv(root, weights, views, tmp_path / "port") + amp_flag
                        + ["--device", "cpu"])
    jev = jax_tool("evaluate")
    args = jev.PARSER.parse_args(_eval_argv(root, weights, views, tmp_path / "jax") + amp_flag)
    Path(args.log_dir).mkdir(parents=True)
    try:
        want = jev.main_worker(args)
    finally:  # the JAX CLI leaves its logger set up; later tests read the records
        close_logger(logging.getLogger("MSF-WSI"))
        jax_setup_logger.cache_clear()
    port_cfg, jax_cfg = seen["cfg"]
    assert port_cfg.compute_dtype == jax_cfg.compute_dtype == "float32"
    assert seen["inputs"] == {torch.float32}
    assert sorted(got["summary"]) == sorted(want)
    for k in want:
        assert got["summary"][k] == pytest.approx(want[k], abs=5e-3 if amp else 1e-6), k
    assert len(got["slides"]) == 1 and got["slides"][0]["counts"].shape == (4, 5)
    assert "MICRO F1" in (Path(got["log_dir"]) / "log.txt").read_text()


def test_predict_stitches_and_scores_as_evaluate(bcss, tmp_path):
    """``predict --head both --stitch`` on the validation slide's tiles and
    the raw slide they tile (a 2x2 mosaic; the prep grid pads it to 3x3,
    so the tiles are ids 0, 1, 3 and 4): per-tile and stitched palette
    PNGs; the target masks, scored on the host, give exactly the evaluate
    CLI's counts; the stitched maps are the per-tile masks placed on the
    grid."""
    root, weights, _ = bcss
    group = D.bcss_seg_val_slides(root)[0]
    slide_dir = tmp_path / "tiles" / group.filename / "images"
    slide_dir.mkdir(parents=True)
    ids = [0, 1, 3, 4]
    for i, s in zip(ids, group.samples):
        shutil.copy(Path(root) / s.img, slide_dir / f"{i}.png")
    imgs, masks = load_slide_arrays(root, group)
    T = 2 * SEG
    grid = TileGrid(2 * T, 2 * T, T)
    assert (grid.num_h, grid.num_w) == (3, 3)
    mosaic = imgs.reshape(2, 2, T, T, 3).transpose(0, 2, 1, 3, 4).reshape(2 * T, 2 * T, 3)
    (tmp_path / "raw" / "images").mkdir(parents=True)
    write_png(str(tmp_path / "raw" / "images" / f"{group.filename}.png"), mosaic)
    out = predict.main(["-a", ARCH, "--seg-size", str(SEG), "--weights", weights, "--tiles-dir",
                        str(tmp_path / "tiles"), "--head", "both", "--stitch", "--raw-data",
                        str(tmp_path / "raw"), "--device", "cpu", "--log-dir",
                        str(tmp_path / "pred")])
    assert out["tiles"] == 4
    pdir = Path(out["out_dir"])
    preds = {h: np.stack([native.load_image(str(pdir / group.filename / h / f"{i}.png"))
                          for i in ids]) for h in PR.HEADS}
    assert preds["target"].shape == (4, SEG, SEG) and preds["context"].shape == (4, SEG, SEG)
    tmask = make_seg_val_views_host(imgs, masks, AugConfig(seg_size=SEG))[2]
    counts = np.stack([c.sum(0).numpy() for c in get_stats(
        torch.from_numpy(preds["target"]).long() - 1, torch.from_numpy(tmask).long() - 1, 5,
        ignore_index=-1)])
    ev = evaluate.main(_eval_argv(root, weights, "host", tmp_path / "ev") + ["--device", "cpu"])
    np.testing.assert_array_equal(counts, ev["slides"][0]["counts"])
    for head, size in (("context", 2 * SEG), ("target", 2 * T)):
        stitched = native.load_image(str(pdir / f"{group.filename}_{head}_stitched.png"))
        assert stitched.shape == (size, size)
        stitch = PR.stitch_context_preds if head == "context" else PR.stitch_target_preds
        np.testing.assert_array_equal(stitched, stitch(preds[head], ids, grid, SEG))
    np.testing.assert_array_equal(  # the context map is the 4 tiles' maps side by side
        stitched_ctx := native.load_image(str(pdir / f"{group.filename}_context_stitched.png")),
        preds["context"].reshape(2, 2, SEG, SEG).transpose(0, 2, 1, 3).reshape(2 * SEG, -1))
    assert stitched_ctx.dtype == np.uint8


def test_extract_features_into_linear_probe(bcss, tmp_path):
    """From an SSL checkpoint of the port's CLI: features of the fold's
    train and val sides (every tile, fp16, shapes by the spec, a
    ``features.json``), then the linear and the kNN probe on them with
    finite scores."""
    root, _, _ = bcss
    ssl = ssl_train.main(["--synthetic", "4", "-a", ARCH, "--scale", "2", "-i", "32",
                          "--tile-px", "32", "-b", "2", "--epochs", "1", "--save-freq", "1",
                          "--device", "cpu", "--imagenet-weights", "none",
                          "--log-dir", str(tmp_path / "ssl")])
    ckpt = str(Path(ssl["log_dir"]) / "checkpoint_0000.pth.tar")
    dirs = {}
    for split in ("train", "val"):
        out = extract_features.main([
            "--weights", ckpt, "-a", ARCH, "--scale", "2", "--img-sz", "32", "--train-data",
            root, "--split", split, "--chunk", "4", "--device", "cpu", "--out",
            str(tmp_path / split), "--log-dir", str(tmp_path / f"x_{split}")])
        dirs[split] = out["out_dir"]
        npz = sorted(Path(out["out_dir"]).glob("*.npz"))
        assert out["tiles"] == (10 if split == "train" else 4)
        assert len(npz) == (10 if split == "train" else 1)
        z = np.load(npz[0])
        for b, s, c in out["spec"]:
            arr = z[f"{b}_s{s}"]
            assert arr.dtype == np.float16 and np.isfinite(arr).all()
            assert arr.shape[1:] == ((c,) if b == "context" else (4, c))
    manifest = json.loads((Path(dirs["val"]) / "features.json").read_text())
    assert [k["key"] for k in manifest["keys"]][:2] == ["context_s1", "context_s2"]
    for probe, key in (("linear", "context_s4"), ("knn", "target_s3")):
        res = linear_probe.main(["--features", dirs["train"], "--features-val", dirs["val"],
                                 "--train-data", root, "--probe", probe, "--key", key,
                                 "--epochs", "5", "--device", "cpu", "--log-dir",
                                 str(tmp_path / f"probe_{probe}")])
        assert len(res["val"]["labels"]) == 4
        for split in ("train", "val"):
            assert 0.0 <= res[split]["acc"] <= 1.0 and np.isfinite(res[split]["micro_f1"])
        lo, hi = res["val"]["acc_ci95"]
        assert 0.0 <= lo <= hi <= 1.0


def test_a_hooknet_checkpoint_is_refused_by_extract_features(bcss, tmp_path):
    _, weights, _ = bcss
    with pytest.raises(ValueError, match="is this an SSL checkpoint"):
        extract_features.main(["--weights", weights, "-a", ARCH, "--synthetic", "1",
                               "--device", "cpu", "--log-dir", str(tmp_path / "x")])


def test_dataset_stats_equal_numpy(bcss, capsys):
    """Over every tile of ``data.csv`` (``--fold -1``): numpy's float64 mean
    and std of the same tiles' [0, 1] pixels."""
    root, _, tiles = bcss
    mean, std = dataset_stats.main(["--train-data", root, "--fold", "-1", "--device", "cpu"])
    x = tiles.reshape(-1, 3).astype(np.float64) / 255.0
    np.testing.assert_allclose(mean, x.mean(0), rtol=1e-12)
    np.testing.assert_allclose(std, x.std(0), rtol=1e-9)
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("--mean ")


def test_parity_check_passes_within_tolerance_and_fails_beyond(bcss, tmp_path, capsys):
    """On a fake ``.pth.tar`` and synthetic slides: the measured number,
    the SSL surgery check, parity at that number, failure 0.1 away."""
    _, weights, _ = bcss
    ssl = ssl_train.main(["--synthetic", "2", "-a", ARCH, "--scale", "2", "-i", "32",
                          "--tile-px", "32", "-b", "2", "--epochs", "1", "--save-freq", "1",
                          "--device", "cpu", "--imagenet-weights", "none",
                          "--log-dir", str(tmp_path / "ssl")])
    base = ["--weights", weights, "-a", ARCH, "--synthetic", "2", "--seg-size", str(SEG),
            "--val-chunk", "4", "--device", "cpu", "--log-dir", str(tmp_path / "p")]
    ssl_ckpt = str(Path(ssl["log_dir"]) / "checkpoint_0000.pth.tar")
    assert parity_check.main(base + ["--ssl-weights", ssl_ckpt]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert any('"ssl_surgery": "ok"' in line for line in lines)
    measured = json.loads(lines[-1])["measured"]
    assert parity_check.main(base + ["--reference-miou", str(measured)]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["parity"] is True
    assert parity_check.main(base + ["--reference-miou", str(measured + 0.1)]) == 1
    verdict = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert verdict["parity"] is False and verdict["delta"] == pytest.approx(-0.1, abs=1e-6)


@pytest.mark.parametrize("as_name", ["dir", "pth_tar_name"])
def test_an_orbax_directory_raises_naming_the_converter(tmp_path, as_name):
    orbax = tmp_path / "best_ft_model"
    orbax.mkdir()
    weights = str(orbax) if as_name == "dir" else str(orbax) + ".pth.tar"
    with pytest.raises(ValueError, match=r"reads \.pth\.tar files.*tools/export_torch\.py "
                                         r"--kind hooknet"):
        evaluate.main(["--weights", weights, "--synthetic", "1", "--device", "cpu",
                       "--log-dir", str(tmp_path / "e")])
    with pytest.raises(ValueError, match=r"tools/export_torch\.py --kind ssl"):
        extract_features.main(["--weights", weights, "--synthetic", "1", "--device", "cpu",
                               "--log-dir", str(tmp_path / "x")])


def test_bench_eval_e2e_prints_bench_py_line(capsys):
    """``BENCH_MODE=eval_e2e --device cpu`` at a tiny size: the windows'
    rates, median and quartiles, and ``bench.py``'s metric name."""
    env = {"BENCH_MODE": "eval_e2e", "BENCH_ARCH": ARCH, "BENCH_BATCH": "2",
           "BENCH_ITERS": "1", "BENCH_WARMUP": "1", "BENCH_REPEATS": "2"}
    res = bench.main(["--device", "cpu"], env=env, seg_size=64)
    lines = capsys.readouterr().out.strip().splitlines()
    last = json.loads(lines[-1])
    assert last == {"metric": "eval_cli_e2e_source_tiles_per_sec[resnet10,2t/slide,hostviews]",
                    "value": res["value"], "unit": "tiles/sec/chip"}
    assert np.isfinite(last["value"]) and last["value"] > 0 and len(res["rates"]) == 2
    assert "median" in lines[-2] and "quartiles" in lines[-2]


def test_entry_points_need_a_gpu_or_an_explicit_cpu(tmp_path):
    """Without a card, each entry point raises unless given ``--device
    cpu``, before it makes its log directory."""
    if torch.cuda.is_available():
        pytest.skip("checks the rule on a machine without a GPU")
    argv = {
        "evaluate": ["--synthetic", "1"],
        "predict": ["--weights", "w.pth.tar", "--synthetic", "1"],
        "extract_features": ["--weights", "random", "--synthetic", "1"],
        "linear_probe": ["--features", "a", "--features-val", "b", "--train-data", "c"],
        "dataset_stats": ["--tiles-dir", str(tmp_path)],
        "parity_check": ["--weights", "w.pth.tar", "--synthetic", "1"],
    }
    for name, cli in CLIS.items():
        extra = [] if name == "dataset_stats" else ["--log-dir", str(tmp_path / name)]
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(argv[name] + extra)
        assert not (tmp_path / name).exists(), name
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main([], env={"BENCH_MODE": "eval_e2e"})
