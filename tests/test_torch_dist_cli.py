"""The port's CLIs over a process group: ``ssl_train`` and
``ssl_finetune`` at world 2 (data parallelism, ``--model-parallel 2`` and
a resume across them, rank-0-only files, the JAX CLI's errors), the
recipe's ``--multiprocessing-distributed --world-size 1 --rank 0`` forming
a real group, ``--multiprocessing-distributed --world-size 2 --device
cpu`` spawning two processes, and ``evaluate``, ``predict`` and
``extract_features`` with their chunks split over two ranks against the
JAX package's single-process CLIs (resnet10; two spawned processes over
gloo, ``torch_dist.run_world``)."""

import logging
import os
import shutil
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from msfwsi_tpu.utils.logger import setup_logger as jax_setup_logger
from msfwsi_tpu_torch import native, ssl_train
from msfwsi_tpu_torch.data import datasets as D
from msfwsi_tpu_torch.diag.datapath import smooth_tiles, write_bcss_dataset, write_bcss_masks
from msfwsi_tpu_torch.models.hooknet import build_hooknet
from msfwsi_tpu_torch.parallel.mesh import MeshSpec, plan_launch
from msfwsi_tpu_torch.train import checkpoint as C
from msfwsi_tpu_torch.train import ssl as S
from msfwsi_tpu_torch.utils import close_logger
from torch_dist import TIMEOUT, cases, cli, run_world
from torch_parity import jax_tool

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
ARCH, SEG = "resnet10", 64
SSL = ["-a", ARCH, "--scale", "2", "-i", "32", "--tile-px", "32", "--device", "cpu",
       "--imagenet-weights", "none", "--epochs", "1"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A BCSS-style directory (14 tiles of 128 px, the last 4 one
    validation slide), its validation slide as a tiles dir, a port
    ``best_ft_model.pth.tar`` and a port SSL checkpoint."""
    base = tmp_path_factory.mktemp("dist_cli")
    root = str(base / "data")
    tiles = smooth_tiles(14, 2 * SEG, seed=3)
    files = write_bcss_dataset(root, tiles)
    write_bcss_masks(root, files, (tiles[..., 0] // 43).astype(np.uint8), n_val=4)
    group = D.bcss_seg_val_slides(root)[0]
    slide_dir = base / "tiles" / group.filename / "images"
    slide_dir.mkdir(parents=True)
    for i, s in enumerate(group.samples):
        shutil.copy(Path(root) / s.img, slide_dir / f"{i}.png")
    (base / "ft").mkdir()
    model = build_hooknet(torch.Generator().manual_seed(1), arch=ARCH, classes=6)
    ft = C.save_best_ft_model(str(base / "ft"), model, epoch=0, arch=ARCH)
    state = S.create_ssl_state(S.SSLConfig(arch=ARCH, scale=2, seed=5), device="cpu")
    (base / "ssl").mkdir()
    ssl = C.save_checkpoint(str(base / "ssl"), state, 0, ARCH)
    return base, root, ft, ssl


def _infer_argv(data, name, log_dir):
    base, root, ft, ssl = data
    if name == "evaluate":
        return ["-a", ARCH, "--seg-size", str(SEG), "--data-name", "bcss", "--train-data", root,
                "--weights", ft, "--val-views", "host", "--val-chunk", "4", "--log-dir", log_dir]
    if name == "predict":
        return ["-a", ARCH, "--seg-size", str(SEG), "--weights", ft, "--tiles-dir",
                str(base / "tiles"), "--head", "both", "--val-chunk", "4", "--log-dir", log_dir]
    return ["-a", ARCH, "--scale", "2", "--img-sz", "32", "--weights", ssl, "--synthetic", "3",
            "--tile-px", "64", "--chunk", "4", "--out-dtype", "float32", "--log-dir", log_dir]


INFER = ("evaluate", "predict", "extract_features")


@pytest.fixture(scope="module")
def world(data, tmp_path_factory):
    """Every world-2 CLI run of this module, in one spawn of two ranks."""
    base = data[0]
    runs = tmp_path_factory.mktemp("runs")
    calls = {
        "dp": ("ssl_train", SSL + ["--synthetic", "8", "-b", "4", "--save-freq", "1"]),
        "bad_batch": ("ssl_train", SSL + ["--synthetic", "8", "-b", "3"]),
        "bad_accum": ("ssl_train", SSL + ["--synthetic", "8", "-b", "4", "--accum-steps", "4"]),
        "bad_mp": ("ssl_train", SSL + ["--synthetic", "8", "-b", "4", "--model-parallel", "3"]),
        "ft": ("ssl_finetune", ["-a", ARCH, "--seg-size", str(SEG), "--synthetic", "3", "-b",
                                "4", "--epochs", "1", "--val-chunk", "4", "--device", "cpu"]),
        **{name: (name, _infer_argv(data, name, str(runs / name)) + ["--device", "cpu"])
           for name in INFER},
    }
    calls = {k: (cli, (mod, argv + (["--log-dir", str(runs / k)] if "--log-dir" not in argv
                                    else [])))
             for k, (mod, argv) in calls.items()}
    # the TP run resumes the data-parallel run's checkpoint, so it comes after
    calls["tp"] = (cli, ("ssl_train", SSL + ["--synthetic", "8", "-b", "4", "--epochs", "2",
                                            "--model-parallel", "2", "--resume",
                                            str(runs / "dp" / "checkpoint_0000.pth.tar"),
                                            "--log-dir", str(runs / "tp")]))
    return runs, run_world(cases, 2, base / "world", calls)


def test_ssl_train_world_two_writes_once(world):
    """``ssl_train`` at world 2 (a group the caller formed): one run dir,
    ``configs.txt`` and checkpoint written by rank 0, each rank's log
    (``log.txt``, ``log.txt.rank1``), both ranks the same global loss; then
    ``--model-parallel 2 --resume`` takes that checkpoint and trains on."""
    runs, ranks = world
    a, b = ranks[0]["dp"], ranks[1]["dp"]
    assert a["process_group"] == {"backend": "gloo", "world": 2, "rank": 0}
    assert b["process_group"]["rank"] == 1 and a["log_dir"] == b["log_dir"]
    assert a["epochs"][0]["loss"] == b["epochs"][0]["loss"] and np.isfinite(a["epochs"][0]["loss"])
    assert a["epochs"][0]["steps"] == 2  # 8 tiles, 2 a rank a step
    run = Path(a["log_dir"])
    assert sorted(p.name for p in run.iterdir() if p.is_file()) == [
        "checkpoint_0000.pth.tar", "configs.txt", "log.txt", "log.txt.rank1"]
    assert "process group: gloo, rank 0 of 2" in (run / "log.txt").read_text()
    tp = ranks[0]["tp"]
    assert tp["start_epoch"] == 1 and [e["epoch"] for e in tp["epochs"]] == [1]
    assert tp["epochs"][0]["loss"] == ranks[1]["tp"]["epochs"][0]["loss"]
    assert "tensor-parallel over 2 ranks" in (Path(tp["log_dir"]) / "log.txt").read_text()


def test_bad_sizes_fail_as_the_jax_cli(world):
    """A ``-b`` the data ranks do not divide, a per-rank batch that
    ``--accum-steps`` does not divide and a ``--model-parallel`` that does
    not divide the world fail on every rank, as ``tools/ssl_train.py:57-80``
    exits, before a run dir is made."""
    runs, ranks = world
    for r in ranks:
        assert r["bad_batch"]["error"] == "global batch 3 must be divisible by the 2-rank data axis"
        assert r["bad_accum"]["error"] == "per-rank batch 2 must be divisible by --accum-steps 4"
        assert r["bad_mp"]["error"].startswith("bad --model-parallel 3: mesh 0x3 does not cover 2")
    assert not any((runs / k).exists() for k in ("bad_batch", "bad_accum", "bad_mp"))


def test_ssl_finetune_world_two(world):
    """``ssl_finetune`` at world 2 on 9 training tiles (a trailing batch
    wrap-padded on each rank): the same loss and scores on both ranks, and
    ``best_ft_model.pth.tar`` written once."""
    _, ranks = world
    a, b = ranks[0]["ft"], ranks[1]["ft"]
    assert a["epochs"][0]["loss"] == b["epochs"][0]["loss"]
    assert a["summary"] == b["summary"] and a["process_group"]["world"] == 2
    files = sorted(p.name for p in Path(a["log_dir"]).iterdir() if p.is_file())
    assert files == ["best_ft_model.pth.tar", "configs.txt", "log.txt", "log.txt.rank1"]
    assert "sharding validation chunks over 2 ranks" in (Path(a["log_dir"]) / "log.txt").read_text()


def _jax_cli(name, argv):
    tool = jax_tool(name)
    args = tool.PARSER.parse_args(argv)
    Path(args.log_dir).mkdir(parents=True, exist_ok=True)
    try:
        return tool.main_worker(args)
    finally:  # the JAX CLI leaves its logger set up
        close_logger(logging.getLogger("MSF-WSI"))
        jax_setup_logger.cache_clear()


def test_sharded_evaluate_matches_the_jax_cli(world, data, tmp_path, monkeypatch):
    """``evaluate`` with each chunk of 4 split 2 + 2 over the ranks (the
    counts all-reduced) gives every rank the JAX CLI's scores within
    ``tests/test_torch_eval_cli.py``'s 5e-3."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    _, ranks = world
    want = _jax_cli("evaluate", _infer_argv(data, "evaluate", str(tmp_path / "jax")))
    for r in ranks:
        got = r["evaluate"]["summary"]
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], abs=5e-3), k
    assert "sharding validation chunks over 2 ranks" in (
        Path(ranks[0]["evaluate"]["log_dir"]) / "log.txt").read_text()


def test_sharded_predict_matches_the_jax_cli(world, data, tmp_path):
    """``predict --head both`` with its chunks split over the ranks: rank 0
    writes every tile's masks (rank 1 none); against ``tools/predict.py``
    at most 1e-4 of the pixels differ (measured: none)."""
    _, ranks = world
    out = Path(ranks[0]["predict"]["out_dir"])
    assert ranks[0]["predict"]["tiles"] == ranks[1]["predict"]["tiles"] == 4
    jout = Path(_jax_cli("predict", _infer_argv(data, "predict", str(tmp_path / "jax"))))
    pngs = sorted(p.relative_to(jout) for p in jout.rglob("*.png"))
    assert len(pngs) == 8 and pngs == sorted(p.relative_to(out) for p in out.rglob("*.png"))
    diff = total = 0
    for p in pngs:
        a, b = native.load_image(str(out / p)), native.load_image(str(jout / p))
        assert a.shape == b.shape
        diff += int((a != b).sum())
        total += a.size
    assert diff <= 1e-4 * total, (diff, total)


def test_sharded_features_match_the_jax_cli(world, data, tmp_path):
    """``extract_features`` with its chunks split over the ranks: rank 0
    writes each slide's ``.npz``; every feature within
    ``tests/test_torch_features.py``'s rtol 1e-4 / atol 1e-5 of
    ``tools/extract_features.py``'s on the same SSL checkpoint."""
    _, ranks = world
    out = Path(ranks[0]["extract_features"]["out_dir"])
    jout = Path(_jax_cli("extract_features",
                         _infer_argv(data, "extract_features", str(tmp_path / "jax"))))
    names = sorted(p.name for p in jout.glob("*.npz"))
    assert len(names) == 2 and names == sorted(p.name for p in out.glob("*.npz"))
    for n in names:
        got, want = np.load(out / n), np.load(jout / n)
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            if k == "stems":
                assert (got[k] == want[k]).all()
                continue
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)


def test_recipe_flags_form_a_group_of_one(tmp_path):
    """The recipes' ``--multiprocessing-distributed --world-size 1 --rank 0``
    forms a real process group of one (gloo on the CPU) in this process
    (its rendezvous a file, not a TCP port, beside parallel test workers)."""
    out = ssl_train.main(SSL + ["--synthetic", "4", "-b", "4", "--multiprocessing-distributed",
                                "--world-size", "1", "--rank", "0", "--dist-url",
                                f"file://{tmp_path}/store", "--log-dir", str(tmp_path / "run")])
    assert out["process_group"] == {"backend": "gloo", "world": 1, "rank": 0}
    assert not torch.distributed.is_initialized()  # destroyed at the end


def test_cpu_world_size_spawns_that_many_processes(tmp_path):
    """On the CPU ``--multiprocessing-distributed --world-size 2`` spawns
    two gloo processes on this host: one run dir, two ranks' logs. The CLI
    runs in a process group of its own, killed at the time limit."""
    argv = SSL + ["--synthetic", "4", "-b", "4", "--multiprocessing-distributed", "--world-size",
                  "2", "--dist-url", f"file://{tmp_path}/store", "--log-dir", str(tmp_path / "run")]
    proc = subprocess.Popen([sys.executable, "-m", "msfwsi_tpu_torch.ssl_train", *argv],
                            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    assert proc.returncode == 0, out[-3000:]
    run = tmp_path / "run"
    assert (run / "log.txt.rank1").exists() and (run / "configs.txt").exists()
    assert "process group: gloo, rank 0 of 2" in (run / "log.txt").read_text()


def test_launch_plans():
    """``plan_launch``: the backend follows the device (``nccl`` for CPU
    tensors raises), a manual multi-process launch needs its rank and
    rendezvous, ``torchrun``'s environment is read (before the flags), and
    no flags mean no group; ``MeshSpec`` keeps the JAX package's rules and messages."""
    cpu = torch.device("cpu")
    assert plan_launch(cpu, environ={}) is None
    with pytest.raises(ValueError, match="nccl needs --device cuda"):
        plan_launch(cpu, world_size=2, rank=0, dist_url="file:///x", dist_backend="nccl",
                    environ={})
    with pytest.raises(ValueError, match="needs --dist-url"):
        plan_launch(cpu, world_size=2, rank=1, environ={})
    p = plan_launch(cpu, world_size=2, rank=1, dist_url="file:///x", environ={})
    assert (p.world, p.rank, p.nprocs, p.backend) == (2, 1, 1, "gloo")
    env = {"RANK": "3", "WORLD_SIZE": "4", "LOCAL_RANK": "1"}
    p = plan_launch(cpu, environ=env)
    assert (p.world, p.rank, p.nprocs, p.init_method) == (4, 3, 1, "env://")
    # the recipe's flags under torchrun: its environment decides
    assert plan_launch(cpu, world_size=1, rank=0, multiprocessing_distributed=True,
                       environ=env) == p
    p = plan_launch(cpu, world_size=3, multiprocessing_distributed=True, dist_url="file:///x",
                    environ={})
    assert (p.world, p.nprocs) == (3, 3)
    assert MeshSpec().resolve(8) == (8, 1) and MeshSpec(model=2).resolve(8) == (4, 2)
    with pytest.raises(ValueError, match="mesh 1x3 does not cover 4 devices"):
        MeshSpec(data=1, model=3).resolve(4)
    with pytest.raises(ValueError, match="model axis size must be >= 1"):
        MeshSpec(model=0).resolve(4)
