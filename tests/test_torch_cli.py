"""The port's SSL CLI, checkpoints, ImageNet init and bench against the JAX
package, and the CLI end to end on PNG tiles on the CPU."""

import importlib.util
import json
import os
import re
import shlex
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from msfwsi_tpu.train import checkpoint as JC
from msfwsi_tpu.train import ssl as JS
from msfwsi_tpu_torch import bench, ssl_train
from msfwsi_tpu_torch.models.resnet import get_encoder, torch_style_init
from msfwsi_tpu_torch.train import checkpoint as C
from msfwsi_tpu_torch.train import ssl as S
from msfwsi_tpu_torch.utils import imagenet as I
from torch_parity import numpy_tree

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def _jax_cli_parser():
    tools = str(REPO / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    spec = importlib.util.spec_from_file_location("jax_ssl_train_cli", REPO / "tools/ssl_train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build_parser()


def _surface(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.nargs, type(a).__name__,
                     tuple(a.choices) if a.choices is not None else None,
                     getattr(a.type, "__name__", None))
            for a in parser._actions if a.option_strings and a.dest != "help"}


def test_flag_surface_covers_the_jax_cli():
    """Every option string of ``tools/ssl_train.py::build_parser`` with its
    default, type, nargs, action and choices; the port adds ``--device``."""
    want, got = _surface(_jax_cli_parser()), _surface(ssl_train.build_parser())
    assert len(want) == 55
    assert {d: got.get(d) for d in want} == want
    assert set(got) - set(want) == {"device"}


def _recipe_commands():
    """The pretrain commands of ``scripts/*.sh``, shell variables filled in."""
    for script in ("bcss", "paip", "c16"):
        text = (REPO / "scripts" / f"{script}.sh").read_text()
        m = re.search(r"python tools/ssl_train\.py((?:[^\n]*\\\n)*[^\n]*)", text)
        cmd = m.group(1).replace("\\\n", " ")
        for var, value in (("${log_path}", "logs/x"), ("${LOG_PATH}", "logs/x"), ("${f}", "3")):
            cmd = cmd.replace(var, value)
        yield script, shlex.split(cmd)


@pytest.mark.parametrize("script,argv", list(_recipe_commands()))
def test_recipes_parse_verbatim(script, argv):
    args = ssl_train.build_parser().parse_args(argv)
    assert ssl_train._unsupported(args) == [] and args.amp and args.multiprocessing_distributed
    assert args.data_name in ("bcss", "paip", "camelyon16") and args.device == "cuda"


@pytest.mark.parametrize("flags", [
    ["--inter-opt", "adafactor"], ["--inter-opt", "fused_adafactor"],
    ["--inter-dtype", "bfloat16"], ["--accum-steps", "2"], ["--use-ac"],
    ["--remat-stages", "1", "2"], ["--model-parallel", "2"], ["--world-size", "2"],
])
def test_unsupported_values_raise_naming_the_queue_item(flags, tmp_path):
    with pytest.raises(ValueError, match=r"not ported yet, ROADMAP\.md queue 1, "
                                         r"(the large-model memory path|distributed)"):
        ssl_train.main([*flags, "--synthetic", "2", "--device", "cpu",
                        "--log-dir", str(tmp_path / "run")])
    assert not (tmp_path / "run").exists()


# ---- checkpoints and ImageNet init ---------------------------------------

CONFIG = S.SSLConfig(arch="resnet10", scale=2, batch_size=2)


@pytest.fixture(scope="module")
def jax_variables():
    """A JAX train state, and its variables as numpy, holding the weights and
    BN statistics of a port model after one step (through the JAX package's
    own converter; a JAX init would take most of a minute here)."""
    state = S.create_ssl_state(S.SSLConfig(arch="resnet10", scale=2, batch_size=2, seed=3),
                               device="cpu")
    _one_step(state)
    v = JC.torch_msfwsi_to_flax({k: w.numpy() for k, w in state.model.state_dict().items()})
    jconfig = JS.SSLConfig(arch="resnet10", scale=2, img_size=32, batch_size=2)
    params = jax.tree.map(jnp.asarray, v["params"])
    tx = JS.make_ssl_optimizer(jconfig)
    jstate = JS.SSLTrainState(step=jnp.zeros((), jnp.int32), params=params,
                              batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]),
                              opt_state=tx.init(params), tx=tx, model=jconfig.build_model())
    return jstate, numpy_tree({"params": jstate.params, "batch_stats": jstate.batch_stats})


def test_jax_written_pth_tar_loads_exactly(jax_variables, tmp_path):
    """A ``save_torch_file(flax_msfwsi_to_torch(...))`` file: weights and BN
    restored as ``jax_msfwsi_to_torch`` gives them, no optimizer state."""
    _, variables = jax_variables
    path = str(tmp_path / "checkpoint_0004.pth.tar")
    JC.save_torch_file(path, JC.flax_msfwsi_to_torch(variables), epoch=5)
    state = S.create_ssl_state(CONFIG, device="cpu")
    assert C.restore_checkpoint(path, state, "cpu") is False
    want = C.jax_msfwsi_to_torch(variables)
    got = state.model.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert state.optimizer.state_dict()["state"] == {}


def _one_step(state, seed=0):
    tiles = torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (2, 64, 64, 3),
                                                                   dtype=np.uint8))
    aug = S.AugConfig(img_size=32, grid=2, tile_px=32)
    step = S.make_fused_step(CONFIG, aug, device="cpu")
    return step(state, tiles, torch.Generator().manual_seed(seed))


def test_port_checkpoint_round_trip_is_bit_exact(tmp_path):
    state = S.create_ssl_state(CONFIG, device="cpu")
    for i in range(2):
        _one_step(state, i)
    path = C.save_checkpoint(str(tmp_path), state, epoch=6, arch="resnet10")
    assert os.path.basename(path) == "checkpoint_0006.pth.tar"
    assert [p.name for p in tmp_path.iterdir()] == ["checkpoint_0006.pth.tar"]  # no temp left
    payload = torch.load(path, weights_only=True)
    assert payload["epoch"] == 7 and payload["arch"] == "resnet10"
    assert all(k.startswith("module.") for k in payload["state_dict"])

    fresh = S.create_ssl_state(S.SSLConfig(arch="resnet10", scale=2, batch_size=2, seed=9),
                               device="cpu")
    assert C.restore_checkpoint(path, fresh, "cpu") is True
    assert fresh.step == state.step == 2
    a, b = state.model.state_dict(), fresh.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    sa, sb = state.optimizer.state_dict(), fresh.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"] and sa["state"].keys() == sb["state"].keys()
    for i in sa["state"]:
        assert all(torch.equal(sa["state"][i][k], sb["state"][i][k]) for k in sa["state"][i])
    # the next step of both is the same
    assert torch.equal(_one_step(state, 5)["loss"], _one_step(fresh, 5)["loss"])


def test_checkpoint_paths(tmp_path):
    for e in (3, 12, 10000):
        torch.save({}, C.checkpoint_path(str(tmp_path), e))
    assert C.latest_checkpoint(str(tmp_path)).endswith("checkpoint_10000.pth.tar")
    assert C.latest_checkpoint(str(tmp_path / "none")) is None
    orbax = tmp_path / "checkpoint_0049"
    orbax.mkdir()
    assert C.resolve_checkpoint_arg(f"{orbax}.pth.tar") == str(orbax)
    assert C.resolve_checkpoint_arg(str(tmp_path / "nothing.pth.tar")) is None
    state = S.create_ssl_state(CONFIG, device="cpu")
    with pytest.raises(ValueError, match="tools/export_torch.py"):
        C.restore_checkpoint(str(orbax), state, "cpu")


def _torchvision_resnet10(path):
    """A torchvision-layout ResNet state dict from a seeded random resnet10,
    with an ``fc`` and BN ``num_batches_tracked`` as torchvision has them."""
    enc = torch_style_init(get_encoder("resnet10"), torch.Generator().manual_seed(7))
    sd = dict(enc.state_dict())
    gen = torch.Generator().manual_seed(8)
    for k in list(sd):
        if k.endswith("running_var"):
            sd[k] = torch.rand(sd[k].shape, generator=gen) + 0.5
            sd[k.replace("running_var", "running_mean")] = torch.randn(sd[k].shape, generator=gen)
            sd[k.replace("running_var", "num_batches_tracked")] = torch.tensor(100)
    sd["fc.weight"] = torch.randn(1000, 512, generator=gen)
    sd["fc.bias"] = torch.randn(1000, generator=gen)
    torch.save(sd, path)


def test_imagenet_init_matches_jax(jax_variables, tmp_path):
    jstate, _ = jax_variables
    path = str(tmp_path / "resnet10-0000.pth")
    _torchvision_resnet10(path)
    state = S.create_ssl_state(CONFIG, device="cpu")
    heads = {k: v.clone() for k, v in state.model.state_dict().items() if "encoder" not in k}
    _one_step(state)  # the init drops this optimizer state
    state = S.load_imagenet_encoders(state, C.load_torch_file(path), CONFIG)
    assert state.optimizer.state_dict()["state"] == {}
    assert [g["lr"] for g in state.optimizer.param_groups] == [CONFIG.init_lr] * 3

    jstate = JS.load_imagenet_encoders(jstate, JC.load_torch_file(path))
    want = C.jax_msfwsi_to_torch(numpy_tree({"params": jstate.params,
                                             "batch_stats": jstate.batch_stats}))
    got = state.model.state_dict()
    enc = [k for k in want if "encoder" in k]
    assert len(enc) > 50 and all(torch.equal(got[k], want[k]) for k in enc)
    assert not all(torch.equal(got[k], heads[k]) for k in heads)  # heads: one step moved them
    with pytest.raises(FileNotFoundError):
        I.resolve_imagenet_weights("resnet10", str(tmp_path / "missing.pth"))


def test_imagenet_weights_are_searched_locally(tmp_path, monkeypatch):
    monkeypatch.setenv("MSFWSI_IMAGENET_DIR", str(tmp_path))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert I.resolve_imagenet_weights("resnet10") is None
    (tmp_path / "resnet10-abc.pth").write_bytes(b"")
    assert I.resolve_imagenet_weights("resnet10") == str(tmp_path / "resnet10-abc.pth")
    assert I.search_dirs()[0] == str(tmp_path)


# ---- the CLI end to end on the CPU ----------------------------------------

@pytest.fixture(scope="module")
def bcss(tmp_path_factory):
    """A BCSS-style dataset of 10 PIL-written 128 px tiles (one below the
    area threshold)."""
    root = tmp_path_factory.mktemp("bcss")
    (root / "tiles").mkdir()
    rng = np.random.default_rng(0)
    lines = ["filename,filename_img,filename_mask,ratio_masked_area"]
    for i in range(10):
        name = f"tiles/{i:02d}.png"
        Image.fromarray(rng.integers(0, 256, (128, 128, 3), dtype=np.uint8)).save(root / name)
        lines.append(f"TCGA-Z{i % 3}-{i:02d},{name},,{0.05 if i == 9 else 0.5}")
    (root / "data.csv").write_text("\n".join(lines) + "\n")
    return str(root)


def _argv(root, log_dir, *extra):
    return ["-a", "resnet10", "--scale", "2", "-i", "32", "--tile-px", "64", "-b", "4",
            "--data-name", "bcss", "--data", root, "--imagenet-weights", "none",
            "--device", "cpu", "--amp", "--log-dir", str(log_dir), "-p", "1", *extra]


def _same_state(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    oa, ob = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    return (all(torch.equal(sa[k], sb[k]) for k in sa) and oa.keys() == ob.keys()
            and all(torch.equal(oa[i][k], ob[i][k]) for i in oa for k in oa[i]))


def test_cli_trains_checkpoints_and_resumes_bit_identically(bcss, tmp_path):
    straight = ssl_train.main(_argv(bcss, tmp_path / "a", "--epochs", "2", "--save-freq", "1"))
    log_dir = Path(straight["log_dir"])
    assert [e["steps"] for e in straight["epochs"]] == [2, 2]  # 9 tiles, b4, drop_last
    assert all(np.isfinite(e["loss"]) for e in straight["epochs"])
    assert all(0 < e["fill_seconds"] < e["seconds"] for e in straight["epochs"])
    assert (log_dir / "checkpoint_0000.pth.tar").exists()
    assert (log_dir / "checkpoint_0001.pth.tar").exists()
    log = (log_dir / "log.txt").read_text()
    assert "BEST LOSS" in log and "Size of data: 9, steps per epoch: 2" in log
    assert "Epoch: [1][1/2]" in log and "loss" not in log.split("Epoch: [1][1/2]")[1].split("\n")[0]
    assert (log_dir / "configs.txt").exists() and not (log_dir / "error.txt").exists()

    resumed = ssl_train.main(_argv(bcss, tmp_path / "b", "--epochs", "2", "--resume",
                                   str(log_dir / "checkpoint_0000.pth.tar")))
    assert resumed["start_epoch"] == 1 and [e["epoch"] for e in resumed["epochs"]] == [1]
    assert resumed["epochs"][0]["loss"] == straight["epochs"][1]["loss"]
    assert _same_state(resumed["state"], straight["state"])
    assert resumed["state"].step == straight["state"].step == 4


def test_cli_jax_resume_warns_and_packed_cache(bcss, jax_variables, tmp_path):
    """A JAX-written ``.pth.tar`` resumes weights only (with a warning);
    ``--packed-cache`` builds a pack and trains from it; the profiler,
    TensorBoard and wandb flags are taken."""
    _, variables = jax_variables
    ckpt = str(tmp_path / "checkpoint_0000.pth.tar")
    JC.save_torch_file(ckpt, JC.flax_msfwsi_to_torch(variables))
    out = ssl_train.main(_argv(bcss, tmp_path / "run", "--epochs", "2", "--steps-per-epoch", "1",
                               "--resume", ckpt, "--packed-cache", str(tmp_path / "pack"),
                               "--profile-steps", "1", "--tensorboard", "--wandb",
                               "--world-size", "1", "--rank", "0", "--tf32"))
    log = (Path(out["log_dir"]) / "log.txt").read_text()
    assert "restores weights/BN only" in log and "streaming raw tiles from the packed cache" in log
    assert "flag --tf32 accepted for parity but inert" in log
    assert "flag --world-size accepted for parity but inert" in log
    assert "wandb unavailable" in log or "initialise wandb" in log
    assert len(list((tmp_path / "pack").glob("pack_*.npy"))) == 1
    assert (Path(out["log_dir"]) / "profile" / "trace.json").exists()
    assert out["start_epoch"] == 1 and out["epochs"][0]["steps"] == 1


def test_cli_imagenet_auto_without_weights(bcss, tmp_path, monkeypatch):
    monkeypatch.setenv("MSFWSI_IMAGENET_DIR", str(tmp_path / "empty"))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    argv = [a for a in _argv(bcss, tmp_path / "run", "--epochs", "0") if a != "none"]
    argv.remove("--imagenet-weights")
    with pytest.raises(RuntimeError, match="not found locally"):
        ssl_train.main(argv)
    assert "not found locally" in next((tmp_path).glob("run*/error.txt")).read_text()
    out = ssl_train.main(argv + ["--allow-random-init"])
    assert "PRETRAINING FROM RANDOM INIT" in (Path(out["log_dir"]) / "log.txt").read_text()


# ---- bench -----------------------------------------------------------------

def test_bench_step_mode_prints_bench_py_line(capsys):
    env = {"BENCH_MODE": "step", "BENCH_ARCH": "resnet10", "BENCH_BATCH": "2",
           "BENCH_ITERS": "1", "BENCH_WARMUP": "1", "BENCH_REPEATS": "2"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bench.main([], env=env)
    bench.main(["--device", "cpu"], env=env, img_size=32)
    lines = capsys.readouterr().out.strip().splitlines()
    last = json.loads(lines[-1])
    assert set(last) == {"metric", "value", "unit"} and last["unit"] == "tiles/sec/chip"
    assert last["metric"] == ("ssl_pretrain_e2e_tile_views_per_sec_per_chip"
                              "[resnet10,b2,scale4,224px,step]")
    assert np.isfinite(last["value"]) and last["value"] > 0
    assert sum(line.startswith("window ") for line in lines) == 2
    assert "median" in lines[-2] and "quartiles" in lines[-2]
    for mode, metric in (("hooknet", "hooknet_finetune_pairs_per_sec_per_chip[resnet10,b2,256px]"),
                         ("infer", "hooknet_inference_tiles_per_sec_per_chip"
                                   "[resnet10,chunk2,256px]")):
        bench.main(["--device", "cpu"], env={**env, "BENCH_MODE": mode}, seg_size=64)
        last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert last["metric"] == metric and np.isfinite(last["value"]) and last["value"] > 0
    with pytest.raises(ValueError, match="unknown BENCH_MODE"):
        bench.main(["--device", "cpu"], env={"BENCH_MODE": "no_such_mode"})
