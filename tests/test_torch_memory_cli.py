"""The memory path through the port's entry points on the CPU: ``ssl_train``
with every memory flag, its checkpoint and a resume that restores the
optimizer state exactly; ``ssl_finetune --accum-steps 2`` with a
wrap-padded trailing batch and with a short one that accum divides; and the bench's memory knobs in its metric
names (resnet10, tiny sizes)."""

import json

import numpy as np
import torch

from msfwsi_tpu_torch import bench, ssl_finetune, ssl_train
from msfwsi_tpu_torch.train import checkpoint as C
from msfwsi_tpu_torch.train import finetune as FT
from msfwsi_tpu_torch.train import ssl as S

torch.set_num_threads(2)

MEMORY_FLAGS = ["--accum-steps", "2", "--inter-opt", "fused_adafactor", "--inter-dtype",
                "bfloat16", "--use-ac", "--remat-stages", "1", "2"]


def _argv(log_dir, epochs, *extra):
    return ["--synthetic", "4", "-a", "resnet10", "--scale", "2", "-i", "32", "--tile-px", "32",
            "-b", "4", "--epochs", str(epochs), "--save-freq", "1", "--device", "cpu",
            "--imagenet-weights", "none", "--log-dir", str(log_dir), *MEMORY_FLAGS, *extra]


def _equal(a, b) -> bool:
    """Nested state dicts equal tensor for tensor (values and dtypes)."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def test_ssl_train_memory_flags_checkpoint_and_resume(tmp_path):
    """``ssl_train`` with ``--accum-steps 2 --inter-opt fused_adafactor
    --inter-dtype bfloat16 --use-ac --remat-stages 1 2`` trains 2 epochs and
    writes a checkpoint each; a resume from the first restores the model and
    the three optimizers' states equal to the saved ones, and its second
    epoch ends in the uninterrupted run's state bit for bit."""
    full = ssl_train.main(_argv(tmp_path / "full", 2))
    assert [e["steps"] for e in full["epochs"]] == [1, 1]
    assert all(np.isfinite(e["loss"]) for e in full["epochs"])
    ckpt = C.checkpoint_path(full["log_dir"], 0)
    payload = torch.load(ckpt, weights_only=True)
    assert set(payload["optimizer"]) == {"adam", "adafactor", "fused_adafactor"}
    assert payload["state_dict"]["module.inter_projector.3.0.weight"].dtype == torch.bfloat16

    cfg = S.SSLConfig(arch="resnet10", scale=2, batch_size=4, inter_opt="fused_adafactor",
                      inter_dtype="bfloat16", accum_steps=2, use_ac=True, remat_stages=(1, 2),
                      seed=9)
    fresh = S.create_ssl_state(cfg, device="cpu")
    assert C.restore_checkpoint(ckpt, fresh, "cpu") and fresh.step == 1
    assert _equal(fresh.optimizer.state_dict(), payload["optimizer"])
    assert _equal({f"module.{k}": v for k, v in fresh.model.state_dict().items()},
                  payload["state_dict"])

    resumed = ssl_train.main(_argv(tmp_path / "resume", 2, "--resume", ckpt))
    assert resumed["start_epoch"] == 1 and resumed["state"].step == 2
    assert _equal(resumed["state"].model.state_dict(), full["state"].model.state_dict())
    assert _equal(resumed["state"].optimizer.state_dict(), full["state"].optimizer.state_dict())


def test_ssl_finetune_accum_steps_runs(tmp_path):
    """``ssl_finetune --accum-steps 2`` on 3 synthetic slides of 3 training
    tiles at b4: batches of 4, 4 and 1, the last wrap-padded to 4 and its
    pads masked (a microbatch all padding), finite losses and scores; the
    train F1 counts the 9 real samples only."""
    out = ssl_finetune.main(["--device", "cpu", "-a", "resnet10", "--seg-size", "64",
                             "--synthetic", "3", "-b", "4", "--epochs", "1",
                             "--accum-steps", "2",
                             "--log-dir", str(tmp_path / "ft")])
    (epoch,) = out["epochs"]
    assert epoch["steps"] == 3 and np.isfinite(epoch["loss"]) and 0 <= epoch["val_f1"] <= 1


def test_ssl_finetune_accum_steps_leaves_a_divisible_trailing_batch_short(tmp_path,
                                                                          monkeypatch):
    """``ssl_finetune --accum-steps 2`` on 3 synthetic slides of 2 training
    tiles at b4: the trailing batch of 2, which accum divides, reaches the
    step unpadded and without ``valid``, as the JAX CLI runs it on one
    device (two microbatches of 1; the step on such a batch against JAX is
    ``test_torch_accum_views.py::test_finetune_short_trailing_batch_matches_jax``)."""
    seen = []
    make = FT.make_fused_finetune_step

    def spy(*a, **kw):
        step = make(*a, **kw)

        def wrapped(state, imgs, masks, gen, valid=None):
            seen.append((imgs.shape[0], valid))
            return step(state, imgs, masks, gen, valid=valid)

        return wrapped

    monkeypatch.setattr(FT, "make_fused_finetune_step", spy)
    out = ssl_finetune.main(["--device", "cpu", "-a", "resnet10", "--seg-size", "64",
                             "--synthetic", "2", "-b", "4", "--epochs", "1",
                             "--accum-steps", "2", "--log-dir", str(tmp_path / "ft")])
    assert [(n, v) for n, v in seen] == [(4, None), (2, None)]
    (epoch,) = out["epochs"]
    assert epoch["steps"] == 2 and np.isfinite(epoch["loss"])


def test_bench_names_the_memory_knobs(capsys):
    """The bench's memory knobs, as ``bench.py`` names them in the metric:
    mode ``step`` with every knob, mode ``hooknet`` with BENCH_ACCUM."""
    env = {"BENCH_MODE": "step", "BENCH_ARCH": "resnet10", "BENCH_BATCH": "4",
           "BENCH_ITERS": "1", "BENCH_WARMUP": "1", "BENCH_REPEATS": "1", "BENCH_USE_AC": "1",
           "BENCH_REMAT_STAGES": "1,2", "BENCH_INTER_OPT": "fused_adafactor",
           "BENCH_INTER_DTYPE": "bfloat16", "BENCH_ACCUM": "2"}
    out = bench.main(["--device", "cpu"], env=env, img_size=32)
    assert out["metric"] == ("ssl_pretrain_e2e_tile_views_per_sec_per_chip[resnet10,b4,scale4,"
                             "224px,step,ac,fused_adafactor,interbf16,rs12,accum2]")
    assert np.isfinite(out["value"]) and out["value"] > 0
    env = {**env, "BENCH_MODE": "hooknet", "BENCH_BATCH": "2"}
    out = bench.main(["--device", "cpu"], env=env, seg_size=64)
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["metric"] == "hooknet_finetune_pairs_per_sec_per_chip[resnet10,b2,256px,accum2]"
    assert np.isfinite(last["value"])
