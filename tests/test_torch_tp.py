"""Tensor parallelism of the port's fuser heads (``--model-parallel 2``):
the split rule against JAX's; the TP step with the fused Adafactor against
the JAX package's ``MeshSpec(data=1, model=2)`` step, and with Adam and
Adafactor against the one-rank port step; each rank's halves of the heads
and of their optimizer state; the checkpoint a TP run writes against a
one-rank run's; and a TP resume (resnet10, scale 2, 32 px, b8, amp off; two spawned processes over
gloo, ``torch_dist.run_world``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msfwsi_tpu.parallel import MeshSpec, make_mesh, shard_batch
from msfwsi_tpu.parallel.tp import _spec_for, shard_ssl_state
from msfwsi_tpu.train import ssl as JS
from msfwsi_tpu_torch.parallel.tp import split_dim
from msfwsi_tpu_torch.train import checkpoint as C
from msfwsi_tpu_torch.train import ssl as S
from msfwsi_tpu_torch.train.checkpoint import jax_msfwsi_to_torch
from torch_dist import cases, run_world, split_predictor, ssl_steps
from torch_parity import (jax_fused_factors, jax_ssl_state_from_port, jax_suite_distances,
                          numpy_tree, ssl_random_views)

torch.set_num_threads(2)

CFG = dict(arch="resnet10", scale=2, amp=False, batch_size=8)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The TP runs, in one spawn of two ranks (``--model-parallel 2``):
    a checkpoint at init, one Adam step and its checkpoint, a resume from
    it, and one step with each Adafactor."""
    base = tmp_path_factory.mktemp("tp")
    dirs = {k: base / k for k in ("init", "step")}
    for d in dirs.values():
        d.mkdir()
    views = [ssl_random_views(8, 2, 32, 100)]
    calls = {
        "init": (ssl_steps, (CFG, [], 2, None, str(dirs["init"]))),
        "step": (ssl_steps, (CFG, views, 2, None, str(dirs["step"]))),
        "resume": (ssl_steps, (CFG, [], 2, str(C.checkpoint_path(str(dirs["step"]), 0)))),
    }
    for opt in ("adafactor", "fused_adafactor"):
        calls[opt] = (ssl_steps, (dict(CFG, inter_opt=opt), views, 2))
    calls["row_parallel"] = (split_predictor, ())
    return base, run_world(cases, 2, base / "run", calls)


def one_rank(cfg, steps: int, log_dir=None):
    """The one-rank port's state after ``steps`` steps, its checkpoint's
    path (with ``log_dir``) and its losses."""
    state = S.create_ssl_state(S.SSLConfig(**cfg), device="cpu")
    losses = [float(S.ssl_train_step(state, {k: torch.from_numpy(v) for k, v in
                                             ssl_random_views(8, 2, 32, 100 + i).items()},
                                     tuple(state_cfg(cfg).fuser_weights))["loss"])
              for i in range(steps)]
    path = C.save_checkpoint(str(log_dir), state, 0, cfg["arch"]) if log_dir else None
    return state, path, losses


def state_cfg(cfg):
    return S.SSLConfig(**cfg)


@pytest.mark.parametrize("shape,n", [((384, 192), 2), ((192, 48), 2), ((12, 7), 2), ((7, 12), 2),
                                     ((5, 3), 2), ((96,), 2), ((7,), 2), ((96, 48), 4)])
def test_split_rule_is_jax_spec_for(shape, n):
    """``split_dim`` on a torch ``(out, in)`` weight or a vector names the
    axis JAX's ``_spec_for`` splits on the flax ``(in, out)`` kernel or
    vector; nothing outside the ``inter_*`` heads is split."""
    flax_shape = shape[::-1]
    leaf = np.empty(flax_shape)
    spec = tuple(_spec_for(["inter_projector_0", "fc1", "kernel" if len(shape) == 2 else "bias"],
                           leaf, n))
    want = None
    if "model" in spec:
        want = len(shape) - 1 - spec.index("model")
    name = "inter_projector.0.0." + ("weight" if len(shape) == 2 else "bias")
    assert split_dim(name, shape, n) == want
    assert split_dim("context_projector.0.0.weight", shape, n) is None


def test_tp_step_matches_jax_model_two(world):
    """One step under ``--model-parallel 2`` with ``fused_adafactor`` (the
    fuser heads' big kernels on the fused Adafactor, their Gram products
    summed over the model group; the rest of the heads on Adafactor, its
    factors' means taken over the split axis) against JAX's
    ``MeshSpec(data=1, model=2)`` step (the heads placed by
    ``shard_ssl_state``) from the same weights: the loss within rel 1e-4 /
    abs 1e-5; every parameter within 2.05 lr with fewer than 1% of
    elements beyond 0.5 lr, and within ``jax_suite_distances``' fp32
    bounds (the Adafactor heads off by more than 5e-5 + 5e-5 |ref| on at
    most max(2, 0.5%) of a tensor's elements); the running stats within
    1e-5; and each fused weight's ``v_row`` and ``v_col`` after the step
    (the row and column mean squares of its gradient, gathered over the
    ranks; a model group that skipped the Gram sum would halve them) within
    1e-3 of JAX's in relative L2 norm and rtol 1e-2 on every element
    (measured: 1.7e-4 and 1.1e-3)."""
    _, ranks = world
    cfg = dict(CFG, inter_opt="fused_adafactor")
    model = S.create_ssl_state(state_cfg(cfg), device="cpu").model
    jcfg = JS.SSLConfig(img_size=32, mask_ratio=50, **cfg)
    mesh = make_mesh(MeshSpec(data=1, model=2), devices=jax.devices()[:2])
    jstate = shard_ssl_state(jax_ssl_state_from_port(jcfg, model), mesh)
    views = {k: jnp.asarray(v) for k, v in ssl_random_views(8, 2, 32, 100).items()}
    jstep = JS.make_jitted_train_step(jcfg, mesh=mesh, donate=False, model_parallel=True)
    jstate, jm = jstep(jstate, shard_batch(mesh, views))
    got = ranks[0]["fused_adafactor"]
    loss = got["losses"][0]["loss"]
    assert loss == ranks[1]["fused_adafactor"]["losses"][0]["loss"]
    assert loss == pytest.approx(float(jm["loss"]), rel=1e-4, abs=1e-5)
    want = jax_msfwsi_to_torch(numpy_tree({"params": jstate.params,
                                           "batch_stats": jstate.batch_stats}))
    buffers = {n for n, _ in model.named_buffers()}
    lr = state_cfg(cfg).init_lr
    total = loose = 0
    for k, w in want.items():
        if k in buffers:
            np.testing.assert_allclose(got["full"][k].numpy(), w.numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=k)
            continue
        d = np.abs(got["full"][k].numpy() - w.numpy())
        assert d.max() <= 2.05 * lr, (k, float(d.max()) / lr)
        loose += int((d > 0.5 * lr).sum())
        total += d.size
    assert loose / total < 0.01
    model.load_state_dict(got["full"])
    jax_suite_distances(model, jstate, lr, bf16=False, adafactor_heads=True)
    jfactors = jax_fused_factors(jstate)
    assert got["factors"].keys() == jfactors.keys() and len(jfactors) >= 12
    for k, f in jfactors.items():
        for key in ("v_row", "v_col"):
            a = got["factors"][k][key].numpy()
            assert np.linalg.norm(a - f[key]) <= 1e-3 * np.linalg.norm(f[key]), (k, key)
            np.testing.assert_allclose(a, f[key], rtol=1e-2, err_msg=f"{k} {key}")


def test_each_rank_holds_half_of_every_split_head(world):
    """Element counts: every ``inter_*`` weight, vector and running stat
    that the rule splits holds half its elements on each rank (the two
    halves differ), and so do its Adam moments; everything else is whole
    and equal on both ranks."""
    _, ranks = world
    full = ranks[0]["step"]["full"]
    n_split = 0
    for k, v in full.items():
        (sa, da), (sb, db) = ranks[0]["step"]["local"][k], ranks[1]["step"]["local"][k]
        if split_dim(k, tuple(v.shape), 2) is None:
            assert sa == sb == tuple(v.shape) and da == db, k
        else:
            assert np.prod(sa) * 2 == np.prod(sb) * 2 == v.numel() and da != db, k
            n_split += 1
    assert n_split > 30
    state = S.create_ssl_state(state_cfg(CFG), device="cpu")
    ids = {id(p): n for n, p in state.model.named_parameters()}
    names = [ids[id(p)] for g in state.optimizer.param_groups for p in g["params"]]
    for r in ranks:
        local = r["step"]["local"]
        for i, st in r["step"]["opt"].items():
            assert st["exp_avg"][0] == st["exp_avg_sq"][0] == local[names[i]][0]
    sizes = [sum(np.prod(shape) for k, (shape, _) in r["step"]["local"].items()
                 if k.startswith("inter_")) for r in ranks]
    whole = sum(t.numel() for k, t in full.items() if k.startswith("inter_"))
    assert sizes[0] == sizes[1] and whole / 2 <= sizes[0] < 0.51 * whole


def test_tp_checkpoint_is_the_one_rank_file(world, tmp_path):
    """The ``.pth.tar`` a ``--model-parallel 2`` run writes (rank 0, the
    heads and the optimizer state gathered) is a one-rank run's: at init,
    key for key and bit for bit; after one step, the same keys, shapes,
    dtypes and optimizer entries, the values within the step's bounds."""
    base, _ = world
    _, path0, _ = one_rank(CFG, 0, tmp_path)
    tp0 = torch.load(C.checkpoint_path(str(base / "init"), 0), weights_only=True)
    one0 = torch.load(path0, weights_only=True)
    assert tp0.keys() == one0.keys() and tp0["state_dict"].keys() == one0["state_dict"].keys()
    for k, v in one0["state_dict"].items():
        assert tp0["state_dict"][k].dtype == v.dtype and torch.equal(tp0["state_dict"][k], v), k
    assert tp0["optimizer"] == one0["optimizer"]

    (tmp_path / "one").mkdir()
    _, path1, _ = one_rank(CFG, 1, tmp_path / "one")
    tp1 = torch.load(C.checkpoint_path(str(base / "step"), 0), weights_only=True)
    one1 = torch.load(path1, weights_only=True)
    lr = state_cfg(CFG).init_lr
    for k, v in one1["state_dict"].items():
        assert tp1["state_dict"][k].shape == v.shape, k
        assert float((tp1["state_dict"][k] - v).abs().max()) <= 2.05 * lr, k
    s_tp, s_one = tp1["optimizer"]["state"], one1["optimizer"]["state"]
    assert s_tp.keys() == s_one.keys()
    for i in s_one:
        assert {k: tuple(v.shape) for k, v in s_tp[i].items()} == {
            k: tuple(v.shape) for k, v in s_one[i].items()}
    assert tp1["optimizer"]["param_groups"] == one1["optimizer"]["param_groups"]


def test_tp_resume_restores_the_optimizer_state(world):
    """Each rank of a TP resume takes its slices of the saved file: its
    weights and its Adam moments equal the ones it saved, bit for bit, and
    the step count carries over."""
    _, ranks = world
    for r in ranks:
        saved, back = r["step"], r["resume"]
        assert back["step"] == saved["step"] == 1
        assert back["local"] == saved["local"]
        assert back["opt"] == saved["opt"] and len(saved["opt"]) > 0


def test_tp_adam_matches_one_rank(world):
    """The Adam step under TP (each split weight's moments on its rank)
    against the one-rank port step on the same batch, which
    ``tests/test_torch_ssl.py`` holds to the JAX step: the loss within rel
    1e-5 / abs 1e-6, every parameter within 2.05 lr with fewer than 1% of
    elements beyond 0.5 lr, the running stats within 1e-5."""
    _, ranks = world
    state, _, losses = one_rank(CFG, 1)
    got = ranks[0]["step"]
    assert got["losses"][0]["loss"] == pytest.approx(losses[0], rel=1e-5, abs=1e-6)
    lr = state_cfg(CFG).init_lr
    total = loose = 0
    for k, v in state.model.state_dict().items():
        d = (got["full"][k] - v).abs()
        if k.endswith("num_batches_tracked"):
            continue
        if "running" in k:
            torch.testing.assert_close(got["full"][k], v, rtol=1e-5, atol=1e-5)
            continue
        assert float(d.max()) <= 2.05 * lr, k
        loose += int((d > 0.5 * lr).sum())
        total += d.numel()
    assert loose / total < 0.01


@pytest.mark.parametrize("opt", ["adafactor", "fused_adafactor"])
def test_tp_adafactor_matches_one_rank(world, opt):
    """One step of each Adafactor under TP (the factors' means taken over
    the split axis by an all-reduce, the fused Gram products summed over
    the shards) against the one-rank port step on the same batch: the loss
    within rel 1e-5 / abs 1e-6, every fuser-head parameter within 0.05 lr,
    the Adam-trained rest within 2.05 lr with fewer than 1% of elements
    beyond 0.5 lr (Adam's first step moves a weight by lr times its
    gradient's sign)."""
    _, ranks = world
    cfg = dict(CFG, inter_opt=opt)
    state, _, losses = one_rank(cfg, 1)
    loss = ranks[0][opt]["losses"][0]["loss"]
    assert loss == ranks[1][opt]["losses"][0]["loss"]
    assert loss == pytest.approx(losses[0], rel=1e-5, abs=1e-6)
    lr = state_cfg(cfg).init_lr
    got = ranks[0][opt]["full"]
    total = loose = 0
    for k, v in state.model.named_parameters():
        d = (got[k] - v.detach()).abs()
        if k.startswith("inter_"):
            assert float(d.max()) <= 0.05 * lr, (k, float(d.max()) / lr)
        else:
            assert float(d.max()) <= 2.05 * lr, k
            loose += int((d > 0.5 * lr).sum())
            total += d.numel()
    assert loose / total < 0.01


def test_row_parallel_layer_equals_the_whole_head(world):
    """A head whose first ``Linear`` has outputs the model ranks do not
    divide takes JAX's other split, along its inputs (row-parallel: the
    partial outputs summed, the bias added once), its BatchNorm whole, and
    the next ``Linear`` column-parallel: the output, the input's gradient
    and every parameter's gradient equal the unsplit head's on each rank
    within fp32 reassociation: rtol 1e-5, atol 1e-6 of the tensor's largest
    magnitude (the BatchNorm's backward sums over the batch; measured 4e-7
    of it)."""
    _, ranks = world
    for r in ranks:
        got = r["row_parallel"]
        assert got["splits"] == {"inter_predictor.0.0.weight": 1, "inter_predictor.0.3.weight": 0,
                                 "inter_predictor.0.3.bias": 0}
        whole, split = got["whole"], got["split"]
        pairs = [("y", split["y"], whole["y"]), ("x_grad", split["x_grad"], whole["x_grad"])]
        pairs += [(k, split["grads"][k], g) for k, g in whole["grads"].items()]
        for k, a, b in pairs:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * float(b.abs().max()),
                                       msg=k)
