"""The port's data parallelism against the JAX package's mesh step: the SSL
step at world 2 over gloo (two spawned processes, ``torch_dist.run_world``)
against JAX's step on the global batch, with Adam at accum 1 and 2 and with
the fused Adafactor on bf16 heads; the fused step's view draws at world 2
against one process; and the fine-tuning step at world 2 with a
wrap-padded trailing batch against JAX's ``MeshSpec(data=2)`` step and
``valid`` mask (resnet10, scale 2, 32 px SSL views, 64 px seg views, amp
off).

The JAX oracles: ``MeshSpec(data=2)`` on the conftest's virtual devices for
the accum-1 SSL step and the fine-tuning step; for accum 2 and the fused
Adafactor the single-device jitted step, which the JAX suite holds equal
to its mesh step (``tests/test_accum.py:285``, ``test_train_ssl.py:288``)
and whose compiles the accumulation and bf16 parity tests share."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msfwsi_tpu.data import pipeline as JP
from msfwsi_tpu.parallel import MeshSpec, make_mesh, shard_batch
from msfwsi_tpu.train import finetune as JFT
from msfwsi_tpu.train import ssl as JS
from msfwsi_tpu_torch.models.backbone import build_msfwsi
from msfwsi_tpu_torch.parallel.mesh import MeshSpec as PortMeshSpec
from msfwsi_tpu_torch.parallel.mesh import take_rows
from msfwsi_tpu_torch.train import ssl as S
from msfwsi_tpu_torch.train.checkpoint import jax_hooknet_to_torch, jax_msfwsi_to_torch
from torch_dist import cases, finetune_step, fused_ssl_steps, run_world, ssl_steps
from torch_parity import (jax_fused_factors, jax_ssl_state_from_port, jax_suite_distances,
                          numpy_tree, seg_view_draws, ssl_random_views)

torch.set_num_threads(2)

BASE = dict(arch="resnet10", scale=2, amp=False)
CASES = {
    "adam-accum1": (dict(batch_size=16), "mesh"),
    "adam-accum2": (dict(batch_size=16, accum_steps=2), "single"),
    "fused_adafactor-bf16": (dict(batch_size=8, inter_opt="fused_adafactor",
                                  inter_dtype="bfloat16"), "single"),
}


def _jax_step(jcfg, jstate, views, oracle):
    batch = {k: jnp.asarray(v) for k, v in views.items()}
    if oracle == "mesh":
        mesh = make_mesh(MeshSpec(data=2), devices=jax.devices()[:2])
        return JS.make_jitted_train_step(jcfg, mesh=mesh, donate=False)(
            jstate, shard_batch(mesh, batch))
    return JS.make_jitted_train_step(jcfg, donate=False)(jstate, batch)


ARCH, SEG, NUM_FG = "resnet10", 64, 3
FT_KW = dict(arch=ARCH, class_names=("a", "b", "c"), batch_size=8, amp=False)
FUSED = (dict(BASE, batch_size=8, accum_steps=2), dict(img_size=32, grid=2, tile_px=32))


def _ft_batch():
    """A trailing batch of 5 real tiles wrap-padded per rank to 4 + 4
    (``valid`` 1110 / 1100, the CLI's ``pad_last`` over ranks)."""
    rng = np.random.default_rng(4)
    real_imgs = rng.integers(0, 256, (5, 4 * SEG, 4 * SEG, 3), dtype=np.uint8)
    real_masks = rng.integers(0, NUM_FG + 1, (5, 4 * SEG, 4 * SEG), dtype=np.uint8)
    order = [0, 1, 2, 0, 3, 4, 3, 4]
    return real_imgs[order], real_masks[order], np.array([1, 1, 1, 0, 1, 1, 0, 0], bool)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every world-2 run of this module, in one spawn of two processes."""
    calls = {}
    for case, (extra, _) in CASES.items():
        cfg = dict(BASE, **extra)
        calls[case] = (ssl_steps, (cfg, [ssl_random_views(cfg["batch_size"], 2, 32, 100)]))
    tiles = np.random.default_rng(5).integers(0, 256, (8, 64, 64, 3), dtype=np.uint8)
    calls["fused"] = (fused_ssl_steps, (*FUSED, tiles, 11, 2))
    imgs, masks, valid = _ft_batch()
    params = seg_view_draws(jax.random.key(7), 8, jnp.float32)
    calls["finetune"] = (finetune_step, (FT_KW, SEG, imgs, masks, valid, params, 2))
    return run_world(cases, 2, tmp_path_factory.mktemp("dp"), calls)


@pytest.mark.parametrize("case", list(CASES))
def test_ssl_world_two_matches_jax(case, world):
    """One SSL step at world 2 (each rank on its 8 or 4 contiguous rows of
    the global batch) against JAX's step on the global batch from the same
    weights: the loss within rel 1e-4 / abs 1e-5, every parameter within
    2.05 lr with fewer than 1% of elements beyond 0.5 lr
    (``tests/test_train_ssl.py:305-327``), the BatchNorm running stats
    within 1e-5, and both ranks' parameters and statistics equal bit for
    bit. With bf16 fused-Adafactor heads, the bf16 bounds of
    ``tests/test_torch_inter_bf16.py``: the loss within rel 5e-2 / abs
    1e-5 and ``jax_suite_distances``' bf16 bounds; and each fused weight's
    ``v_row`` and ``v_col`` after the step (the mean squares of the global
    batch's gradient: the rows gathered over the ranks; a rank that kept
    its own rows would see half the batch) within 5e-2 of JAX's in
    relative L2 norm (measured 1.3e-2: bf16 state, rounded apart by the two
    implementations' gradients)."""
    extra, oracle = CASES[case]
    cfg = dict(BASE, **extra)
    config = S.SSLConfig(**cfg)
    jcfg = JS.SSLConfig(img_size=32, mask_ratio=50, **cfg)
    views = ssl_random_views(config.batch_size, 2, 32, 100)
    ranks = [r[case] for r in world]
    model = S.create_ssl_state(config, device="cpu").model  # the seed's init, as every rank's
    jstate, jm = _jax_step(jcfg, jax_ssl_state_from_port(jcfg, model), views, oracle)

    assert ranks[0]["local"] == ranks[1]["local"]  # bit for bit
    bf16 = cfg.get("inter_dtype") == "bfloat16"
    loss = ranks[0]["losses"][0]["loss"]
    assert loss == ranks[1]["losses"][0]["loss"]
    assert loss == pytest.approx(float(jm["loss"]), rel=5e-2 if bf16 else 1e-4, abs=1e-5)

    want = jax_msfwsi_to_torch(numpy_tree({"params": jstate.params,
                                           "batch_stats": jstate.batch_stats}))
    got = ranks[0]["full"]
    buffers = {n for n, _ in model.named_buffers()}
    for k in buffers:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    lr = config.init_lr
    if bf16:
        model.load_state_dict(got)
        jax_suite_distances(model, jstate, lr, bf16=True, adafactor_heads=True)
        jfactors = jax_fused_factors(jstate)
        assert ranks[0]["factors"].keys() == jfactors.keys() and len(jfactors) >= 12
        for k, f in jfactors.items():
            for key in ("v_row", "v_col"):
                a = ranks[0]["factors"][k][key].numpy()
                assert np.linalg.norm(a - f[key]) <= 5e-2 * np.linalg.norm(f[key]), (k, key)
        return
    total = loose = 0
    for k, w in want.items():
        if k in buffers:
            continue
        d = np.abs(got[k].float().numpy() - w.numpy())
        assert d.max() <= 2.05 * lr, (k, float(d.max()) / lr)
        loose += int((d > 0.5 * lr).sum())
        total += d.size
    assert loose / total < 0.01, loose / total


def test_fused_step_draws_the_global_batch_views(world):
    """The fused step at world 2 with accum 2: every rank draws the view
    parameters of the global microbatch from the step's generator and
    applies its rows, so the loss equals the single-process step's on the
    global tiles (rel 1e-4 / abs 1e-5) and the weights agree within 2.05 lr
    with fewer than 1% beyond 0.5 lr; both ranks end bit-equal."""
    cfg, aug = FUSED
    tiles = np.random.default_rng(5).integers(0, 256, (8, 64, 64, 3), dtype=np.uint8)
    ranks = [r["fused"] for r in world]
    one = fused_ssl_steps(0, cfg, aug, tiles, 11, 1)
    assert ranks[0]["loss"] == ranks[1]["loss"]
    assert ranks[0]["loss"] == pytest.approx(one["loss"], rel=1e-4, abs=1e-5)
    lr = S.SSLConfig(**cfg).init_lr
    total = loose = 0
    assert ranks[0]["digests"] == ranks[1]["digests"]
    for k, v in one["state"].items():
        d = (ranks[0]["state"][k] - v).abs()
        if "running" in k:
            torch.testing.assert_close(ranks[0]["state"][k], v, rtol=1e-5, atol=1e-5)
            continue
        assert float(d.max()) <= 2.05 * lr, k
        loose += int((d > 0.5 * lr).sum())
        total += d.numel()
    assert loose / total < 0.01


def test_take_rows_and_born_state_match_one_process():
    """``take_rows`` cuts view parameters (per-sample and per-tile leading
    axes) at a rank's rows, and a mesh of one is the single-process state:
    ``build_msfwsi`` with it draws the same weights."""
    tree = {"a": torch.arange(8), "b": [torch.arange(32).view(16, 2)], "c": (torch.ones(8, 3),)}
    part = take_rows(tree, 8, 2, 4)
    assert part["a"].tolist() == [2, 3] and part["b"][0].shape == (4, 2)
    assert part["b"][0][0, 0] == 8 and part["c"][0].shape == (2, 3)
    with pytest.raises(ValueError, match="not a multiple of the batch 8"):
        take_rows({"x": torch.zeros(12)}, 8, 0, 1)
    kw = S.SSLConfig(**BASE).model_kwargs()
    a = build_msfwsi(torch.Generator().manual_seed(3), **kw).state_dict()
    from msfwsi_tpu_torch.parallel.mesh import make_mesh as port_mesh

    mesh = port_mesh(PortMeshSpec())
    assert (mesh.data, mesh.model, mesh.world) == (1, 1, 1)
    b = build_msfwsi(torch.Generator().manual_seed(3), mesh=mesh, **kw).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_finetune_world_two_trailing_batch_matches_jax_mesh(world):
    """A fine-tuning step at world 2 on a trailing batch of 5 real tiles
    wrap-padded per rank to 4 + 4 (``valid`` 1110 / 1100, the CLI's
    ``pad_last`` over ranks) against JAX's ``MeshSpec(data=2)`` fused step
    with the same ``valid``: the pads count in the BatchNorm statistics
    (the running stats match JAX's, whose BatchNorm sees the whole batch)
    and not in the Dice loss (the loss is JAX's masked one), within
    ``tests/test_torch_finetune.py``'s bounds: the loss rel 1e-4, the
    counts exact, the running stats rtol 1e-3 / atol 1e-5, each weight
    within 2 lr with at most 5% of a tensor outside rtol 1e-3 / atol 1e-5."""
    from msfwsi_tpu.train.checkpoint import torch_hooknet_to_flax
    from msfwsi_tpu_torch.models.hooknet import build_hooknet
    from torch_parity import state_numpy

    import optax

    imgs, masks, valid = _ft_batch()
    jcfg = JFT.FinetuneConfig(**FT_KW, seg_size=SEG)
    key = jax.random.key(7)
    ranks = [r["finetune"] for r in world]

    model = build_hooknet(torch.Generator().manual_seed(0), arch=ARCH, classes=NUM_FG + 1)
    v = torch_hooknet_to_flax(state_numpy(model))
    jparams = jax.tree.map(jnp.asarray, v["params"])
    tx = optax.adam(jcfg.init_lr, b1=0.9, b2=0.999, eps=1e-8)
    jstate = JFT.SegTrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                               batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]),
                               opt_state=tx.init(jparams), tx=tx, model=jcfg.build_model())
    mesh = make_mesh(MeshSpec(data=2), devices=jax.devices()[:2])
    jstep = JFT.make_jitted_fused_finetune_step(jcfg, JP.AugConfig(seg_size=SEG), mesh=mesh,
                                                donate=False)
    jstate, jm = jstep(jstate, jnp.asarray(imgs), jnp.asarray(masks), key, jnp.asarray(valid))

    m0, m1 = ranks[0]["metrics"], ranks[1]["metrics"]
    assert float(m0["loss"]) == float(m1["loss"])
    assert float(m0["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4)
    for k in ("tp", "fp", "fn", "tn"):
        np.testing.assert_array_equal(torch.cat([m0[k], m1[k]]).numpy(), np.asarray(jm[k]))
    want = jax_hooknet_to_torch(numpy_tree({"params": jstate.params,
                                            "batch_stats": jstate.batch_stats}))
    got = ranks[0]["state"]
    buffers = {n for n, _ in model.named_buffers()}
    lr = jcfg.init_lr
    assert ranks[0]["digests"] == ranks[1]["digests"]
    for k, w in want.items():
        close = np.isclose(got[k].numpy(), w.numpy(), rtol=1e-3, atol=1e-5)
        if k in buffers:
            assert close.all(), (k, float((got[k] - w).abs().max()))
        else:
            assert (~close).mean() <= 0.05, (k, float((~close).mean()))
            assert float((got[k] - w).abs().max()) <= 2 * lr + 1e-6, k
