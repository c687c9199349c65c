"""The port's SSL pretrain slice as a whole against the JAX package's
``make_jitted_fused_step``, plus the port's device and import rules."""

import ast
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msfwsi_tpu.data import pipeline as JP
from msfwsi_tpu.train import ssl as JS
from msfwsi_tpu_torch.train import ssl as S
from msfwsi_tpu_torch.train.checkpoint import jax_msfwsi_to_torch
from torch_parity import jax_view_params, numpy_tree, port_aug_config, t

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "msfwsi_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msfwsi_tpu", "pandas", "PIL", "cv2")


def _jax_state_from_port(jconfig, model):
    """A JAX train state holding the port model's weights (through the JAX
    package's own converter) and a fresh optimizer."""
    from msfwsi_tpu.train.checkpoint import torch_msfwsi_to_flax

    v = torch_msfwsi_to_flax({k: w.numpy() for k, w in model.state_dict().items()})
    params = jax.tree.map(jnp.asarray, v["params"])
    tx = JS.make_ssl_optimizer(jconfig)
    return JS.SSLTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]),
        opt_state=tx.init(params), tx=tx, model=jconfig.build_model(),
    )


def _jax_adam_moments(jstate):
    """Adam's first and second moments of a JAX train state, as port state
    dicts (the three optimizer groups' masked trees merged)."""
    import optax

    masked = lambda x: isinstance(x, optax.MaskedNode)  # noqa: E731
    adams = [s.inner_state[0] for s in jstate.opt_state.inner_states.values()]

    def merged(field):
        trees = [getattr(a, field) for a in adams]
        tree = jax.tree.map(lambda *ls: next(x for x in ls if not masked(x)), *trees,
                            is_leaf=masked)
        return jax_msfwsi_to_torch(numpy_tree({"params": tree, "batch_stats": {}}))

    return merged("mu"), merged("nu")


def test_two_fused_steps_match_jax():
    """Two fused steps (views from JAX-drawn parameters, amp off) from the
    same weights. After each: the losses to a relative 1e-4 (or 1e-5
    absolute where a SimSiam loss passes near zero), every BN running stat
    to rtol 1e-3 / atol 1e-5, each tensor's gradient, and each tensor's
    weights. The gradient is read from Adam's first moment, 0.1 g after
    step 1 on both sides, and held per tensor by relative norm.

    The gradient is piecewise smooth, and this batch puts a ReLU of the
    deepest fuser head (BatchNorm over 4 samples, then ReLU) next to its
    kink: the ~2e-6 by which the port's views differ from JAX's switches
    it, which moves that head's gradient by up to 8.4% and, through the
    fuser's input, the encoders' by 1.3-4.6% (49 of 216 tensors; checked
    in fp64, where the port's gradient on JAX's own views matches JAX's to
    1.8e-4). So after step 1 every tensor is held to 0.15 (a wrong
    gradient is off by 0.5 or more) and three quarters of them to 1e-3
    (measured: the other 167 within 2.4e-4). Adam's first step moves each
    weight by lr times its gradient's sign, so every weight is within 2 lr
    of JAX's and each tensor has at most 5% of its weights outside rtol
    1e-3 / atol 1e-5 (measured at most 3.1%: 2 of 64).

    Before step 2 the port's weights, running stats and Adam moments are
    set to JAX's, so step 2 tests a step from equal states (the moments'
    update and bias correction at count 2), not the kink's consequences.
    Step 2 meets no kink: every tensor's moment within 1e-3 (measured
    2.9e-4), each tensor at most 5% of its weights outside rtol 1e-3 / atol
    1e-5 (measured 0.2%), every weight within 2 lr (measured 0.67 lr)."""
    B = 4
    jconfig = JS.SSLConfig(arch="resnet10", scale=2, img_size=32, batch_size=B, amp=False)
    jaug = JP.AugConfig(img_size=32, grid=2, tile_px=32)
    config = S.SSLConfig(arch="resnet10", scale=2, batch_size=B, amp=False)
    tiles = np.random.default_rng(0).integers(0, 256, (B, 64, 64, 3), dtype=np.uint8)
    state = S.create_ssl_state(config, device="cpu")
    jstate = _jax_state_from_port(jconfig, state.model)
    step = S.make_fused_step(config, port_aug_config(jaug), device="cpu")
    jstep = JS.make_jitted_fused_step(jconfig, jaug, donate=False)
    buffers = {n for n, _ in state.model.named_buffers()}
    names = {p: n for n, p in state.model.named_parameters()}
    lr = config.init_lr

    for i in range(2):
        if i:  # step 2 from JAX's state
            state.model.load_state_dict(want)
            for p, moments in state.optimizer.state.items():
                moments["exp_avg"].copy_(mu[names[p]])
                moments["exp_avg_sq"].copy_(nu[names[p]])
        key = jax.random.fold_in(jax.random.key(1), i)
        jstate, jm = jstep(jstate, jnp.asarray(tiles), key)
        m = step(state, t(tiles), view_params=jax_view_params(key, B, (64, 64), jaug))
        for k in jm:
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-4, abs=1e-5), (i, k)

        mu, nu = _jax_adam_moments(jstate)
        rel = {}  # |g_port - g_jax| / |g_jax| per tensor; a zero gradient must match exactly
        for p, moments in state.optimizer.state.items():
            diff, ref = float((moments["exp_avg"] - mu[names[p]]).norm()), float(mu[names[p]].norm())
            rel[names[p]] = diff / ref if ref else (0.0 if diff == 0 else float("inf"))
        assert len(rel) == len(names)
        worst = max(rel, key=rel.get)
        if i == 0:
            assert rel[worst] <= 0.15, (i, worst, rel[worst])
            n_tight = sum(r <= 1e-3 for r in rel.values())
            assert n_tight >= 0.75 * len(rel), (i, n_tight, len(rel))
        else:
            assert rel[worst] <= 1e-3, (i, worst, rel[worst])

        want = jax_msfwsi_to_torch(
            numpy_tree({"params": jstate.params, "batch_stats": jstate.batch_stats})
        )
        got = {k: v.detach() for k, v in state.model.state_dict().items()}
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            close = np.isclose(got[k].numpy(), w.numpy(), rtol=1e-3, atol=1e-5)
            if k in buffers:
                assert close.all(), (i, k, float((got[k] - w).abs().max()))
            else:
                assert (~close).mean() <= 0.05, (i, k, float((~close).mean()))
                assert float((got[k] - w).abs().max()) <= 2 * lr + 1e-6, (i, k)
    assert state.step == 2


def test_config_and_optimizer_groups():
    config = S.SSLConfig(arch="resnet10", scale=2, batch_size=8, ms_lr=(1.0, 0.5, 2.0))
    assert config.init_lr == pytest.approx(1e-3 * (8 / 32) ** 0.5)
    model = S.MSFWSI(arch="resnet10", scale=2)
    opt = S.make_ssl_optimizer(model, config)
    assert [g["lr"] for g in opt.param_groups] == pytest.approx(
        [config.init_lr * m for m in config.ms_lr]
    )
    assert sum(len(g["params"]) for g in opt.param_groups) == len(list(model.parameters()))
    assert all(g["betas"] == (0.9, 0.999) and g["eps"] == 1e-8 and g["weight_decay"] == 0
               for g in opt.param_groups)
    for bad in ({"inter_opt": "adafactor"}, {"accum_steps": 2}, {"use_ac": True}):
        with pytest.raises(ValueError):
            S.SSLConfig(**bad)


def test_entry_points_need_a_gpu_or_an_explicit_cpu(tmp_path):
    """Without a card, the entry points refuse to run unless asked for the
    CPU: there is no silent fallback."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from msfwsi_tpu_torch import ssl_train
    from msfwsi_tpu_torch.data.loader import TileBatchLoader
    from msfwsi_tpu_torch.data.pipeline import AugConfig

    config = S.SSLConfig(arch="resnet10", scale=2, batch_size=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        S.make_fused_step(config, AugConfig())
    with pytest.raises(RuntimeError):
        S.create_ssl_state(config)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TileBatchLoader("", ["a.png"], 1)
    argv = ["--synthetic", "2", "-b", "2", "--epochs", "1", "--steps-per-epoch", "1",
            "-a", "resnet10", "--scale", "2", "--tile-px", "32", "-i", "32",
            "--log-dir", str(tmp_path / "run")]
    with pytest.raises(RuntimeError):
        ssl_train.main(argv)
    out = ssl_train.main(argv + ["--device", "cpu", "--amp"])
    (epoch,) = out["epochs"]
    assert epoch["steps"] == 1 and np.isfinite(epoch["loss"])


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = [
        f"{p.relative_to(REPO)}: {name}"
        for p in files
        for name in _imports(p)
        if name.split(".")[0] in FORBIDDEN
    ]
    assert not bad, bad
    for src in PORT.glob("csrc/*.cu*"):
        assert "#include <torch" not in src.read_text() and "#include <ATen" not in src.read_text()
    assert "torch.compile" not in "".join(p.read_text() for p in files)
    # and with those modules made unimportable, the port still imports
    code = (
        "import sys\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None\n"
        "import msfwsi_tpu_torch, msfwsi_tpu_torch.ssl_train, msfwsi_tpu_torch.train.checkpoint\n"
        "import msfwsi_tpu_torch.ops.cuda.blur, msfwsi_tpu_torch.diag.layout_probe\n"
        "import msfwsi_tpu_torch.data.loader, msfwsi_tpu_torch.data.datasets\n"
        "import msfwsi_tpu_torch.data.packed, msfwsi_tpu_torch.native\n"
        "import msfwsi_tpu_torch.utils, msfwsi_tpu_torch.utils.imagenet, msfwsi_tpu_torch.bench\n"
        "import msfwsi_tpu_torch.diag.datapath, msfwsi_tpu_torch.ssl_finetune\n"
        "import msfwsi_tpu_torch.models.hooknet, msfwsi_tpu_torch.ops.metrics\n"
        "import msfwsi_tpu_torch.train.finetune, msfwsi_tpu_torch.train.evaluate\n"
        "import msfwsi_tpu_torch.train.predict, msfwsi_tpu_torch.train.features\n"
        "import msfwsi_tpu_torch.data.slides, msfwsi_tpu_torch.data.png\n"
        "import msfwsi_tpu_torch.evaluate, msfwsi_tpu_torch.predict\n"
        "import msfwsi_tpu_torch.extract_features, msfwsi_tpu_torch.linear_probe\n"
        "import msfwsi_tpu_torch.dataset_stats, msfwsi_tpu_torch.parity_check\n"
        "import msfwsi_tpu_torch.data.prepare, msfwsi_tpu_torch.bcss_prepare\n"
        "import msfwsi_tpu_torch.make_synthetic_slides, msfwsi_tpu_torch.export_serving\n"
        "import msfwsi_tpu_torch.train.serving\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
