"""The port's Adafactor (``msfwsi_tpu_torch/train/factored.py``) against the
JAX package's: the plain update against ``optax.adafactor`` leaf by leaf,
the fused outer-product update against the plain one, the optimizer groups
against the JAX package's labels, and three MSFWSI steps with fp32 heads
against ``make_jitted_train_step`` (resnet10, scale 2, 32 px, b4, amp off,
as ``tests/test_factored.py``). bf16 heads: ``test_torch_inter_bf16.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from msfwsi_tpu.train import factored as JF
from msfwsi_tpu.train import ssl as JS
from msfwsi_tpu_torch.train import factored as F
from msfwsi_tpu_torch.train import ssl as S
from torch_parity import jax_ssl_state_from_port, ssl_random_views, ssl_steps_against_jax

torch.set_num_threads(2)

# square, non-square both ways, second axis under 128 (not factored), 1-D
SHAPES = ((256, 256), (320, 160), (160, 320), (192, 48), (96,))
LR = 1e-3


def _optax_leaves(dtype, steps=3, seed=0):
    """The JAX package's own ``inter`` group (``make_ssl_optimizer`` with
    ``inter_opt="adafactor"``: fp32 cast, then ``optax.adafactor``) over one
    leaf of each shape for ``steps`` steps of seeded gradients in the
    leaves' dtype; returns the inputs and the final leaves."""
    rng = np.random.default_rng(seed)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    init = [rng.uniform(-0.1, 0.1, s).astype(np.float32) for s in SHAPES]
    grads = [[rng.normal(size=s).astype(np.float32) for s in SHAPES] for _ in range(steps)]
    tx = JS.make_ssl_optimizer(JS.SSLConfig(batch_size=32, lr=LR, inter_opt="adafactor"))
    params = {f"inter_{i}": jnp.asarray(a, jdt) for i, a in enumerate(init)}
    opt_state = tx.init(params)
    for g in grads:
        g = {f"inter_{i}": jnp.asarray(a, jdt) for i, a in enumerate(g)}
        updates, opt_state = tx.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
    return init, grads, [np.asarray(params[f"inter_{i}"], np.float32) for i in range(len(SHAPES))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_plain_adafactor_matches_optax(dtype):
    """Three steps on each leaf. fp32: within rtol 1e-6 / atol 1e-8 of
    optax (measured: at most 1.5e-8 apart, the fp32 means' reassociation).
    bf16 (gradients, statistics and weights in bf16): within one bf16 ulp
    of the weight (rtol 2^-7), as a mean's reassociation can move a
    statistic across a bf16 rounding boundary; measured equal."""
    init, grads, want = _optax_leaves(dtype)
    params = [torch.tensor(a).to(dtype) for a in init]
    opt = F.Adafactor(params, lr=LR)
    for g in grads:
        for p, a in zip(params, g):
            p.grad = torch.tensor(a).to(dtype)
        opt.step()
    rtol, atol = (1e-6, 1e-8) if dtype == torch.float32 else (2**-7, 1e-6)
    for shape, p, w in zip(SHAPES, params, want):
        assert p.dtype == dtype
        np.testing.assert_allclose(p.float().numpy(), w, rtol=rtol, atol=atol, err_msg=str(shape))
        state = opt.state[p]
        assert int(state["step"]) == 3
        dims = F.factored_dims(shape)
        assert set(state) == ({"step", "v"} if dims is None else {"step", "v_row", "v_col"})
        assert all(v.dtype == dtype for k, v in state.items() if k != "step")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(256, 256), (320, 160), (160, 320)], ids=str)
def test_fused_equals_plain_on_the_outer_product(shape, dtype, monkeypatch):
    """A torch ``Linear`` weight (d_out, d_in) updated from (X, dY) factors
    over 3 steps equals the plain Adafactor on the flax-oriented
    ``dW = X^T dY`` (the weight's transpose): fp32 within rtol 1e-5 / atol
    1e-7 (the Gram trick's reassociation; measured at most 1.5e-8 apart).
    bf16: each element within 2.5 lr, ``tests/test_factored.py``'s
    per-element bound (measured 0.98 lr: 3-6% of the elements round to a
    neighbouring bf16 value, whose spacing is 0.49 lr at |w| >= 1/16). The
    weight's ``.grad`` stays None; a dense gradient raises. The weight is
    updated in blocks of 96 rows (``BLOCK_ROWS``), and the last step's dY
    carries ``dy_scale`` 1/2 (two accumulated microbatches), the plain
    optimizer's ``dW`` the same 1/2."""
    monkeypatch.setattr(F, "BLOCK_ROWS", 96)
    d_out, d_in = shape
    rng = np.random.default_rng(1)
    w0 = rng.uniform(-0.1, 0.1, (d_out, d_in)).astype(np.float32)
    stash = F.FactorStash()
    w = torch.tensor(w0).to(dtype)
    fused = F.FusedOuterAdafactor([w], lr=LR, stash=stash)
    p = torch.tensor(w0.T.copy()).to(dtype)
    plain = F.Adafactor([p], lr=LR)
    for i in range(3):
        x = torch.tensor(rng.normal(size=(8, d_in)).astype(np.float32)).to(dtype)
        dy = torch.tensor(rng.normal(size=(8, d_out)).astype(np.float32)).to(dtype)
        stash.add(w, x[:5], dy[:5])  # two calls, as the two SimSiam views
        stash.add(w, x[5:], dy[5:])
        scale = 0.5 if i == 2 else 1.0
        stash.dy_scale = scale
        fused.step()
        stash.clear()
        assert len(stash) == 0 and stash.dy_scale == 1.0 and w.grad is None
        p.grad = (x.float().T @ dy.float() * scale).to(dtype)
        plain.step()
    rtol, atol = (1e-5, 1e-7) if dtype == torch.float32 else (0.0, 2.5 * LR)
    np.testing.assert_allclose(w.float().numpy(), p.float().numpy().T, rtol=rtol, atol=atol)
    assert w.dtype == dtype and fused.state[w]["v_row"].shape == (d_in,)
    w.grad = torch.zeros_like(w)
    stash.add(w, x, dy)
    with pytest.raises(RuntimeError, match="dense gradient"):
        fused.step()
    with pytest.raises(RuntimeError, match="no \\(X, dY\\) factors"):
        F.FusedOuterAdafactor([torch.zeros(4, 4)], lr=LR, stash=F.FactorStash()).step()


CONFIG = dict(arch="resnet10", scale=2, batch_size=4, amp=False)


def _jax_config(**kw):
    return JS.SSLConfig(img_size=32, mask_ratio=50, **CONFIG, **kw)


def test_groups_match_the_jax_labels():
    """The fused groups hold what the JAX package labels ``inter_fac``
    (``is_factored_kernel``, by ``fac_path_str``), the plain Adafactor what
    it labels ``inter`` (resnet10/scale-2's ``inter_predictor_0/fc1`` is
    192x48, under 128), Adam the rest."""
    state = S.create_ssl_state(S.SSLConfig(**CONFIG, inter_opt="fused_adafactor"), device="cpu")
    jstate = jax_ssl_state_from_port(_jax_config(inter_opt="fused_adafactor"), state.model)
    labels = jax.tree_util.tree_map_with_path(
        lambda path, v: JS._param_group(path, v, True), jstate.params)
    want = {JF.fac_path_str(p) for p, label in jax.tree_util.tree_leaves_with_path(labels)
            if label == "inter_fac"}
    names = {p: n for n, p in state.model.named_parameters()}
    groups = {k: {names[p] for g in opt.param_groups for p in g["params"]}
              for k, opt in state.optimizer.optimizers.items()}
    assert {F.fac_path_str(n) for n in groups["fused_adafactor"]} == want and len(want) >= 12
    assert "inter_projector.0.0.weight" in groups["fused_adafactor"]  # 192x192
    assert "inter_predictor.3.0.weight" in groups["fused_adafactor"]  # 1536 -> 384
    assert "inter_predictor.0.0.weight" in groups["adafactor"]  # 192 -> 48
    assert "inter_projector.0.1.weight" in groups["adafactor"]  # BatchNorm
    assert "inter_predictor.3.3.bias" in groups["adafactor"]
    assert all(n.startswith(("context_", "target_")) for n in groups["adam"])
    assert sum(map(len, groups.values())) == len(names)
    assert F.fac_path_str("inter_predictor.3.3.weight") == "inter_predictor_3/fc2"


def test_fused_backward_forms_no_dense_head_gradient():
    """After a backward through the tapped model, every factored inter-head
    weight has ``.grad is None`` and its (X, dY) rows (both views: 2B) are in
    the stash; every other parameter has its gradient. A train step empties
    the stash, also when it raises."""
    state = S.create_ssl_state(S.SSLConfig(**CONFIG, inter_opt="fused_adafactor"),
                               device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in ssl_random_views(4, 2, 32, 0).items()}
    fw = (0.1, 0.4, 0.7, 1.0)
    loss, _ = S.ssl_loss_fn(state.model, batch, fw)
    loss.backward()
    tapped = [(n, p) for n, p in state.model.named_parameters() if F.is_factored_kernel(n, p)]
    assert len(tapped) == len(state.stash) >= 12
    for n, p in state.model.named_parameters():
        assert (p.grad is None) == F.is_factored_kernel(n, p), n
    for _, p in tapped:
        x, dy = state.stash.take(p)
        assert x.shape == (8, p.shape[1]) and dy.shape == (8, p.shape[0])

    def second_microbatch_fails(i):
        if i:
            raise RuntimeError("no second microbatch")
        return batch

    with pytest.raises(RuntimeError, match="no second microbatch"):
        S.ssl_train_step(state, None, fw, accum_steps=2, microbatch_fn=second_microbatch_fails)
    assert len(state.stash) == 0


@pytest.mark.parametrize("inter_opt", ["adafactor", "fused_adafactor"])
def test_three_steps_match_jax(inter_opt):
    """Three fp32 train steps of the port and of the JAX package
    (``ssl_steps_against_jax``), each from equal states (weights, running
    stats, optimizer state): each loss within ``tests/test_factored.py``'s
    rtol 1e-3 / atol 1e-5 (measured 3.7e-5 relative) and every parameter
    after each step within its bounds (``jax_suite_distances``; measured:
    the Adafactor groups at most 0.0022 lr apart and none outside tol 5e-5,
    Adam's groups at most 1.49 lr and 1.6% of a tensor, its flips on
    near-zero gradients). Without equal starts the runs drift apart by
    Adam's flips, not by the optimizers' math (at b4 the third loss 3%
    apart).

    At b8, as ``tests/test_accum.py``'s config: at b4 this sequence's third
    batch meets a kink (BatchNorm over 4 samples, then ReLU) of the deepest
    fuser head, where the jitted JAX step's own gradient stands 7.5-8% from
    a float64 one's, while the op-by-op JAX gradient and the port's stand
    within 1.3e-5 and 3e-5 of it (op by op, the JAX steps take minutes)."""
    cfg = S.SSLConfig(**dict(CONFIG, batch_size=8), inter_opt=inter_opt)
    state = S.create_ssl_state(cfg, device="cpu")
    jcfg = JS.SSLConfig(img_size=32, mask_ratio=50, **dict(CONFIG, batch_size=8),
                        inter_opt=inter_opt)
    losses, _, _ = ssl_steps_against_jax(jcfg, state, 3)
    got, want = zip(*losses)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)
    assert state.step == 3
    assert all(int(s["step"]) == 3 for s in state.optimizer.state.values())
