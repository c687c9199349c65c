"""Port parity of the encoder, the MSFWSI backbone, the BN running stats,
the weight converter and the losses, with weights initialized in JAX and
carried over by ``jax_msfwsi_to_torch`` (fp32; features and outputs at atol
1e-4, since a convolution sums in another order).

In training mode the heads' BatchNorm normalizes each feature over the 4
samples of the batch, which turns the ~1e-6 differences of the pooled
features into up to ~2e-3 at the heads' outputs (measured; the JAX
package's own test against the reference model bounds this mode by 2e-2,
``tests/test_reference_parity.py``); those outputs are held to 5e-3. The
eval-mode outputs, where no batch statistic amplifies anything, are held to
1e-4. BatchNorm's running
stats are held at atol 1e-6 where both sides normalize the same input, and
after a whole forward at 1e-5 in the encoders and 1e-4 in the heads: there
the inputs of a BN already differ by ~1e-6 relative between the two
frameworks, and the biased batch variance (mean of squares minus squared
mean) amplifies that by mean^2/var, most in the heads, whose 4-sample
batches spread little around a large mean (measured up to 5e-6 and 2.3e-5).
The unbiased variance would differ by var/(n-1), >= 1e-3 here, so these
bounds still tell the two apart."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msfwsi_tpu.models.backbone import MSFWSI as JMSFWSI
from msfwsi_tpu.models.resnet import get_encoder as j_get_encoder
from msfwsi_tpu.ops import losses as JL
from msfwsi_tpu.train.checkpoint import flax_msfwsi_to_torch, torch_msfwsi_to_flax, torch_resnet_to_flax
from msfwsi_tpu_torch.models.backbone import MSFWSI, build_msfwsi
from msfwsi_tpu_torch.models.resnet import get_encoder, torch_style_init
from msfwsi_tpu_torch.ops import losses as L
from msfwsi_tpu_torch.train.checkpoint import jax_msfwsi_to_torch
from torch_parity import numpy_tree, t

torch.set_num_threads(2)

B, S, SCALE = 4, 32, 2
K = SCALE**2


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want), atol=atol)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    perm = np.stack([rng.permutation(K) for _ in range(B)])
    return {
        "ctx": rng.normal(size=(2, B, S, S, 3)).astype(np.float32),
        "tgt": rng.normal(size=(2, B * K, S, S, 3)).astype(np.float32),
        "rev": np.argsort(perm, axis=1).astype(np.int32),
    }


@pytest.fixture(scope="module")
def jax_model(batch):
    """MSFWSI variables (resnet10, scale 2; drawn by the port's init and
    carried into JAX by the JAX package's converter, which is cheaper than
    tracing JAX's init) and, in both jigsaw modes, JAX's eval-mode outputs
    and its train-mode outputs and updated BN stats."""
    sd = build_msfwsi(torch.Generator().manual_seed(0), arch="resnet10", scale=SCALE).state_dict()
    variables = torch_msfwsi_to_flax({k: v.numpy() for k, v in sd.items()})
    x1 = (jnp.asarray(batch["ctx"][0]), jnp.asarray(batch["tgt"][0]))
    x2 = (jnp.asarray(batch["ctx"][1]), jnp.asarray(batch["tgt"][1]))
    revs = (jnp.asarray(batch["rev"]), jnp.asarray(batch["rev"]))
    models = {s: JMSFWSI(arch="resnet10", scale=SCALE, views_shuffled=s) for s in (True, False)}

    def apply(v):
        return {
            (s, train): m.apply(v, x1, x2, revs, train=train, mutable=["batch_stats"])
            for s, m in models.items()
            for train in (False, True)
        }

    return numpy_tree(variables), jax.jit(apply)(jax.tree.map(jnp.asarray, variables))


def _port(variables, views_shuffled=True):
    model = build_msfwsi(torch.Generator().manual_seed(0), arch="resnet10", scale=SCALE,
                         views_shuffled=views_shuffled)
    model.load_state_dict(jax_msfwsi_to_torch(variables))
    return model


def test_converter_matches_jax_converter(jax_model):
    variables, _ = jax_model
    ours = jax_msfwsi_to_torch(variables)
    theirs = flax_msfwsi_to_torch(variables, ddp_prefix=False)
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)
    # the port's own modules carry exactly these names
    assert sorted(MSFWSI(arch="resnet10", scale=SCALE).state_dict()) == sorted(ours)


def _cuda_autocast_rsqrt(monkeypatch):
    """Autocast on CUDA runs ``rsqrt`` in fp32 whatever its input (it is on
    the fp32 list there, not on the CPU's); do the same here, so that a
    BatchNorm whose output would follow that fp32 shows on the CPU."""
    real = torch.rsqrt
    monkeypatch.setattr(torch, "rsqrt", lambda x: real(x.float()))


@pytest.mark.parametrize(
    "train,amp", [(False, False), (True, False), (False, True)], ids=["eval", "train", "eval-amp"]
)
def test_encoder_pooled_features_and_running_stats(train, amp, monkeypatch):
    """``amp``: the JAX encoder at dtype bf16 against the port under
    ``torch.autocast`` bf16, which must keep every activation in bf16 (the
    BatchNorm output included), with autocast's CUDA policy for rsqrt.
    Measured equal to the last bit; held to 1e-2, two bf16 ulps at the
    features' size. In eval mode: in training mode a BatchNorm over the 4
    samples of a 1x1 last stage amplifies bf16 rounding to ~8% (JAX bf16
    against JAX fp32 alike)."""
    if amp:
        _cuda_autocast_rsqrt(monkeypatch)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, S, S, 3)).astype(np.float32)
    jdt = jnp.bfloat16 if amp else jnp.float32
    enc = j_get_encoder("resnet10", zero_init_residual=True, dtype=jdt)
    drawn = torch_style_init(get_encoder("resnet10", zero_init_residual=True),
                             torch.Generator().manual_seed(1))
    params, stats = torch_resnet_to_flax({k: w.numpy() for k, w in drawn.state_dict().items()},
                                         include_fc=False)
    v = {"params": params, "batch_stats": stats}
    xj = jnp.asarray(x).astype(jdt)
    want, mutated = jax.jit(
        lambda v: enc.apply(v, xj, train=train, mutable=["batch_stats"])
    )(jax.tree.map(jnp.asarray, v))
    sd = jax_msfwsi_to_torch({"params": {"context_encoder": v["params"]},
                              "batch_stats": {"context_encoder": v["batch_stats"]}})
    port = get_encoder("resnet10", zero_init_residual=True)
    port.load_state_dict({k.split(".", 1)[1]: w for k, w in sd.items()})
    port.train(train)
    with torch.autocast("cpu", dtype=torch.bfloat16, enabled=amp):
        got = port(t(xj.astype(jnp.float32)).to(torch.bfloat16 if amp else torch.float32))
    assert len(got) == 4
    for g, w in zip(got, want):
        assert g.dtype == (torch.bfloat16 if amp else torch.float32)
        _close(g, w.astype(jnp.float32), atol=1e-2 if amp else 1e-4)
    stats = jax_msfwsi_to_torch({"params": {}, "batch_stats": {"context_encoder": mutated["batch_stats"]}})
    buffers = dict(port.named_buffers())
    for k, w in stats.items():
        _close(buffers[k.split(".", 1)[1]], w.numpy(), atol=1e-5)


@pytest.mark.parametrize("views_shuffled", [True, False], ids=["shuffled", "spatial"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_msfwsi_outputs_and_running_stats(jax_model, batch, views_shuffled, train):
    variables, outs = jax_model
    want, mutated = outs[(views_shuffled, train)]
    model = _port(variables, views_shuffled)
    model.train(train)
    rev = t(batch["rev"]).long()
    got = model(
        (t(batch["ctx"][0]), t(batch["tgt"][0])), (t(batch["ctx"][1]), t(batch["tgt"][1])),
        (rev, rev),
    )
    for path in ("context", "target", "fuser"):
        for g4, w4 in zip(got[path], want[path]):
            for g, w in zip(g4, w4):
                _close(g, w, atol=5e-3 if train else 1e-4)
    # p carries gradients, z is detached (stop-gradient)
    p1, _, z1, _ = got["fuser"]
    assert p1[0].requires_grad and not z1[0].requires_grad
    new = jax_msfwsi_to_torch({"params": {}, "batch_stats": numpy_tree(mutated["batch_stats"])})
    buffers = dict(model.named_buffers())
    assert sorted(new) == sorted(buffers)
    for k, w in new.items():
        _close(buffers[k], w.numpy(), atol=1e-5 if "encoder" in k else 1e-4)


@pytest.mark.parametrize("shape", [(8, 6, 5, 16), (8, 16)], ids=["conv", "dense"])
def test_batchnorm_running_stats_match_flax(shape):
    """Two training forwards of one BN on the same inputs: fp32 statistics,
    biased variance, running update 0.9*ra + 0.1*batch, as flax's
    BatchNormNamedStats (encoders) and nn.BatchNorm (heads) compute them."""
    from flax import linen as nn

    from msfwsi_tpu.models.resnet import BatchNormNamedStats
    from msfwsi_tpu_torch.models.resnet import BatchNorm

    rng = np.random.default_rng(3)
    xs = [(rng.normal(size=shape) * 2 + 0.5).astype(np.float32) for _ in range(2)]
    C = shape[-1]
    jbn = BatchNormNamedStats(use_running_average=False) if len(shape) == 4 else nn.BatchNorm(
        use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = jbn.init(jax.random.key(0), jnp.asarray(xs[0]))
    bn = BatchNorm(C).train()
    for x in xs:
        y, mut = jbn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
        v = {"params": v["params"], "batch_stats": mut["batch_stats"]}
        got = bn(t(x).movedim(-1, 1)).movedim(1, -1)
        _close(got, y, atol=1e-5)
        _close(bn.running_mean, v["batch_stats"]["mean"], atol=1e-6)
        _close(bn.running_var, v["batch_stats"]["var"], atol=1e-6)


@pytest.mark.parametrize("shape", [(8, 6, 5, 16), (8, 16)], ids=["conv", "dense"])
def test_batchnorm_under_autocast_matches_flax_bf16(shape, monkeypatch):
    """A training forward of one BN on a bf16 input under autocast: the
    output stays bf16, as at dtype bf16 in JAX, where the encoders'
    BatchNormNamedStats normalizes in bf16 and the heads' nn.BatchNorm in
    fp32 before casting (the port's ``normalize_fp32``), here with
    autocast's CUDA policy for rsqrt. Statistics are
    fp32 from the same bf16 input on both sides (1e-6). Outputs at the JAX
    suite's bf16 bound, 2e-2, plus 1e-2 relative: XLA rounds a fused
    ``(x - mean) * mul + bias`` once and torch after each op, so they part
    by an ulp of the inputs' size (measured up to 0.0156 on inputs of
    magnitude ~8)."""
    from flax import linen as nn

    from msfwsi_tpu.models.resnet import BatchNormNamedStats
    from msfwsi_tpu_torch.models.resnet import BatchNorm

    _cuda_autocast_rsqrt(monkeypatch)
    rng = np.random.default_rng(4)
    x = jnp.asarray((rng.normal(size=shape) * 2 + 0.5).astype(np.float32)).astype(jnp.bfloat16)
    C, conv = shape[-1], len(shape) == 4
    jbn = BatchNormNamedStats(use_running_average=False, dtype=jnp.bfloat16) if conv else (
        nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, dtype=jnp.bfloat16))
    v = jbn.init(jax.random.key(0), x)
    v = {"params": {k: jnp.asarray(rng.normal(size=C).astype(np.float32)) for k in v["params"]},
         "batch_stats": v["batch_stats"]}
    y, mut = jbn.apply(v, x, mutable=["batch_stats"])
    bn = BatchNorm(C, normalize_fp32=not conv).train()
    with torch.no_grad():
        bn.weight.copy_(t(v["params"]["scale"]))
        bn.bias.copy_(t(v["params"]["bias"]))
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = bn(t(x.astype(jnp.float32)).to(torch.bfloat16).movedim(-1, 1)).movedim(1, -1)
    assert got.dtype == torch.bfloat16 and y.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(y.astype(jnp.float32)),
                               rtol=1e-2, atol=2e-2)
    _close(bn.running_mean, mut["batch_stats"]["mean"], atol=1e-6)
    _close(bn.running_var, mut["batch_stats"]["var"], atol=1e-6)


def test_losses_match_jax():
    rng = np.random.default_rng(2)
    shapes = [(6, 8), (6, 16), (6, 32), (6, 64)]
    outputs = {
        path: tuple(tuple(rng.normal(size=s).astype(np.float32) for s in shapes) for _ in range(4))
        for path in ("context", "target", "fuser")
    }
    a, b = outputs["context"][0][0], outputs["context"][1][0]
    _close(L.cosine_similarity(t(a), t(b)), JL.cosine_similarity(a, b), atol=1e-6)
    _close(L.simsiam_loss(*(t(o[0]) for o in outputs["target"])),
           JL.simsiam_loss(*(o[0] for o in outputs["target"])), atol=1e-6)
    fw = (0.1, 0.4, 0.7, 1.0)
    total, per_path = L.msfwsi_loss(
        {p: tuple(tuple(t(x) for x in o) for o in v) for p, v in outputs.items()}, fw
    )
    jtotal, jper = JL.msfwsi_loss(outputs, fw)
    _close(total, jtotal, atol=1e-6)
    for k in jper:
        _close(per_path[k], jper[k], atol=1e-6)
    # torch nn.CosineSimilarity eps clamping on a zero vector
    zero = torch.zeros((1, 4))
    assert float(L.cosine_similarity(zero, zero)[0]) == 0.0
