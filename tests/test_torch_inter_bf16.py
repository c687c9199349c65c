"""bf16 fuser-head storage (``inter_dtype="bfloat16"``) against the JAX
package: three train steps with each Adafactor path and two with Adam, the
weight converter carrying bf16 JAX params, and bf16 heads through a
checkpoint (resnet10, scale 2, 32 px, b8, amp off)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msfwsi_tpu.train import ssl as JS
from msfwsi_tpu_torch.train import checkpoint as C
from msfwsi_tpu_torch.train import ssl as S
from torch_parity import (jax_ssl_state_from_port, numpy_tree, ssl_random_views,
                          ssl_steps_against_jax)

torch.set_num_threads(2)

CONFIG = dict(arch="resnet10", scale=2, batch_size=8, amp=False, inter_dtype="bfloat16")


def _configs(inter_opt):
    return (S.SSLConfig(**CONFIG, inter_opt=inter_opt),
            JS.SSLConfig(img_size=32, mask_ratio=50, **CONFIG, inter_opt=inter_opt))


@pytest.mark.parametrize("inter_opt,steps", [
    pytest.param("adafactor", 3, id="adafactor"),
    pytest.param("fused_adafactor", 3, id="fused_adafactor"),
    pytest.param("adam", 2, id="adam"),
])
def test_steps_match_jax(inter_opt, steps):
    """Train steps with bf16 heads, each from equal states
    (``ssl_steps_against_jax``): each loss within ``tests/test_factored.py``'s
    bf16 rtol 5e-2 / atol 1e-5 and every parameter within its bf16 bounds
    (``jax_suite_distances``: 10 lr, at most 0.5% of a tensor outside tol
    1e-2; measured: the heads at most 1.38 lr apart, an ulp of a bf16
    weight being 0.49 lr at |w| >= 1/16, none outside tol). Adam on bf16
    heads keeps its moments in bf16 on both sides, rounded in another order,
    so it too is held to bf16's bound, not fp32's. The heads stay bf16, their
    BatchNorm fp32."""
    cfg, jcfg = _configs(inter_opt)
    state = S.create_ssl_state(cfg, device="cpu")
    losses, _, _ = ssl_steps_against_jax(jcfg, state, steps)
    got, want = zip(*losses)
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=1e-5)
    heads = dict(state.model.named_parameters())
    assert heads["inter_projector.3.0.weight"].dtype == torch.bfloat16
    assert heads["inter_predictor.3.3.bias"].dtype == torch.bfloat16
    assert heads["inter_projector.3.1.weight"].dtype == torch.float32
    assert heads["context_projector.3.0.weight"].dtype == torch.float32


def test_converter_carries_bf16_jax_params_exactly(tmp_path):
    """A JAX state with bf16 heads (``jax_ssl_state_from_port``, cast as
    JAX's ``param_dtype``) read by ``jax_msfwsi_to_torch``: fp32 tensors
    equal to the bf16 values (bf16 to fp32 is exact), loaded into a bf16-head
    model bit for bit. That model through ``save_checkpoint`` and
    ``restore_checkpoint`` keeps every tensor and its dtype, and the fused
    optimizer's state."""
    cfg, jcfg = _configs("fused_adafactor")
    state = S.create_ssl_state(cfg, device="cpu")
    jstate = jax_ssl_state_from_port(jcfg, state.model)
    jkernel = jstate.params["inter_projector_3"]["fc1"]["kernel"]
    assert jkernel.dtype == jnp.bfloat16
    sd = C.jax_msfwsi_to_torch(numpy_tree({"params": jstate.params,
                                           "batch_stats": jstate.batch_stats}))
    want = torch.from_numpy(np.asarray(jkernel.T, np.float32))
    assert sd["inter_projector.3.0.weight"].dtype == torch.float32
    assert torch.equal(sd["inter_projector.3.0.weight"], want)
    state.model.load_state_dict(sd)
    assert torch.equal(state.model.inter_projector[3][0].weight.float(), want)

    views = {k: torch.from_numpy(v) for k, v in ssl_random_views(8, 2, 32, 0).items()}
    S.ssl_train_step(state, views, cfg.fuser_weights)  # optimizer state to save
    path = C.save_checkpoint(str(tmp_path), state, epoch=0, arch=cfg.arch)
    fresh = S.create_ssl_state(S.SSLConfig(**CONFIG, inter_opt="fused_adafactor", seed=5),
                               device="cpu")
    assert C.restore_checkpoint(path, fresh, "cpu") is True and fresh.step == 1
    a, b = state.model.state_dict(), fresh.model.state_dict()
    assert all(a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)
    assert a["inter_projector.3.0.weight"].dtype == torch.bfloat16
    sa, sb = state.optimizer.state_dict(), fresh.optimizer.state_dict()
    assert sa.keys() == sb.keys() == {"adam", "adafactor", "fused_adafactor"}
    for name in sa:
        for i, st in sa[name]["state"].items():
            got = sb[name]["state"][i]
            assert all(torch.equal(v, got[k]) and v.dtype == got[k].dtype for k, v in st.items())
    with pytest.raises(ValueError, match="another --inter-opt"):
        C.restore_checkpoint(path, S.create_ssl_state(S.SSLConfig(**CONFIG), device="cpu"), "cpu")
