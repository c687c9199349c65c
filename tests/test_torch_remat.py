"""Per-block activation checkpointing (``use_ac``, ``remat_stages``) of the
port's encoders: the loss, every gradient and every BatchNorm running stat
equal to the step without it, the checkpointed blocks' forwards run twice
(once more in the backward) and their running stats updated once, for the
SSL model and for HookNet (resnet10, CPU)."""

import dataclasses

import numpy as np
import pytest
import torch

from msfwsi_tpu_torch.models.resnet import BatchNorm
from msfwsi_tpu_torch.train import finetune as FT
from msfwsi_tpu_torch.train import ssl as S
from torch_parity import ssl_random_views

torch.set_num_threads(2)


def _count_forwards(modules):
    counts = [0] * len(modules)
    for i, m in enumerate(modules):
        m.register_forward_hook(lambda *_, i=i: counts.__setitem__(i, counts[i] + 1))
    return counts


def _grads_and_buffers(model):
    return ({n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None},
            {n: b.clone() for n, b in model.named_buffers()})


def _assert_equal(a, b, rtol):
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=rtol, atol=rtol * 1e-3, msg=k)


@pytest.mark.parametrize("stages,amp", [(None, False), ((1, 2), False), (None, True)],
                         ids=["all", "stages12", "all-amp"])
def test_ssl_remat_matches_no_remat(stages, amp):
    """One forward and backward of the SSL model with and without
    ``use_ac``: the loss, every gradient and every running stat equal (fp32:
    within 1e-6 relative, measured bit for bit; under CPU bf16 autocast
    within 1e-6 too, the recompute replaying the same casts). Each
    checkpointed stage's BatchNorm runs twice a view (the recompute), a
    stage left out once, and the running stats are those of one update per
    view (equal to the step without remat, so a second momentum update
    would fail)."""
    base = S.SSLConfig(arch="resnet10", scale=2, batch_size=4, amp=amp)
    out = []
    for cfg in (base, dataclasses.replace(base, use_ac=True, remat_stages=stages)):
        model = S.create_ssl_state(cfg, device="cpu").model.train()
        enc = model.context_encoder
        counts = _count_forwards([enc.layer1[0].bn1, enc.layer4[0].bn1, enc.bn1])
        batch = {k: torch.from_numpy(v) for k, v in ssl_random_views(4, 2, 32, 3).items()}
        with torch.autocast("cpu", dtype=torch.bfloat16, enabled=amp):
            loss, _ = S.ssl_loss_fn(model, batch, cfg.fuser_weights)
        loss.backward()
        out.append((float(loss.detach()), *_grads_and_buffers(model), counts))
    (l0, g0, b0, c0), (l1, g1, b1, c1) = out
    assert l1 == pytest.approx(l0, rel=1e-6)
    _assert_equal(g1, g0, 1e-6)
    _assert_equal(b1, b0, 1e-6)
    assert c0 == [2, 2, 2]
    assert c1 == ([4, 2, 2] if stages == (1, 2) else [4, 4, 2])


def test_hooknet_remat_matches_no_remat():
    """The fine-tuning loss, gradients and running stats of HookNet with
    ``use_ac`` (both branch encoders checkpointed, every stage) equal those
    without (within 1e-6 relative), its encoders' BatchNorm run twice."""
    out = []
    for use_ac in (False, True):
        cfg = FT.FinetuneConfig(arch="resnet10", class_names=("a", "b", "c"), batch_size=2,
                                amp=False, use_ac=use_ac)
        model = FT.create_finetune_state(cfg, device="cpu").model.train()
        counts = _count_forwards([model.target_branch.encoder.layer2[0].bn2,
                                  model.target_branch.decoder.blocks[0].conv1[1]])
        rng = np.random.default_rng(5)
        batch = {"context": torch.from_numpy(rng.normal(size=(2, 64, 64, 3)).astype(np.float32)),
                 "target": torch.from_numpy(rng.normal(size=(2, 64, 64, 3)).astype(np.float32)),
                 "context_mask": torch.from_numpy(rng.integers(0, 4, (2, 64, 64))),
                 "target_mask": torch.from_numpy(rng.integers(0, 4, (2, 64, 64)))}
        loss, _ = FT.finetune_loss_fn(model, batch, 0.5, 3)
        loss.backward()
        out.append((float(loss.detach()), *_grads_and_buffers(model), counts))
    (l0, g0, b0, c0), (l1, g1, b1, c1) = out
    assert l1 == pytest.approx(l0, rel=1e-6)
    _assert_equal(g1, g0, 1e-6)
    _assert_equal(b1, b0, 1e-6)
    assert c0 == [1, 1] and c1 == [2, 1]


def test_recompute_leaves_running_stats_alone():
    """Eval mode and ``torch.no_grad`` run the blocks unwrapped; the flag
    that freezes the running stats is reset after a backward."""
    cfg = S.SSLConfig(arch="resnet10", scale=2, batch_size=4, amp=False, use_ac=True)
    model = S.create_ssl_state(cfg, device="cpu").model
    counts = _count_forwards([model.context_encoder.layer1[0].bn1])
    x = torch.randn(2, 32, 32, 3)
    with torch.no_grad():
        model.train().encode_context(x)
    model.eval().encode_context(x)
    assert counts == [2]
    assert all(m.update_stats for m in model.modules() if isinstance(m, BatchNorm))
