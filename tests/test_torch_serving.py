"""The port's serving export against its eager model and against the JAX
package's StableHLO artifact: a resnet10 HookNet at 64 px, chunk 2, with
weights drawn by the port's init, carried into JAX by the JAX package's
converter (cheaper than tracing JAX's init), their running stats set away
from 0 and 1 there, so that eval mode normalizes by them, and carried back
by ``jax_hooknet_to_torch``.

The port's artifact runs the eager model's own operations, so it equals the
eager argmax exactly, in fp32 and under ``--amp`` (bf16 autocast). Against
the JAX artifact the logits differ by a convolution's summation order
(~1e-6, ``test_torch_hooknet.py``), which can flip an argmax only where
the two largest logits lie that close: the predictions must agree at
every pixel whose two largest JAX logits are more than 1e-4 apart. Both
counts are printed (measured: 2 of the 8192 pixels within 1e-4, 0
differing)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msfwsi_tpu.train import finetune as JFT
from msfwsi_tpu.train import serving as JSV
from msfwsi_tpu.train.checkpoint import torch_hooknet_to_flax
from msfwsi_tpu_torch import export_serving
from msfwsi_tpu_torch.models.hooknet import HookNet, build_hooknet
from msfwsi_tpu_torch.train import checkpoint as C
from msfwsi_tpu_torch.train import serving as SV
from torch_parity import numpy_tree, state_numpy, t

torch.set_num_threads(2)

ARCH, SEG, CHUNK, CLASSES = "resnet10", 64, 2, 6
NEAR_TIE = 1e-4


@pytest.fixture(scope="module")
def jax_model():
    drawn = build_hooknet(torch.Generator().manual_seed(0), arch=ARCH, classes=CLASSES)
    variables = numpy_tree(torch_hooknet_to_flax(state_numpy(drawn)))
    rng = np.random.default_rng(1)
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.normal(0, 0.1, a.shape) if p[-1].key == "mean"
                      else rng.uniform(0.5, 1.5, a.shape)).astype(np.float32),
        variables["batch_stats"])
    model = JFT.FinetuneConfig(arch=ARCH, amp=False, seg_size=SEG).build_model()
    return model, variables


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(2)
    return [rng.normal(size=(CHUNK, SEG, SEG, 3)).astype(np.float32) for _ in range(2)]


@pytest.fixture(scope="module")
def port_model(jax_model):
    model = HookNet(arch=ARCH, classes=CLASSES)
    model.load_state_dict(C.jax_hooknet_to_torch(jax_model[1]))
    return model.eval()


@pytest.fixture(scope="module")
def cli_artifact(port_model, tmp_path_factory):
    """The CLI on a ``best_ft_model.pth.tar`` of the port model (fp32)."""
    tmp = tmp_path_factory.mktemp("serving")
    ckpt = C.save_best_ft_model(str(tmp), port_model, 0, ARCH)
    return export_serving.main(["--checkpoint", ckpt, "--out", str(tmp / "hooknet.pt2"),
                                "-a", ARCH, "--chunk", str(CHUNK), "--seg-size", str(SEG),
                                "--device", "cpu"])


def _eager(model, ctx, tgt, amp):
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16, enabled=amp):
        _, logits = model(t(ctx), t(tgt))
    return logits.float().argmax(dim=-1).to(torch.int32)


def test_artifact_equals_the_eager_model(cli_artifact, port_model, inputs):
    infer = SV.load_serving_artifact(cli_artifact, device="cpu")
    got = infer(t(inputs[0]), t(inputs[1]))
    assert got.dtype == torch.int32 and tuple(got.shape) == (CHUNK, SEG, SEG)
    assert torch.equal(got, _eager(port_model, *inputs, amp=False))
    with pytest.raises(Exception):  # the chunk's shape is fixed
        infer(t(inputs[0][:1]), t(inputs[1][:1]))


def test_artifact_equals_the_jax_artifact_but_at_near_ties(cli_artifact, jax_model, inputs,
                                                           tmp_path):
    model, variables = jax_model
    jv = jax.tree.map(jnp.asarray, variables)
    path = JSV.export_hooknet_serving(model, jv, str(tmp_path / "jax.stablehlo"), chunk=CHUNK,
                                      size=SEG)
    want = np.asarray(JSV.load_serving_artifact(path)(*map(jnp.asarray, inputs)))
    _, logits = jax.jit(lambda v, a, b: model.apply(v, a, b, train=False))(
        jv, *map(jnp.asarray, inputs))
    top2 = np.sort(np.asarray(logits, np.float32), axis=-1)[..., -2:]
    near = (top2[..., 1] - top2[..., 0]) <= NEAR_TIE
    got = SV.load_serving_artifact(cli_artifact, device="cpu")(t(inputs[0]), t(inputs[1]))
    differ = got.numpy() != want
    print(f"serving vs JAX artifact: {int(differ.sum())} of {differ.size} pixels differ, "
          f"{int(near.sum())} near ties (top-two JAX logits within {NEAR_TIE})")
    assert want.dtype == np.int32
    assert not (differ & ~near).any()


def test_amp_artifact_equals_eager_autocast(port_model, inputs, tmp_path):
    path = SV.export_hooknet_serving(port_model, str(tmp_path / "amp.pt2"), chunk=CHUNK,
                                     size=SEG, amp=True)
    got = SV.load_serving_artifact(path, device="cpu")(t(inputs[0]), t(inputs[1]))
    assert torch.equal(got, _eager(port_model, *inputs, amp=True))


def test_an_orbax_directory_raises(tmp_path):
    (tmp_path / "orbax").mkdir()
    with pytest.raises(ValueError, match="export_torch.py --kind hooknet"):
        export_serving.main(["--checkpoint", str(tmp_path / "orbax"), "--out",
                             str(tmp_path / "x.pt2"), "-a", ARCH, "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            export_serving.main(["--checkpoint", "x.pth.tar", "--out", "x.pt2"])
