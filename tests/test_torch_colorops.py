"""Port parity: the plain version of ``blur_or_sharpen_fused`` against the
JAX package's Pallas kernel (interpret mode), and the wrapper's contract on
the CPU. The CUDA kernel itself is held against the plain version on the
card by ``chip_smoke.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from msfwsi_tpu.ops.pallas import colorops as JK
from msfwsi_tpu_torch.ops.cuda import colorops as K

torch.set_num_threads(2)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    B = shape[0]
    img = rng.uniform(size=shape).astype(np.float32)
    sigma = rng.uniform(0.5, 2.0, B)
    taps = np.arange(-K.HALF, K.HALF + 1)
    bk = np.exp(-0.5 * (taps[None, :] / sigma[:, None]) ** 2)
    bk = (bk / bk.sum(1, keepdims=True)).astype(np.float32)
    a = rng.uniform(0.2, 0.5, B)
    li = rng.uniform(0.5, 1.0, B)
    sk = np.full((B, 3, 3), 0.0) - a[:, None, None]
    sk[:, 1, 1] = (1 - a) + a * (8 + li)
    sel = (np.arange(B) % 3).astype(np.int32)  # all three ops in one batch
    return img, bk, sk.astype(np.float32), sel


@pytest.mark.parametrize("shape", [(6, 64, 64, 3), (3, 32, 48, 3)])
@pytest.mark.parametrize(
    "dtype,atol", [("float32", 1e-5), ("bfloat16", 2e-2)], ids=["f32", "bf16"]
)
def test_plain_version_matches_pallas_kernel(shape, dtype, atol):
    img, bk, sk, sel = _inputs(shape, seed=1)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = JK.blur_or_sharpen_fused(
        jnp.asarray(img).astype(jdt), jnp.asarray(bk), jnp.asarray(sk), jnp.asarray(sel),
        interpret=True,
    )
    x = torch.from_numpy(img).to(getattr(torch, dtype))
    got = K.blur_or_sharpen_fused(x, torch.from_numpy(bk), torch.from_numpy(sk),
                                  torch.from_numpy(sel))
    assert got.dtype == x.dtype and got.shape == x.shape
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)), atol=atol
    )


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    img, bk, sk, sel = _inputs((3, 16, 16, 3), seed=2)
    args = [torch.from_numpy(a) for a in (img, bk, sk, sel)]
    before = K.LAUNCHES
    out = K.blur_or_sharpen_fused(*args)
    assert K.LAUNCHES == before
    torch.testing.assert_close(out, K.blur_or_sharpen_fused_ref(*args), rtol=0, atol=0)
    # passthrough (sel 0) is exact
    torch.testing.assert_close(out[0], args[0][0], rtol=0, atol=0)


@pytest.mark.parametrize(
    "bad",
    ["channels", "small", "dtype", "taps", "sel_dtype", "noncontig"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    img, bk, sk, sel = (torch.from_numpy(a) for a in _inputs((2, 16, 16, 3), seed=3))
    if bad == "channels":
        img = torch.zeros((2, 16, 16, 4))
    elif bad == "small":
        img = torch.zeros((2, 8, 16, 3))
    elif bad == "dtype":
        img = img.double()
    elif bad == "taps":
        bk = torch.zeros((2, 23))
    elif bad == "sel_dtype":
        sel = sel.long()
    elif bad == "noncontig":
        img = img.transpose(1, 2)
    with pytest.raises(ValueError):
        K.blur_or_sharpen_fused(img, bk, sk, sel)


def test_no_fallback_on_other_devices():
    """A tensor on neither the CPU nor a CUDA card raises: the wrapper never
    moves work to the plain version behind the caller's back."""
    img = torch.empty((2, 16, 16, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        K.blur_or_sharpen_fused(img, torch.empty((2, 17), device="meta"),
                                torch.empty((2, 3, 3), device="meta"),
                                torch.empty((2,), dtype=torch.int32, device="meta"))


def test_build_is_deferred_and_sources_have_no_torch_headers():
    from msfwsi_tpu_torch import _build

    srcs = _build.sources()
    assert "colorops" in srcs
    assert not _build._loaded  # importing built nothing
    for p in list(srcs.values()) + list(_build.CSRC_DIR.glob("*.cuh")):
        text = p.read_text()
        assert "torch/" not in text and "ATen" not in text and "c10/" not in text, p
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    """A compile error surfaces as RuntimeError carrying nvcc's output, and
    leaves no library behind to be loaded later."""
    from msfwsi_tpu_torch import _build

    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'colorops.cu(1): error: expected a ;'\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    with pytest.raises(RuntimeError, match="expected a ;"):
        _build.build_all()
    assert not list((tmp_path / "build").iterdir())


def test_ssl_step_shapes_take_the_vector_rows():
    """The SSL step's bf16 images (224 and 1024 px, aligned as PyTorch
    allocates) take the 16-byte rows."""
    for shape in [(32, 224, 224, 3), (32, 1024, 1024, 3)]:
        assert K.launch_plan(shape, 2, 1 << 20, 2 << 20) == 1


@pytest.mark.parametrize(
    "W,itemsize,ptrs,want",
    [(1024, 2, (0, 256), True), (224, 4, (16, 32), True), (23, 2, (0, 0), False),
     (29, 4, (0, 0), False), (24, 2, (0, 0), True), (72, 2, (2, 0), False),
     (72, 4, (0, 8), False)],
)
def test_vector_rows_needs_aligned_rows_and_pointers(W, itemsize, ptrs, want):
    from msfwsi_tpu_torch.ops.cuda import stencil

    assert stencil.vector_rows(W, itemsize, *ptrs) is want
    assert K.launch_plan((2, 16, W, 3), itemsize, *ptrs) == int(want)

