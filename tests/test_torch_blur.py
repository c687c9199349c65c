"""Port parity: the plain version of the standalone 23-tap blur against the
JAX package's Pallas kernel (interpret mode), the op ``gaussian_blur``
against the JAX op, and the wrapper's contract on the CPU. The CUDA kernel
itself is held against the plain version on the card by ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msfwsi_tpu.ops import augment as JA
from msfwsi_tpu.ops.pallas import blur as JB
from msfwsi_tpu_torch.ops import augment as A
from msfwsi_tpu_torch.ops.cuda import blur as K

torch.set_num_threads(2)


def _taps(batch, seed=0, sigma=(0.5, 2.0)):
    """(batch, 23) normalized Gaussian taps, as ``tests/test_pallas.py``."""
    s = np.random.default_rng(seed).uniform(*sigma, batch)
    t = np.arange(-K.HALF, K.HALF + 1)
    k = np.exp(-0.5 * (t[None, :] / s[:, None]) ** 2)
    return (k / k.sum(1, keepdims=True)).astype(np.float32)


def _image(shape, seed):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


@pytest.mark.parametrize(
    "shape,dtype,atol",
    [((2, 64, 64, 3), "float32", 1e-5), ((1, 128, 96, 3), "float32", 1e-5),
     ((1, 64, 64, 3), "bfloat16", 2e-2)],
    ids=["f32-64", "f32-128x96", "bf16-64"],
)
def test_plain_version_matches_pallas_kernel(shape, dtype, atol):
    img, kern = _image(shape, seed=1), _taps(shape[0])
    want = JB.separable_blur_nhwc(jnp.asarray(img).astype(getattr(jnp, dtype)),
                                  jnp.asarray(kern), interpret=True)
    got = K.separable_blur_nhwc_ref(torch.from_numpy(img).to(getattr(torch, dtype)),
                                    torch.from_numpy(kern))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=atol)


def test_uniform_image_is_invariant():
    img = torch.full((1, 64, 64, 3), 0.5)
    out = K.separable_blur_nhwc_ref(img, torch.from_numpy(_taps(1)))
    np.testing.assert_allclose(out.numpy(), 0.5, atol=1e-5)


def test_masked_taps_equal_the_smaller_kernel():
    """19 taps zero-padded to 23 blur as the 19-tap kernel itself does: the
    kernel's one 23-tap loop serves every drawn size."""
    img = torch.from_numpy(_image((1, 64, 64, 3), seed=2))
    t = np.exp(-0.5 * (np.arange(-9, 10) / 1.5) ** 2)
    k19 = (t / t.sum()).astype(np.float32)[None]
    k23 = np.zeros((1, K.KMAX), np.float32)
    k23[0, 2:21] = k19
    got = K.separable_blur_nhwc_ref(img, torch.from_numpy(k23))
    want = A.apply_gaussian_blur(img, torch.from_numpy(k19))  # 19 shifted FMAs per axis
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


@pytest.mark.parametrize(
    "shape",
    [(4, 1024, 1024, 3), (4, 1024, 1024, 4), (4, 1023, 1024, 3), (4, 1024, 1020, 3),
     (2, 16, 16, 3), (2, 8, 64, 3), (2, 64, 8, 3), (32, 224, 224, 3)],
)
def test_supported_predicate_is_the_jax_one(shape):
    assert K.blur_supported(shape) == JB.blur_supported(shape)


def test_op_matches_the_jax_op():
    """JAX's own taps for a key, fed to the port's blur, give JAX's
    ``gaussian_blur(key, img)`` (its XLA path) in fp32."""
    shape = (6, 32, 48, 3)
    img = _image(shape, seed=3)

    @jax.jit
    def jax_op(key, x):
        return JA._blur_taps(key, shape[0], (19, 23), (0.1, 2.0), 23), JA.gaussian_blur(key, x)

    taps, want = (np.array(a) for a in jax_op(jax.random.key(7), jnp.asarray(img)))
    assert len({int((row > 0).sum()) for row in taps}) > 1  # more than one drawn ksize
    got = K.separable_blur_nhwc(torch.from_numpy(img), torch.from_numpy(taps))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # and the port's op draws the same taps for both of its paths
    x = torch.from_numpy(img)
    by_kernel = A.gaussian_blur(torch.Generator().manual_seed(0), x, use_kernel=True)
    by_fmas = A.gaussian_blur(torch.Generator().manual_seed(0), x)
    np.testing.assert_allclose(by_kernel.numpy(), by_fmas.numpy(), atol=1e-5)


@pytest.mark.parametrize(
    "shape,dtype",
    [((1, 64, 64, 3), "bfloat16"), ((1, 64, 64, 3), "float16"), ((1, 60, 64, 3), "float32"),
     ((1, 64, 64, 4), "float32"), ((1, 8, 8, 3), "float32")],
    ids=["bf16", "fp16", "unaligned", "channels", "small"],
)
def test_op_with_kernel_refuses_what_the_jax_op_refuses(shape, dtype):
    img = _image(shape, seed=4)
    with pytest.raises(ValueError):  # raised while tracing, before any Pallas call
        jax.jit(JA.gaussian_blur, static_argnames="use_pallas")(
            jax.random.key(0), jnp.asarray(img).astype(getattr(jnp, dtype)), use_pallas=True)
    with pytest.raises(ValueError):
        A.gaussian_blur(torch.Generator().manual_seed(0),
                        torch.from_numpy(img).to(getattr(torch, dtype)), use_kernel=True)


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    img, kern = torch.from_numpy(_image((2, 16, 24, 3), seed=5)), torch.from_numpy(_taps(2))
    before = K.LAUNCHES
    out = K.separable_blur_nhwc(img, kern)
    assert K.LAUNCHES == before
    assert torch.equal(out, K.separable_blur_nhwc_ref(img, kern))


@pytest.mark.parametrize("bad", ["channels", "small", "dtype", "taps", "taps_dtype", "noncontig"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    img, kern = torch.zeros((2, 16, 16, 3)), torch.from_numpy(_taps(2))
    if bad == "channels":
        img = torch.zeros((2, 16, 16, 4))
    elif bad == "small":
        img = torch.zeros((2, 11, 16, 3))
    elif bad == "dtype":
        img = img.double()
    elif bad == "taps":
        kern = torch.zeros((2, 17))
    elif bad == "taps_dtype":
        kern = kern.double()
    elif bad == "noncontig":
        img = img.transpose(1, 2)
    with pytest.raises(ValueError):
        K.separable_blur_nhwc(img, kern)


def test_no_fallback_on_other_devices():
    with pytest.raises(ValueError, match="no kernel"):
        K.separable_blur_nhwc(torch.empty((2, 16, 16, 3), device="meta"),
                              torch.empty((2, K.KMAX), device="meta"))


def test_sass_report_reads_cuobjdump_output():
    """The kernel report (``diag/sass_report.py``) that counts the blur
    kernel's instructions parses cuobjdump's listings."""
    from msfwsi_tpu_torch.diag.sass_report import opcode_counts, resource_usage

    sass = """
		Function : _Z3fooPf
	.headerflags	@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                /* 0x00000a00ff017b82 */
                                                                         /* 0x000e220000000800 */
        /*0010*/              @!P0 FFMA R4, R5, R6, R4 ;                 /* 0x0000000605047223 */
        /*0020*/                   FFMA.FTZ R4, R5, R6, R4 ;             /* 0x0000000605047223 */
        /*0030*/               @P1 LDS.128 R8, [R2] ;                    /* 0x0000000002087984 */
		Function : _Z3barv
        /*0000*/                   EXIT ;                                /* 0x000000000000794d */
"""
    counts = opcode_counts(sass)
    assert counts == {"_Z3fooPf": {"LDC": 1, "FFMA": 2, "LDS": 1}, "_Z3barv": {"EXIT": 1}}
    usage = resource_usage(" Function _Z3fooPf:\n  REG:32 STACK:0 SHARED:96 LOCAL:0\n")
    assert usage == {"_Z3fooPf": "REG:32 STACK:0 SHARED:96 LOCAL:0"}
