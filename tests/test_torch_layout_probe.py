"""Port parity of the layout probe: each of the 20 cases of
``msfwsi_tpu_torch.diag.layout_probe`` against its original body in
``tools/diag/mosaic_probe*.py``, run through ``pl.pallas_call`` in interpret
mode at the probe's own shapes, bit for bit; the port's inputs against the
probes'; the kernel's index arithmetic (shifts, one conditional subtract,
no division) and its blocks, threads and vectors, as a numpy model, against
the index maps and the plain versions; and the entry point, the wrapper's
contract and its cached launches on the CPU. The CUDA kernel itself is held
against the plain versions on the card by ``chip_smoke.py``."""

import ast
import contextlib
import io
import runpy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from msfwsi_tpu_torch.diag import layout_probe as P

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def _try_one_calls(path: Path, scope: dict):
    """label -> (kernel name, def line, output shape, input name) of each
    ``try_one(label, kernel, out_shape[, inp])`` call of a probe script."""
    tree = ast.parse(path.read_text())
    lines = {n.name: n.lineno for n in tree.body if isinstance(n, ast.FunctionDef)}
    calls = {}
    nodes = [n for n in ast.walk(tree)
             if isinstance(n, ast.Call) and getattr(n.func, "id", None) == "try_one"]
    for node in sorted(nodes, key=lambda n: n.lineno):
        label, kern, shape = node.args[0].value, node.args[1].id, node.args[2]
        inp = node.args[3].id if len(node.args) > 3 else "x"
        calls[label] = (kern, lines[kern], tuple(eval(ast.unparse(shape), scope)), inp)
    return calls


@pytest.fixture(scope="module")
def probes():
    """Each probe script run once (its own non-interpret calls print FAIL
    on the CPU, which is harmless), with its globals and try_one calls."""
    out = {}
    for probe, suffix in (("P1", ""), ("P2", "2"), ("P3", "3")):
        name = f"mosaic_probe{suffix}"
        path = REPO / "tools" / "diag" / f"{name}.py"
        with contextlib.redirect_stdout(io.StringIO()):
            scope = runpy.run_path(str(path))
        out[probe] = (f"tools/diag/{name}.py", scope, _try_one_calls(path, scope))
    return out


@pytest.fixture(scope="module")
def inputs():
    return P.probe_inputs("cpu")


@pytest.fixture(scope="module")
def pallas_out(probes):
    """label -> each body's output through ``pl.pallas_call(...,
    interpret=True)`` at the probe's own shapes, all in one jit (one
    compile instead of twenty). P2's ``k_roll`` is refused by Pallas at
    trace time (``pltpu.roll`` takes no negative shift), so its entry is
    what the probe meant, ``max(v, jnp.roll(v, -1, 2))``."""
    jobs = [(label, scope[kern], out_shape, scope[inp])
            for _, scope, calls in probes.values()
            for label, (kern, _, out_shape, inp) in calls.items()]

    def bodies(*xs):
        out = {}
        for (label, kern, out_shape, _), x in zip(jobs, xs):
            if kern.__name__ == "k_roll":
                v = x[:, :, 0:128]
                out[label] = jnp.maximum(v, jnp.roll(v, -1, 2))
            else:
                out[label] = _interpret(kern, out_shape, x)
        return out

    return jax.jit(bodies)(*(x for *_, x in jobs))


def _bits(a) -> np.ndarray:
    """bf16 bit patterns of a JAX array or a torch tensor."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def _interpret(kernel, out_shape, x):
    return pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(out_shape, jnp.bfloat16),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM), interpret=True,
    )(x)


def test_the_cases_are_the_probes_bodies(probes):
    """Every try_one of the three scripts is a case, in order, under its
    label letter for letter."""
    want = [(p, label) for p in ("P1", "P2", "P3") for label in probes[p][2]]
    assert [(c.probe, c.label) for c in P.CASES] == want
    assert len(P.CASES) == 20


def test_inputs_are_the_probes_inputs(probes, inputs):
    np.testing.assert_array_equal(_bits(inputs["x"]), _bits(probes["P1"][1]["x"]))
    np.testing.assert_array_equal(_bits(inputs["x"]), _bits(probes["P3"][1]["x"]))
    np.testing.assert_array_equal(_bits(inputs["x2"]), _bits(probes["P2"][1]["x"]))
    np.testing.assert_array_equal(_bits(inputs["dy"]), _bits(probes["P2"][1]["dy"]))


@pytest.mark.parametrize("case", P.CASES, ids=[f"{c.probe}-{c.label}" for c in P.CASES])
def test_case_matches_its_pallas_body(case, probes, inputs, pallas_out):
    path, _, calls = probes[case.probe]
    _, line, out_shape, inp = calls[case.label]
    assert case.where == f"{path}:{line}"
    assert case.out_shape == out_shape
    assert {"x": "x2" if case.probe == "P2" else "x", "dy": "dy"}[inp] == case.inp
    plain = case.plain(inputs)
    np.testing.assert_array_equal(_bits(plain), _bits(pallas_out[case.label]))
    # the kernel's plain version (index maps + op) gives the same bits
    np.testing.assert_array_equal(_bits(case.kernel(inputs)), _bits(plain))
    # and the timed library expression computes the same values
    assert torch.equal(case.library(inputs), plain)


def test_main_on_the_cpu_prints_an_ok_per_case(capsys):
    assert P.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 20 and all(line.startswith("OK   ") for line in lines)
    assert lines[0] == "OK   stride-2 sublane slice  -> (8, 128, 64, 64)"


def test_main_needs_a_gpu_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.main(["--probe", "P3"])


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    x = torch.arange(2 * 4 * 6 * 8, dtype=torch.float32).reshape(2, 4, 6, 8).bfloat16()
    before = P.LAUNCHES
    out = P.gather_op(x, "copy", (2, 4, 6, 8), P.Gather(w=P.AxisMap(off=5, mod=6)))
    assert P.LAUNCHES == before
    assert torch.equal(out, torch.roll(x, 1, 2))


@pytest.mark.parametrize("bad", ["op", "b_for_copy", "no_b_for_max", "range", "dtype",
                                 "channels", "more_channels", "batch", "noncontig",
                                 "channel_vectors", "den", "negative_off", "wraps_twice"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x = torch.zeros((2, 4, 6, 8), dtype=torch.bfloat16)
    args = dict(op="copy", out_shape=(2, 4, 6, 8), a=P.Gather(), b=None)
    if bad == "op":
        args["op"] = "min"
    elif bad == "b_for_copy":
        args["b"] = P.Gather()
    elif bad == "no_b_for_max":
        args["op"] = "max"
    elif bad == "range":
        args["a"] = P.Gather(h=P.AxisMap(off=1, mod=5))
    elif bad == "dtype":
        x = x.float()
    elif bad == "channels":
        x = torch.zeros((2, 4, 6, 12), dtype=torch.bfloat16)
        args["out_shape"] = (2, 4, 6, 12)
    elif bad == "more_channels":
        args["out_shape"] = (2, 4, 6, 16)
    elif bad == "batch":
        args["out_shape"] = (3, 4, 6, 8)
    elif bad == "noncontig":
        x = torch.zeros((2, 6, 4, 8), dtype=torch.bfloat16).transpose(1, 2)
    elif bad == "channel_vectors":  # 3 vectors a pixel: not a power of two
        x = torch.zeros((2, 4, 6, 24), dtype=torch.bfloat16)
        args["out_shape"] = (2, 4, 6, 24)
    elif bad == "den":  # i // 3 needs a division
        args["a"] = P.Gather(w=P.AxisMap(den=3))
    elif bad == "negative_off":  # in range through Python's %, not the kernel's
        args["a"] = P.Gather(w=P.AxisMap(off=-1))
    elif bad == "wraps_twice":  # off + i reaches 2 * mod: one subtract is not enough
        args["a"] = P.Gather(w=P.AxisMap(off=1, mod=3))
    with pytest.raises(ValueError):
        P.gather_op(x, **args)


def test_no_fallback_on_other_devices():
    with pytest.raises(ValueError, match="no kernel"):
        P.gather_op(torch.empty((2, 4, 6, 8), dtype=torch.bfloat16, device="meta"), "copy",
                    (2, 4, 6, 8), P.Gather())


def test_build_knows_every_kernel_source():
    from msfwsi_tpu_torch import _build

    assert {"colorops", "blur", "layout_probe"} <= set(_build.sources())


# --- the kernel's arithmetic, modelled in numpy -------------------------------

def _model_index(kmap, i):
    """``map_index`` of ``csrc/layout_probe.cu`` on int32 positions ``i``:
    a shift for the division, one conditional subtract for the modulo."""
    off, num, shift, mod, alt = (np.int32(v) for v in kmap)
    j = off + ((i * num) >> shift)
    j = np.where(j >= mod, j - mod, j)
    return j + (i & 1) * alt


def _bf16_float(bits):
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _model_op(op, a, b, odd_w):
    """``apply_one`` on bf16 bit patterns (uint16)."""
    if op == P.OPS["copy"]:
        return a
    if op == P.OPS["negate_odd_w"]:
        return np.where(odd_w, a ^ np.uint16(0x8000), a)
    fa = _bf16_float(a)
    if op == P.OPS["keep_positive"]:
        return np.where((fa > 0) | np.isnan(fa), a, a & np.uint16(0x8000))
    fb = _bf16_float(b)
    return np.where(np.isnan(fa), a, np.where(np.isnan(fb), b, np.where(fa >= fb, a, b)))


def _model_launch(launch, x):
    """Every block (row, chunk), thread and vector of one launch of
    ``layout_probe_kernel`` as the kernel computes them, 4 vectors a
    thread, from the prepared launch's own arguments; returns the output and
    how often each output vector was written."""
    p = launch.params
    op, N, Hin, Win, CinV, Hout, Wout, cv_bits = (
        p.op, p.N, p.Hin, p.Win, p.CinV, p.Hout, p.Wout, p.cv_bits)
    threads, vpt = p.threads, 4
    ga, gb = ([(m.off, m.num, m.shift, m.mod, m.alt) for m in (g.h, g.w)] for g in (p.a, p.b))
    xv = x.contiguous().view(torch.int16).numpy().view(np.uint16).reshape(N, Hin, Win, CinV, 8)
    row_vecs = Wout << cv_bits
    chunks = -(-row_vecs // (threads * vpt))
    rows = np.arange(N * Hout, dtype=np.int32)
    n, h = rows // Hout, rows % Hout
    chunk, k, tid = np.meshgrid(np.arange(chunks), np.arange(vpt), np.arange(threads),
                                indexing="ij")
    v = (chunk * threads * vpt + k * threads + tid).ravel().astype(np.int32)
    v = v[v < row_vecs]
    w, cv = v >> cv_bits, v & ((1 << cv_bits) - 1)
    va = xv[n[:, None], _model_index(ga[0], h)[:, None], _model_index(ga[1], w)[None], cv[None]]
    vb = xv[n[:, None], _model_index(gb[0], h)[:, None], _model_index(gb[1], w)[None], cv[None]]
    out = np.zeros((N * Hout, row_vecs, 8), np.uint16)
    writes = np.zeros((N * Hout, row_vecs), np.int64)
    out[:, v] = _model_op(op, va, vb, ((w & 1) == 1)[None, :, None])
    np.add.at(writes, (slice(None), v), 1)
    return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16).view(
        N, Hout, Wout, (1 << cv_bits) * 8), writes


def _key(case, inputs):
    x = case.source(inputs)
    return (tuple(x.shape), x.dtype, True, case.op, case.out_shape, case.a, case.b)


@pytest.mark.parametrize("case", P.CASES, ids=[f"{c.probe}-{c.label}" for c in P.CASES])
def test_kernel_index_arithmetic_matches_the_maps(case, inputs):
    """Every gather of every case: the kernel's form of each map, shifts and
    one conditional subtract, gives the map's indices."""
    x = case.source(inputs)
    for g in (case.a,) if case.b is None else (case.a, case.b):
        for m, n_out, n_in in ((g.h, case.out_shape[1], x.shape[1]),
                               (g.w, case.out_shape[2], x.shape[2])):
            i = np.arange(n_out, dtype=np.int32)
            np.testing.assert_array_equal(_model_index(P.kernel_map(m, n_out, n_in), i),
                                          m.index(n_out, n_in))


@pytest.mark.parametrize("case", P.CASES, ids=[f"{c.probe}-{c.label}" for c in P.CASES])
def test_kernel_model_equals_the_plain_version(case, inputs):
    """The launch as prepared writes each output vector once, with the plain
    version's bits."""
    out, writes = _model_launch(P.prepare(*_key(case, inputs)), case.source(inputs))
    assert (writes == 1).all()
    np.testing.assert_array_equal(_bits(out), _bits(case.plain(inputs)))


@settings(max_examples=300, deadline=None)
@example(off=0, num=1, shift=0, mod=3, alt=0, n_out=6)  # reaches 2 * mod - 1: taken
@example(off=0, num=1, shift=0, mod=3, alt=0, n_out=7)  # reaches 2 * mod: refused
@example(off=5, num=3, shift=2, mod=4, alt=1, n_out=2)  # den 4
@given(off=st.integers(0, 300), num=st.integers(0, 4), shift=st.integers(0, 3),
       mod=st.integers(1, 300), alt=st.integers(0, 64), n_out=st.integers(1, 300))
def test_kernel_index_arithmetic_on_random_maps(off, num, shift, mod, alt, n_out):
    """Any map the wrapper accepts, the kernel's arithmetic computes as the
    map does; any it refuses breaks one of the documented conditions."""
    m = P.AxisMap(off=off, num=num, den=1 << shift, mod=mod, alt=alt)
    top = off + (n_out - 1) * num // (1 << shift)
    try:
        kmap = P.kernel_map(m, n_out, mod)
    except ValueError:
        assert top >= 2 * mod
        return
    assert top < 2 * mod
    i = np.arange(n_out, dtype=np.int32)
    np.testing.assert_array_equal(_model_index(kmap, i), m.index(n_out, mod))


def test_launch_is_prepared_once_per_key_and_repeats_agree(inputs):
    """Repeated calls give the same output, and a key's launch is checked
    and built once: the preparation count rises by one per distinct key."""
    P.prepare.cache_clear()
    before = P.PREPARED
    case = P.CASES[8]  # a max over two gathers
    key = _key(case, inputs)
    outs = [case.kernel(inputs) for _ in range(3)]
    assert all(torch.equal(o, outs[0]) for o in outs)
    launches = [P.prepare(*key) for _ in range(3)]
    assert P.PREPARED == before + 1
    assert all(launch is launches[0] for launch in launches)
    models = [_model_launch(launch, case.source(inputs))[0] for launch in launches]
    assert all(torch.equal(m, outs[0]) for m in models)
    case.kernel(inputs)
    P.CASES[0].kernel(inputs)  # another key
    assert P.PREPARED == before + 2
