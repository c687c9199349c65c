"""Port parity of the layout probe: each of the 20 cases of
``msfwsi_tpu_torch.diag.layout_probe`` against its original body in
``tools/diag/mosaic_probe*.py``, run through ``pl.pallas_call`` in interpret
mode at the probe's own shapes, bit for bit; the port's inputs against the
probes'; and the entry point and the wrapper's contract on the CPU. The
CUDA kernel itself is held against the plain versions on the card by
``chip_smoke.py``."""

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
                                 "channels", "more_channels", "batch", "noncontig"])
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
    with pytest.raises(ValueError):
        P.gather_op(x, **args)


def test_no_fallback_on_other_devices():
    with pytest.raises(ValueError, match="no kernel"):
        P.gather_op(torch.empty((2, 4, 6, 8), dtype=torch.bfloat16, device="meta"), "copy",
                    (2, 4, 6, 8), P.Gather())


def test_build_knows_every_kernel_source():
    from msfwsi_tpu_torch import _build

    assert {"colorops", "blur", "layout_probe"} <= set(_build.sources())
