"""Layout probe: the 20 bodies of the TPU's Mosaic layout probes as CUDA kernels.

Port of ``tools/diag/mosaic_probe.py`` (P1), ``mosaic_probe2.py`` (P2) and
``mosaic_probe3.py`` (P3). Each of those builds small Pallas kernels over a
bf16 array, strided slices, offset windows, reshapes, tiles, repeats,
rolls, neighbour max and selects, and prints ``OK`` or ``FAIL`` per body.
Here each body is a :class:`ProbeCase`: a plain PyTorch version written as
the body reads, and one launch of the kernel of ``csrc/layout_probe.cu``
(:func:`gather_op`), which must equal it bit for bit.

    python -m msfwsi_tpu_torch.diag.layout_probe [--device cuda|cpu] [--probe P1|P2|P3]

prints ``OK   <label>  -> <shape>`` or ``FAIL <label>: <reason>`` per case
and exits non-zero if any case fails. On the CPU, :func:`gather_op` runs
its plain version (:func:`gather_op_ref`), so the run holds the index maps
against the bodies.

Two bodies are read as the Pallas interpreter runs them: ``pltpu.repeat``
tiles (it concatenates copies, as ``jnp.tile``), and P2's
``pltpu.roll(v, -1, 2)``, which Pallas refuses for its negative shift, is
ported as what it means, a roll by -1.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import sys
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import _build, resolve_device
from .timing import bound_ms, cuda_time_ms, host_time_ms

__all__ = ["AxisMap", "Gather", "OPS", "LAUNCHES", "gather_op", "gather_op_ref",
           "probe_inputs", "ProbeCase", "CASES", "run_probes", "main"]

# Kernel launches since the count was last set to 0 (chip_smoke.py reads it
# to prove the probe went through the kernel).
LAUNCHES = 0

OPS = {"copy": 0, "max": 1, "negate_odd_w": 2, "keep_positive": 3}
_VEC = 8  # bf16 channels per 16-byte vector of the kernel


class AxisMap(NamedTuple):
    """Source index of output position ``i`` along one axis:
    ``(off + i * num // den) % mod + (i % 2) * alt``; ``mod`` None means the
    input's length."""

    off: int = 0
    num: int = 1
    den: int = 1
    mod: int | None = None
    alt: int = 0

    def index(self, n_out: int, n_in: int) -> np.ndarray:
        i = np.arange(n_out)
        return (self.off + i * self.num // self.den) % (self.mod or n_in) + (i % 2) * self.alt


class Gather(NamedTuple):
    """``out[n, h, w, c] = x[n, h_map(h), w_map(w), c]``."""

    h: AxisMap = AxisMap()
    w: AxisMap = AxisMap()


class _CMap(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in ("off", "num", "den", "mod", "alt")]


class _CGather(ctypes.Structure):
    _fields_ = [("h", _CMap), ("w", _CMap)]


def _indices(x, out_shape, g: Gather):
    _, Hin, Win, _ = x.shape
    hi, wi = g.h.index(out_shape[1], Hin), g.w.index(out_shape[2], Win)
    if hi.min() < 0 or hi.max() >= Hin or wi.min() < 0 or wi.max() >= Win:
        raise ValueError(f"gather {g} reads outside the input's {Hin}x{Win}")
    return hi, wi


def _check(x, op, out_shape, a, b):
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}; one of {sorted(OPS)}")
    if (b is None) != (op != "max"):
        raise ValueError("gather b is given for op 'max' and only for it")
    if x.dim() != 4 or len(out_shape) != 4 or out_shape[0] != x.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} and out {tuple(out_shape)} must be NHWC, same N")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"x must be bfloat16, got {x.dtype}")
    if out_shape[3] > x.shape[3] or x.shape[3] % _VEC or out_shape[3] % _VEC:
        raise ValueError(f"channels {x.shape[3]} -> {out_shape[3]}: need multiples of {_VEC}, "
                         "the output's no more than the input's")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    return [_indices(x, out_shape, g) for g in ((a,) if b is None else (a, b))]


def gather_op_ref(x, op: str, out_shape, a: Gather, b: Gather | None = None):
    """Plain PyTorch version of :func:`gather_op`."""
    gathered = []
    for hi, wi in _check(x, op, out_shape, a, b):
        g = x.index_select(1, torch.from_numpy(hi).to(x.device))
        g = g.index_select(2, torch.from_numpy(wi).to(x.device))
        gathered.append(g[..., : out_shape[3]].contiguous())
    va = gathered[0]
    if op == "copy":
        return va
    if op == "max":
        return torch.maximum(va, gathered[1])
    if op == "negate_odd_w":
        odd = (torch.arange(out_shape[2], device=x.device) % 2 == 1)[None, None, :, None]
        return torch.where(odd, -va, va)
    return (va > 0).to(va.dtype) * va  # keep_positive


def gather_op(x, op: str, out_shape, a: Gather, b: Gather | None = None):
    """``op`` over one or two gathers of the bf16 NHWC ``x`` (see
    ``csrc/layout_probe.cu``): a CPU tensor takes :func:`gather_op_ref`, a
    CUDA tensor the kernel (or an error)."""
    global LAUNCHES
    if x.device.type == "cpu":
        return gather_op_ref(x, op, out_shape, a, b)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check(x, op, out_shape, a, b)
    out_shape = tuple(out_shape)
    if int(np.prod(out_shape)) // _VEC >= 2**31 or x.data_ptr() % 16:
        raise ValueError("the kernel takes fewer than 2^31 vectors, 16-byte aligned")
    lib = _build.load("layout_probe")
    fn = lib.msfwsi_layout_probe
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 8
                   + [ctypes.POINTER(_CGather)] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def cgather(g):
        return _CGather(*(_CMap(m.off, m.num, m.den, m.mod or n, m.alt)
                          for m, n in ((g.h, x.shape[1]), (g.w, x.shape[2]))))

    ca, cb = cgather(a), cgather(b or a)
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), out.data_ptr(), OPS[op], *x.shape, *out_shape[1:],
                ctypes.byref(ca), ctypes.byref(cb), stream)
    if rc != 0:
        raise RuntimeError(f"layout probe kernel launch failed with CUDA error {rc}")
    LAUNCHES += 1
    return out


def probe_inputs(device="cpu") -> dict[str, torch.Tensor]:
    """The probes' inputs, from numpy with their seeds, cast to bf16: ``x``
    of P1 and P3, ``x2`` and ``dy`` of P2."""
    def normal(seed, shape):
        a = np.random.default_rng(seed).normal(size=shape)
        return torch.from_numpy(a).to(torch.bfloat16).to(device)

    return {"x": normal(0, (8, 128, 128, 64)), "x2": normal(0, (8, 128, 130, 64)),
            "dy": normal(1, (8, 64, 64, 64))}


@dataclasses.dataclass(frozen=True)
class ProbeCase:
    """One probe body: ``plain`` computes it as the body reads, the kernel
    computes ``op`` over gathers ``a`` (and ``b``) of input ``inp``, viewed
    as ``view`` when given. ``library`` is one PyTorch expression of the
    same function (``library_call`` names its calls), timed and held to
    the kernel as a second reference."""

    probe: str
    label: str
    where: str
    inp: str
    out_shape: tuple
    plain: Callable
    op: str
    a: Gather
    library: Callable
    library_call: str
    b: Gather | None = None
    view: tuple | None = None

    def source(self, inputs):
        x = inputs[self.inp]
        return x.view(self.view) if self.view else x

    def kernel(self, inputs):
        return gather_op(self.source(inputs), self.op, self.out_shape, self.a, self.b)

    def read_bytes(self, inputs) -> int:
        """Bytes of the distinct input elements the case reads."""
        x = self.source(inputs)
        _, Hin, Win, _ = x.shape
        cells = np.unique(np.concatenate([
            (hi[:, None] * Win + wi[None, :]).ravel()
            for hi, wi in _check(x, self.op, self.out_shape, self.a, self.b)
        ]))
        return cells.size * x.shape[0] * self.out_shape[3] * x.element_size()


def _roll(v, shift: int, axis: int):
    """``jnp.roll`` (and ``pltpu.roll`` for a shift >= 0) as a concatenation:
    ``out[i] = v[(i - shift) mod n]``."""
    n = v.shape[axis]
    s = shift % n
    return torch.cat((v.narrow(axis, n - s, s), v.narrow(axis, 0, n - s)), axis)


def _select_positive(v, int_dtype):
    k = torch.where(v > 0, torch.tensor(3, dtype=int_dtype), torch.tensor(1, dtype=int_dtype))
    return (k == 3).to(torch.bfloat16) * v


def _strided_store(x):
    o = torch.empty_like(x)
    o[:, :, 0:127:2] = x[:, :, 0:64]
    o[:, :, 1:128:2] = x[:, :, 64:128]
    return o


def _parity_select(v):
    w = torch.arange(v.shape[2], device=v.device)[None, None, :, None]
    return torch.where((w % 2) == 0, v, -v)


def _parity_sign(n, device):
    return (1 - 2 * (torch.arange(n, device=device) % 2)).to(torch.bfloat16)[:, None]


def _tile2(v, axis):
    return torch.cat((v, v), axis)


_SAME = (8, 128, 128, 64)
_P1, _P2, _P3 = (f"tools/diag/mosaic_probe{n}.py" for n in ("", "2", "3"))

CASES: list[ProbeCase] = [
    # P1: mosaic_probe.py
    ProbeCase("P1", "stride-2 sublane slice", f"{_P1}:25", "x", (8, 128, 64, 64),
              lambda I: I["x"][:, :, 0:127:2, :].clone(), "copy", Gather(w=AxisMap(num=2)),
              lambda I: I["x"][:, :, 0:127:2].contiguous(), "Tensor.contiguous"),
    ProbeCase("P1", "stride-2 outer (H) slice", f"{_P1}:29", "x", (8, 64, 128, 64),
              lambda I: I["x"][:, 0:127:2, :, :].clone(), "copy", Gather(h=AxisMap(num=2)),
              lambda I: I["x"][:, 0:127:2].contiguous(), "Tensor.contiguous"),
    ProbeCase("P1", "lane slice [0:32] of 64", f"{_P1}:33", "x", (8, 128, 128, 32),
              lambda I: I["x"][..., 0:32].clone(), "copy", Gather(),
              lambda I: I["x"][..., 0:32].contiguous(), "Tensor.contiguous"),
    ProbeCase("P1", "in-kernel reshape (W,C)->(W/2,2C)", f"{_P1}:38", "x", (8, 128, 64, 128),
              lambda I: I["x"].reshape(8, 128, 64, 128).clone(), "copy", Gather(),
              lambda I: I["x"].reshape(8, 128, 64, 128).clone(), "Tensor.clone",
              view=(8, 128, 64, 128)),
    ProbeCase("P1", "in-kernel reshape H->(H/2,2) + pick", f"{_P1}:43", "x", (8, 64, 128, 64),
              lambda I: I["x"].reshape(8, 64, 2, 128, 64)[:, :, 0].clone(), "copy",
              Gather(h=AxisMap(num=2)),
              lambda I: I["x"][:, 0::2].contiguous(), "Tensor.contiguous"),
    ProbeCase("P1", "pltpu.repeat axis=2(sublane)", f"{_P1}:48", "x", _SAME,
              lambda I: _tile2(I["x"][:, :, 0:64, :], 2), "copy", Gather(w=AxisMap(mod=64)),
              lambda I: I["x"][:, :, 0:64].repeat(1, 1, 2, 1), "Tensor.repeat"),
    ProbeCase("P1", "jnp.repeat axis=2(sublane)", f"{_P1}:53", "x", _SAME,
              lambda I: torch.repeat_interleave(I["x"][:, :, 0:64, :], 2, dim=2), "copy",
              Gather(w=AxisMap(den=2)),
              lambda I: I["x"][:, :, 0:64].repeat_interleave(2, dim=2),
              "torch.repeat_interleave"),
    ProbeCase("P1", "strided sublane STORE", f"{_P1}:58", "x", _SAME,
              lambda I: _strided_store(I["x"]), "copy", Gather(w=AxisMap(den=2, alt=64)),
              lambda I: torch.stack((I["x"][:, :, :64], I["x"][:, :, 64:]), 3).view(_SAME),
              "torch.stack"),
    # P2: mosaic_probe2.py
    ProbeCase("P2", "unit-offset sublane slices max", f"{_P2}:25", "x2", _SAME,
              lambda I: torch.maximum(I["x2"][:, :, 0:128, :], I["x2"][:, :, 1:129, :]), "max",
              Gather(), lambda I: torch.maximum(I["x2"][:, :, 0:128], I["x2"][:, :, 1:129]),
              "torch.maximum", b=Gather(w=AxisMap(off=1))),
    ProbeCase("P2", "offset-2 sublane slice max", f"{_P2}:29", "x2", _SAME,
              lambda I: torch.maximum(I["x2"][:, :, 0:128, :], I["x2"][:, :, 2:130, :]), "max",
              Gather(), lambda I: torch.maximum(I["x2"][:, :, 0:128], I["x2"][:, :, 2:130]),
              "torch.maximum", b=Gather(w=AxisMap(off=2))),
    ProbeCase("P2", "pltpu.roll axis=2", f"{_P2}:33", "x2", _SAME,
              lambda I: torch.maximum(I["x2"][:, :, 0:128], _roll(I["x2"][:, :, 0:128], -1, 2)),
              "max", Gather(),
              lambda I: torch.maximum(I["x2"][:, :, 0:128], I["x2"][:, :, 0:128].roll(-1, 2)),
              "torch.roll + torch.maximum", b=Gather(w=AxisMap(off=1, mod=128))),
    ProbeCase("P2", "parity iota select on sublane dim", f"{_P2}:38", "x2", _SAME,
              lambda I: _parity_select(I["x2"][:, :, 0:128, :]), "negate_odd_w", Gather(),
              lambda I: I["x2"][:, :, 0:128] * _parity_sign(128, I["x2"].device),
              "torch.mul by a +-1 column"),
    ProbeCase("P2", "unit H (outer) shifts max", f"{_P2}:44", "x2", (8, 127, 128, 64),
              lambda I: torch.maximum(I["x2"][:, 0:127, 0:128, :], I["x2"][:, 1:128, 0:128, :]),
              "max", Gather(),
              lambda I: torch.maximum(I["x2"][:, 0:127, 0:128], I["x2"][:, 1:128, 0:128]),
              "torch.maximum", b=Gather(h=AxisMap(off=1))),
    ProbeCase("P2", "repeat H and W (outer+sublane)", f"{_P2}:49", "dy", _SAME,
              lambda I: _tile2(_tile2(I["dy"], 1), 2), "copy",
              Gather(h=AxisMap(mod=64), w=AxisMap(mod=64)),
              lambda I: I["dy"].repeat(1, 2, 2, 1), "Tensor.repeat"),
    ProbeCase("P2", "int8 compare/select", f"{_P2}:54", "x2", (8, 128, 130, 64),
              lambda I: _select_positive(I["x2"], torch.int8), "keep_positive", Gather(),
              lambda I: torch.relu(I["x2"]), "torch.relu"),
    # P3: mosaic_probe3.py
    ProbeCase("P3", "pltpu.roll +1 axis=2 (sublane)", f"{_P3}:27", "x", _SAME,
              lambda I: torch.maximum(I["x"], _roll(I["x"], 1, 2)), "max", Gather(),
              lambda I: torch.maximum(I["x"], I["x"].roll(1, 2)), "torch.roll + torch.maximum",
              b=Gather(w=AxisMap(off=127, mod=128))),
    ProbeCase("P3", "pltpu.roll +127 axis=2 (== -1)", f"{_P3}:32", "x", _SAME,
              lambda I: torch.maximum(I["x"], _roll(I["x"], 127, 2)), "max", Gather(),
              lambda I: torch.maximum(I["x"], I["x"].roll(127, 2)), "torch.roll + torch.maximum",
              b=Gather(w=AxisMap(off=1, mod=128))),
    ProbeCase("P3", "pltpu.roll +1 axis=1 (outer)", f"{_P3}:37", "x", _SAME,
              lambda I: torch.maximum(I["x"], _roll(I["x"], 1, 1)), "max", Gather(),
              lambda I: torch.maximum(I["x"], I["x"].roll(1, 1)), "torch.roll + torch.maximum",
              b=Gather(h=AxisMap(off=127, mod=128))),
    ProbeCase("P3", "int32 compare/select", f"{_P3}:42", "x", _SAME,
              lambda I: _select_positive(I["x"], torch.int32), "keep_positive", Gather(),
              lambda I: torch.relu(I["x"]), "torch.relu"),
    ProbeCase("P3", "roll semantics kernel", f"{_P3}:49", "x", _SAME,
              lambda I: _roll(I["x"], 1, 2), "copy", Gather(w=AxisMap(off=127, mod=128)),
              lambda I: I["x"].roll(1, 2), "torch.roll"),
]


def _max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def run_probes(device="cuda", probes=("P1", "P2", "P3"), timed: bool = False) -> list[dict]:
    """Run each case of ``probes`` once through the kernel (on ``device``)
    and once through its plain version and its library expression; one row
    per case with the largest |kernel - reference| and whether the kernel
    equals both. With ``timed`` (on a card) the row adds kernel, plain and
    library times (CUDA events, median of 20, L2 cache cold: the arrays
    would fit in it), the kernel's time per call host included
    (``host_ms``) and the bound: the distinct input bytes read and the
    output bytes written, at the HBM rate."""
    dev = resolve_device(device)
    inputs = probe_inputs(dev)
    rows = []
    for case in CASES:
        if case.probe not in probes:
            continue
        row = {"probe": case.probe, "case": case.label, "where": case.where,
               "shape": list(case.out_shape)}
        try:
            got = case.kernel(inputs)
            refs = [case.plain(inputs), case.library(inputs)]
            row["exact"] = all(got.shape == r.shape and torch.equal(got, r) for r in refs)
            row["max_abs_err"] = 0.0 if row["exact"] else max(_max_abs(got, r) for r in refs)
            if timed:
                nbytes = case.read_bytes(inputs) + got.numel() * got.element_size()
                row["ms"] = cuda_time_ms(lambda: case.kernel(inputs), cold_l2=True)
                row["host_ms"] = host_time_ms(lambda: case.kernel(inputs))
                row["plain_ms"] = cuda_time_ms(lambda: case.plain(inputs), cold_l2=True)
                row["library_ms"] = cuda_time_ms(lambda: case.library(inputs), cold_l2=True)
                row["library_call"] = case.library_call
                row["bound_ms"], row["bound_by"] = bound_ms(nbytes)
        except Exception as e:  # a probe reports each case, as the originals do
            row["exact"] = False
            row["error"] = f"{type(e).__name__}: {str(e).splitlines()[0][:150]}"
        rows.append(row)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--probe", choices=("P1", "P2", "P3"), action="append",
                   help="run only this probe's cases (repeatable; default all)")
    args = p.parse_args(argv)
    rows = run_probes(args.device, tuple(args.probe or ("P1", "P2", "P3")))
    for row in rows:
        if row["exact"]:
            print(f"OK   {row['case']}  -> {tuple(row['shape'])}")
        else:
            reason = row.get("error") or f"max |kernel - reference| {row['max_abs_err']}"
            print(f"FAIL {row['case']}: {reason}")
    return 0 if all(r["exact"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
