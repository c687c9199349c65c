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
import functools
import sys
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import _build, resolve_device
from .timing import bound_ms, host_time_ms, rotating_time_ms, rotation_count

__all__ = ["AxisMap", "Gather", "OPS", "LAUNCHES", "PREPARED", "kernel_map", "prepare",
           "gather_op", "gather_op_ref",
           "probe_inputs", "ProbeCase", "CASES", "run_probes", "main"]

# Kernel launches since the count was last set to 0 (chip_smoke.py reads it
# to prove the probe went through the kernel).
LAUNCHES = 0
# Launches prepared (checked, their ctypes arguments built) so far: one per
# distinct key of prepare().
PREPARED = 0

OPS = {"copy": 0, "max": 1, "negate_odd_w": 2, "keep_positive": 3}
_VEC = 8  # bf16 channels per 16-byte vector of the kernel
# csrc/layout_probe.cu: VPT vectors a thread, at most MAX_THREADS a block
_VPT = 4
_MAX_THREADS = 512


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


def kernel_map(m: AxisMap, n_out: int, n_in: int) -> tuple[int, int, int, int, int]:
    """``m`` as the kernel computes it, ``(off, num, shift, mod, alt)``:
    ``j = off + ((i * num) >> shift)``, less ``mod`` once if ``j >= mod``,
    plus ``(i & 1) * alt``, with no division. That equals :meth:`AxisMap.index`
    where ``off, num >= 0``, ``den`` is a power of two (``1 << shift``) and
    ``off + (n_out - 1) * num // den < 2 * mod``; a ``ValueError`` otherwise."""
    mod = m.mod or n_in
    if m.off < 0 or m.num < 0 or mod < 1 or m.den < 1 or m.den & (m.den - 1):
        raise ValueError(f"map {m}: the kernel takes off, num >= 0, mod >= 1 and den a "
                         "power of two")
    shift = m.den.bit_length() - 1
    top = m.off + (max(n_out - 1, 0) * m.num >> shift)
    if top >= 2 * mod or max(n_out - 1, 0) * m.num >= 2**31:
        raise ValueError(f"map {m}: off + i*num/den reaches {top}, the kernel takes less "
                         f"than 2*mod = {2 * mod}")
    return m.off, m.num, shift, mod, m.alt


class _CMap(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in ("off", "num", "shift", "mod", "alt")]


class _CGather(ctypes.Structure):
    _fields_ = [("h", _CMap), ("w", _CMap)]


class _CLaunch(ctypes.Structure):
    _fields_ = ([(name, ctypes.c_int) for name in
                 ("op", "N", "Hin", "Win", "CinV", "Hout", "Wout", "cv_bits", "threads")]
                + [("a", _CGather), ("b", _CGather)])


def _check_args(shape, dtype, contiguous, op, out_shape, a, b):
    """Raise ``ValueError`` on anything the kernel does not take; the source
    indices ``(h, w)`` of each gather otherwise."""
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}; one of {sorted(OPS)}")
    if (b is None) != (op != "max"):
        raise ValueError("gather b is given for op 'max' and only for it")
    if len(shape) != 4 or len(out_shape) != 4 or out_shape[0] != shape[0]:
        raise ValueError(f"x {shape} and out {out_shape} must be NHWC, same N")
    if dtype != torch.bfloat16:
        raise ValueError(f"x must be bfloat16, got {dtype}")
    if out_shape[3] > shape[3] or shape[3] % _VEC or out_shape[3] % _VEC:
        raise ValueError(f"channels {shape[3]} -> {out_shape[3]}: need multiples of {_VEC}, "
                         "the output's no more than the input's")
    cout_v = out_shape[3] // _VEC
    if cout_v & (cout_v - 1):
        raise ValueError(f"output channels {out_shape[3]}: the kernel takes {_VEC} times a "
                         "power of two")
    if not contiguous:
        raise ValueError("x must be contiguous")
    _, Hin, Win, _ = shape
    maps = []
    for g in (a,) if b is None else (a, b):
        hi, wi = g.h.index(out_shape[1], Hin), g.w.index(out_shape[2], Win)
        if hi.min() < 0 or hi.max() >= Hin or wi.min() < 0 or wi.max() >= Win:
            raise ValueError(f"gather {g} reads outside the input's {Hin}x{Win}")
        kernel_map(g.h, out_shape[1], Hin)
        kernel_map(g.w, out_shape[2], Win)
        maps.append((hi, wi))
    return maps


def _check(x, op, out_shape, a, b):
    return _check_args(tuple(x.shape), x.dtype, x.is_contiguous(), op, tuple(out_shape), a, b)


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


def _ceil(n: int, d: int) -> int:
    return -(-n // d)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("layout_probe").msfwsi_layout_probe
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(_CLaunch), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


class _Launch:
    """A checked launch of the kernel for one key of :func:`prepare`: the
    output's shape and the C entry point's arguments but the pointers and
    the stream (``params``), built once. A block covers one output row (or
    a chunk of a long one) with just enough threads for it at 4 vectors
    each."""

    def __init__(self, shape, op, out_shape, a, b):
        N, Hin, Win, Cin = shape
        _, Hout, Wout, Cout = out_shape
        row_vecs = Wout * Cout // _VEC
        threads = min(_MAX_THREADS, _ceil(_ceil(row_vecs, _VPT), 32) * 32)
        if _ceil(row_vecs, threads * _VPT) > 65535 or N * Hout * row_vecs >= 2**31:
            raise ValueError("the kernel takes fewer than 2^31 vectors, rows of at most "
                             f"65535 * {threads * _VPT}")

        def cgather(g):
            return _CGather(_CMap(*kernel_map(g.h, Hout, Hin)), _CMap(*kernel_map(g.w, Wout, Win)))

        self.out_shape = tuple(out_shape)
        self.params = _CLaunch(OPS[op], N, Hin, Win, Cin // _VEC, Hout, Wout,
                               (Cout // _VEC).bit_length() - 1, threads,
                               cgather(a), cgather(b or a))
        self._params_ref = ctypes.byref(self.params)

    def __call__(self, x):
        global LAUNCHES
        if x.data_ptr() % 16:
            raise ValueError("the kernel takes a 16-byte aligned input")
        device = x.get_device()
        if device != torch.cuda.current_device():
            with torch.cuda.device(device):
                return self(x)
        out = x.new_empty(self.out_shape)
        # the current stream's handle as an int, without building a Stream object
        stream = torch._C._cuda_getCurrentRawStream(device)
        rc = _entry()(x.data_ptr(), out.data_ptr(), self._params_ref, stream)
        if rc != 0:
            raise RuntimeError(f"layout probe kernel launch failed with CUDA error {rc}")
        LAUNCHES += 1
        return out


@functools.lru_cache(maxsize=256)
def prepare(shape, dtype, contiguous, op, out_shape, a, b=None) -> _Launch:
    """The launch for an input of ``shape``, ``dtype`` and contiguity, checked
    (``ValueError`` on what the kernel does not take) and its arguments
    built once per key."""
    global PREPARED
    shape, out_shape = tuple(shape), tuple(out_shape)
    _check_args(shape, dtype, contiguous, op, out_shape, a, b)
    launch = _Launch(shape, op, out_shape, a, b)
    PREPARED += 1
    return launch


def gather_op(x, op: str, out_shape, a: Gather, b: Gather | None = None):
    """``op`` over one or two gathers of the bf16 NHWC ``x`` (see
    ``csrc/layout_probe.cu``): a CPU tensor takes :func:`gather_op_ref`, a
    CUDA tensor the kernel (or an error), through the launch
    :func:`prepare` built for its key."""
    launch = prepare(tuple(x.shape), x.dtype, x.is_contiguous(), op, tuple(out_shape), a, b)
    if x.is_cuda:
        return launch(x)
    if x.device.type != "cpu":
        raise ValueError(f"no kernel for device {x.device}")
    return gather_op_ref(x, op, out_shape, a, b)


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

    def bound_bytes(self, inputs) -> int:
        """The bytes of the bound: the distinct input bytes read and the
        output bytes written."""
        x = self.source(inputs)
        return self.read_bytes(inputs) + int(np.prod(self.out_shape)) * x.element_size()

    def rotation(self, inputs) -> list[dict]:
        """``inputs`` and copies of the case's input, enough for
        :func:`~.timing.rotating_time_ms` to find none of them in the L2 cache."""
        x = inputs[self.inp]
        k = rotation_count(self.bound_bytes(inputs))
        return [inputs] + [{self.inp: x.clone()} for _ in range(k - 1)]


def _roll(v, shift: int, axis: int):
    """``jnp.roll`` (and ``pltpu.roll`` for a shift >= 0) as a concatenation:
    ``out[i] = v[(i - shift) mod n]``."""
    n = v.shape[axis]
    s = shift % n
    return torch.cat((v.narrow(axis, n - s, s), v.narrow(axis, 0, n - s)), axis)


def _select_positive(v, int_dtype):
    def const(c):  # made on v's device: a CPU scalar tensor would cost a blocking copy
        return torch.full((), c, dtype=int_dtype, device=v.device)

    k = torch.where(v > 0, const(3), const(1))
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
    library times (:func:`~.timing.rotating_time_ms` over copies of the
    input, which would fit in the L2 cache: each call pays for its own
    bytes from device memory), the kernel's time per call host included
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
                sets = case.rotation(inputs)
                row["ms"] = rotating_time_ms(case.kernel, sets)
                row["host_ms"] = host_time_ms(lambda: case.kernel(inputs))
                row["plain_ms"] = rotating_time_ms(case.plain, sets)
                row["library_ms"] = rotating_time_ms(case.library, sets)
                row["library_call"] = case.library_call
                row["bound_ms"], row["bound_by"] = bound_ms(case.bound_bytes(inputs))
                del sets
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
