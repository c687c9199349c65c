"""Time the kernels' plans, and an earlier version of the port's, on one card.

    python -m msfwsi_tpu_torch.diag.kernel_compare [--old DIR]

For K1 (``blur_or_sharpen_fused``) at (32,224,224,3) and (32,1024,1024,3)
in bf16 and fp32 (selectors ``arange % 3``, and at 1024 px bf16 also the
SSL step's mix: 16 passthrough, 8 blur, 8 sharpen) and K2
(``separable_blur_nhwc``) at (32,1024,1024,3) fp32 and bf16 and
(32,224,224,3) fp32 (all three drawn kernel sizes), each kernel is held
against its plain version and timed (``diag/timing.py``, the device's
time) with the plan its ``launch_plan`` gives, with the element-wise path
in place of the 16-byte rows, and (K2) with strips of 1, 3, 6 and 11
chunks. K1 is timed warm, as the SSL step finds its tiles; K2 under both
yardsticks of ``diag/timing.py``: L2 flushed (``flush_ms``) and buffers
rotated (``rotating_ms``).

For the layout probe (P1-P3), each of its 20 cases is held against its
plain version bit for bit and timed under both yardsticks, the kernel and
its library expression, beside the bound; then a control: a plain
device-to-device copy (``Tensor.copy_``) of the probes' (8,128,128,64)
bf16 input, timed warm, under both yardsticks, and with twice the rotated
buffers, to show how close each yardstick lets the card come to the bytes'
bound and that the rotation has reached its steady state.

With ``--old DIR``, DIR holds an earlier copy of this package, e.g. made by
``git archive COMMIT msfwsi_tpu_torch | tar -x -C DIR``. It is imported
under another name, builds its own kernels into its own ``_build/``, and
its public ``blur_or_sharpen_fused``, ``separable_blur_nhwc`` and probe
cases are held against the plain versions and timed on the same inputs in
turns with the current ones: old, new, new, old (K2 and the probes under
both yardsticks). Each line printed is one JSON row. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
from pathlib import Path

import torch

from .. import _build
from ..ops import augment as A
from ..ops.cuda import blur as K2
from ..ops.cuda import colorops as K1
from . import layout_probe as P
from .timing import bound_ms, cuda_time_ms, rotating_time_ms, rotation_count

__all__ = ["load_package", "main"]

_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 2e-2}


def load_package(pkg: Path, name: str):
    """Import the package directory ``pkg`` as ``name``, beside this one
    (the port's modules import each other relatively); return it."""
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _cases(dev):
    """(kernel, label, args, public wrapper's name, cold L2) of every case."""
    gen = torch.Generator(device=dev).manual_seed(0)
    for shape in ((32, 224, 224, 3), (32, 1024, 1024, 3)):
        N = shape[0]
        taps = A.sample_blur_taps(gen, N, kmax=K1.KMAX17)
        sharp = A.sample_sharpen_kern(gen, N)
        for dt in (torch.bfloat16, torch.float32):
            img = torch.rand(shape, generator=gen, device=dev).to(dt)
            sels = {"arange % 3": (torch.arange(N, device=dev) % 3).to(torch.int32)}
            if shape[1] == 1024 and dt == torch.bfloat16:
                mix = torch.tensor([0] * 16 + [1] * 8 + [2] * 8)
                perm = torch.randperm(N, generator=torch.Generator().manual_seed(0))
                sels["step mix"] = mix[perm].to(dev, torch.int32)
            for label, sel in sels.items():
                yield ("K1", f"{list(shape)} {str(dt)[6:]} {label}", (img, taps, sharp, sel),
                       "blur_or_sharpen_fused", False)
    for shape, dt in (((32, 1024, 1024, 3), torch.float32), ((32, 1024, 1024, 3), torch.bfloat16),
                      ((32, 224, 224, 3), torch.float32)):
        N = shape[0]
        img = torch.rand(shape, generator=gen, device=dev).to(dt)
        ksize = 19 + 2 * (torch.arange(N, device=dev) % 3)
        sigma = torch.rand(N, generator=gen, device=dev) * 1.9 + 0.1
        yield ("K2", f"{list(shape)} {str(dt)[6:]}",
               (img, A.blur_taps_from_draws(ksize, sigma, K2.KMAX)), "separable_blur_nhwc", True)


def _both(fn, sets) -> dict:
    """``fn(sets[0])`` with L2 flushed, and ``fn`` over the rotated ``sets``."""
    return {"flush_ms": cuda_time_ms(lambda: fn(sets[0]), cold_l2=True),
            "rotating_ms": rotating_time_ms(fn, sets)}


def _in_turns(fns: dict, time_one) -> dict:
    """old, new, new, old: each side's timings in turn order."""
    times = {"old": [], "new": []}
    for who in ("old", "new", "new", "old"):
        times[who].append(time_one(fns[who]))
    return times


def _stencils(dev, sms, old) -> bool:
    ok = True
    for kernel, label, a, public, cold in _cases(dev):
        img = a[0]
        ref = (K1.blur_or_sharpen_fused_ref if kernel == "K1" else K2.separable_blur_nhwc_ref)(*a)
        out = torch.empty_like(img)
        ptrs = (img.element_size(), img.data_ptr(), out.data_ptr())
        if kernel == "K1":  # the 16-byte rows and the element-wise path
            plan = K1.launch_plan(img.shape, *ptrs)
            variants = [plan, 0]
            launch = lambda v: K1._launch(*a, out, v)  # noqa: E731
        else:  # strips of 1, 3, 6 and 11 chunks, and the plan's with the element-wise path
            plan = K2.launch_plan(img.shape, *ptrs, sms=sms)
            variants = [(c, 1) for c in (1, 3, 6, 11)] + [(plan[0], 0)]
            launch = lambda v: K2._launch(*a, out, v)  # noqa: E731
        for variant in variants:
            err = float((launch(variant).float() - ref.float()).abs().max())
            ms = cuda_time_ms(lambda: launch(variant), cold_l2=cold)
            ok &= err <= _TOL[img.dtype]
            print(json.dumps({"kernel": kernel, "case": label, "plan": variant,
                              "chosen": variant == plan, "max_abs_err": err, "ms": ms}),
                  flush=True)
        fns = {"new": getattr(K1 if kernel == "K1" else K2, public)}
        if cold:  # argument sets to rotate: (image, taps) copies, 2 x the image's bytes a call
            k = rotation_count(2 * img.numel() * img.element_size())
            sets = [a] + [tuple(t.clone() for t in a) for _ in range(k - 1)]
            print(json.dumps({"kernel": kernel, "case": label, "plan": plan,
                              **_both(lambda s: fns["new"](*s), sets)}), flush=True)
        if old is not None:
            fns["old"] = getattr(old["colorops" if kernel == "K1" else "blur"], public)
            err = float((fns["old"](*a).float() - ref.float()).abs().max())
            ok &= err <= _TOL[img.dtype]
            row = {"kernel": kernel, "case": label, "plan": plan, "old_max_abs_err": err}
            if cold:
                for key, t in (("flush", lambda f: cuda_time_ms(lambda: f(*a), cold_l2=True)),
                               ("rotating", lambda f: rotating_time_ms(lambda s: f(*s), sets))):
                    times = _in_turns(fns, t)
                    row[f"old_{key}_ms"], row[f"new_{key}_ms"] = times["old"], times["new"]
            else:
                times = _in_turns(fns, lambda f: cuda_time_ms(lambda: f(*a)))
                row["old_ms"], row["new_ms"] = times["old"], times["new"]
            print(json.dumps(row), flush=True)
        del ref, out
    return ok


def _probes(dev, old_probe) -> bool:
    """Every probe case under both yardsticks (and against an earlier copy's
    kernel in turns), then the device-to-device copy control."""
    ok = True
    inputs = P.probe_inputs(dev)
    old_cases = dict(zip((c.label for c in P.CASES), old_probe.CASES)) if old_probe else {}
    for case in P.CASES:
        plain = case.plain(inputs)
        sets = case.rotation(inputs)
        exact = torch.equal(case.kernel(inputs), plain) and torch.equal(case.library(inputs), plain)
        row = {"probe": case.probe, "case": case.label, "exact": exact,
               "bound_ms": bound_ms(case.bound_bytes(inputs))[0], "sets": len(sets),
               **_both(case.kernel, sets),
               **{f"library_{k}": v for k, v in _both(case.library, sets).items()}}
        old_case = old_cases.get(case.label)
        if old_case is not None:
            fns = {"old": old_case.kernel, "new": case.kernel}
            row["old_exact"] = torch.equal(old_case.kernel(inputs), plain)
            exact &= row["old_exact"]
            for key, t in (("flush", lambda f: cuda_time_ms(lambda: f(inputs), cold_l2=True)),
                           ("rotating", lambda f: rotating_time_ms(f, sets))):
                times = _in_turns(fns, t)
                row[f"old_{key}_ms"], row[f"new_{key}_ms"] = times["old"], times["new"]
        ok &= exact
        print(json.dumps(row), flush=True)
        del sets
    x = inputs["x"]
    nbytes = 2 * x.numel() * x.element_size()
    k = rotation_count(nbytes)
    sets = [(x.clone(), torch.empty_like(x)) for _ in range(2 * k)]
    copy = lambda s: s[1].copy_(s[0])  # noqa: E731
    print(json.dumps({"probe": "control", "case": f"Tensor.copy_ of {list(x.shape)} bf16",
                      "bound_ms": bound_ms(nbytes)[0], "sets": k,
                      "warm_ms": cuda_time_ms(lambda: copy(sets[0])),
                      **_both(copy, sets[:k]),
                      "rotating_ms_twice_the_sets": rotating_time_ms(copy, sets)}), flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path,
                    help="directory holding an earlier copy of the msfwsi_tpu_torch package")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_compare: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    _build.build_all()
    old = old_probe = None
    if args.old:
        pkg = load_package(args.old / "msfwsi_tpu_torch", "msfwsi_tpu_torch_old")
        importlib.import_module(f"{pkg.__name__}._build").build_all()
        old = {k: importlib.import_module(f"{pkg.__name__}.ops.cuda.{k}")
               for k in ("colorops", "blur")}
        old_probe = importlib.import_module(f"{pkg.__name__}.diag.layout_probe")
    ok = _stencils(dev, sms, old)
    ok &= _probes(dev, old_probe)
    print(f"kernel_compare: {'all variants agree' if ok else 'A VARIANT DISAGREES'} with the "
          f"plain versions on {torch.cuda.get_device_name(0)}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
