"""Build the hand-written CUDA kernels of ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers: a source that includes them
takes minutes to build, a plain one seconds). Libraries go into ``_build/``
beside this file, named by a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. All sources are
compiled in parallel, one ``nvcc`` process each.

Nothing is built when this module is imported: the first call to
:func:`load` (or :func:`build_all`) does it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "sources", "build_all", "load"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def sources() -> dict[str, Path]:
    """Kernel name -> source file, one per ``csrc/*.cu``."""
    return {p.stem: p for p in sorted(CSRC_DIR.glob("*.cu"))}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found on PATH or under /usr/local/cuda/bin")


def _library_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, all at once; return
    name -> library path. Raises ``RuntimeError`` with nvcc's output if any
    compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    srcs = sources()
    libs = {name: _library_path(src) for name, src in srcs.items()}
    todo = {name: path for name, path in libs.items() if not path.exists()}
    if not todo:
        return libs
    nvcc = _nvcc()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(srcs[name])]
        procs[name] = (tmp, path, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for name, (tmp, path, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it first if
    needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            libs = build_all()
            if name not in libs:
                raise RuntimeError(f"no kernel source csrc/{name}.cu")
            lib = _loaded[name] = ctypes.CDLL(str(libs[name]))
        return lib
