"""ctypes bindings of the port's tile decoder (``tileio.cpp``).

The library is built with ``g++`` at first use into ``msfwsi_tpu_torch/_build/``
(git-ignored), named by a hash of the source and the flags, as ``_build.py``
names the kernels, so an edited source is rebuilt. PNG is decoded by the
library itself on top of zlib; JPEG only where the build finds libjpeg's
header (:func:`has_jpeg`). There is no fallback decoder: a file that cannot
be decoded raises, naming the file.

Nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["SOURCE", "header_found", "load_library", "has_jpeg", "probe", "decode_batch",
           "load_image"]

SOURCE = Path(__file__).resolve().parent / "tileio.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_REASONS = {
    -1: "cannot be opened",
    -2: "is corrupt or truncated",
    -3: "has another shape or bit depth than the batch's first file",
    -4: "bad arguments",
    -5: "is an unsupported PNG (only non-interlaced 8-bit grey, RGB, palette, grey+alpha "
        "and RGBA, and 16-bit grey, are decoded)",
    -6: "is a JPEG, and this build found no libjpeg",
    -7: "has a side above the decoder's limit of 2^20 pixels",
    -8: "holds more than the decoder's limit of 4 GiB of raw image bytes (one zlib inflate "
        "into one buffer)",
}

_lock = threading.Lock()
_lib = None


def header_found(name: str) -> bool:
    """Whether ``g++`` finds the C header ``name`` (e.g. ``"png.h"``)."""
    res = subprocess.run(["g++", "-x", "c++", "-E", "-", "-o", os.devnull],
                         input=f"#include <{name}>\n", capture_output=True, text=True,
                         timeout=60)
    return res.returncode == 0


def _build() -> Path:
    flags = list(_FLAGS)
    libs = ["-lz", "-lpthread"]
    if header_found("jpeglib.h"):
        flags.append("-DTILEIO_JPEG")
        libs.insert(0, "-ljpeg")
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(flags + libs).encode())
    path = _BUILD_DIR / f"libtileio_{h.hexdigest()[:16]}.so"
    if path.exists():
        return path
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run(["g++", *flags, "-o", str(tmp), str(SOURCE), *libs],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SOURCE.name} (exit {res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return path


def load_library() -> ctypes.CDLL:
    """The loaded decoder library, building it first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            i32p = ctypes.POINTER(ctypes.c_int)
            lib.tileio_decode_batch.restype = ctypes.c_int
            lib.tileio_decode_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p,
            ]
            lib.tileio_probe.restype = ctypes.c_int
            lib.tileio_probe.argtypes = [ctypes.c_char_p, i32p, i32p, i32p, i32p]
            lib.tileio_has_jpeg.restype = ctypes.c_int
            lib.tileio_has_jpeg.argtypes = []
            _lib = lib
        return _lib


def has_jpeg() -> bool:
    """Whether this build decodes JPEG."""
    return bool(load_library().tileio_has_jpeg())


def _fail(path, code: int) -> IOError:
    return IOError(f"cannot decode {path}: it {_REASONS.get(code, f'failed (code {code})')}")


def _probe(path: str) -> tuple[int, int, int, int]:
    """(height, width, channels, bytes a sample) of an image file."""
    h, w, c, b = ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = load_library().tileio_probe(os.fsencode(path), ctypes.byref(h), ctypes.byref(w),
                                     ctypes.byref(c), ctypes.byref(b))
    if rc != 0:
        raise _fail(path, rc)
    return h.value, w.value, c.value, b.value


def probe(path: str) -> tuple[int, int, int]:
    """(height, width, channels as stored) of an image file."""
    return _probe(path)[:3]


def decode_batch(paths, height: int, width: int, channels: int, n_threads: int = 0,
                 out: np.ndarray | None = None, dtype=np.uint8) -> np.ndarray:
    """Decode ``len(paths)`` images of one shape into one contiguous
    (N, H, W, C) array of ``dtype``, ``out`` if given; C = 1 gives
    (N, H, W). ``dtype`` is uint8 (tiles, masks), or uint16 for 16-bit grey
    PNGs. ``n_threads`` 0 takes one thread per core. Raises ``IOError``
    naming the first file that failed."""
    n = len(paths)
    dtype = np.dtype(dtype)
    if dtype not in (np.uint8, np.uint16):
        raise ValueError(f"dtype must be uint8 or uint16, got {dtype}")
    shape = (n, height, width) if channels == 1 else (n, height, width, channels)
    if out is None:
        out = np.empty(shape, dtype)
    elif out.dtype != dtype or out.shape != shape or not out.flags.c_contiguous:
        raise ValueError(f"out must be a C-contiguous {dtype} array of shape {shape}, "
                         f"got {out.dtype} {out.shape}")
    if n == 0:
        return out
    status = (ctypes.c_int * n)()
    names = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    rc = load_library().tileio_decode_batch(names, n, out.ctypes.data, height, width,
                                            channels, dtype.itemsize, n_threads, status)
    if rc != 0:
        i = next(i for i in range(n) if status[i] != 0)
        raise _fail(paths[i], status[i])
    return out


def load_image(path: str) -> np.ndarray:
    """One image as stored: (H, W) for one channel, else (H, W, C), uint8,
    or uint16 for a 16-bit grey PNG, as ``np.asarray(PIL.Image.open(path))``
    gives it."""
    h, w, c, b = _probe(path)
    return decode_batch([path], h, w, c, n_threads=1, dtype=np.uint16 if b == 2 else np.uint8)[0]
