"""The alignment test that picks the 16-byte rows of the two stencil
kernels (``csrc/stencil.cuh``). Plain Python, so the CPU tests reach it."""

from __future__ import annotations

__all__ = ["vector_rows"]


def vector_rows(W: int, itemsize: int, *ptrs: int) -> bool:
    """True where the kernels may move whole rows in 16-byte pieces: every
    row of a (.., W, 3) image of ``itemsize``-byte elements starts on a
    16-byte boundary, i.e. the row's bytes are a multiple of 16 and each of
    the tensors' addresses ``ptrs`` is 16-byte aligned."""
    return (W * 3 * itemsize) % 16 == 0 and all(p % 16 == 0 for p in ptrs)
