"""PyTorch / CUDA (H100) port of the MSF-WSI framework.

The package mirrors the layout of ``msfwsi_tpu`` (the JAX reference, which
stays the oracle its tests compare against) and imports nothing from it.
Hand-written CUDA kernels live in ``csrc/`` and are built with ``nvcc`` at
first use (see ``_build.py``).

Public entry points take ``device=`` (default ``"cuda"``) and raise
``RuntimeError`` when no GPU is present and the caller did not ask for the
CPU.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. A CUDA device with no GPU present
    is an error, never a silent move to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
