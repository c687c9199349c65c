"""ImageNet encoder init: find torchvision ResNet weights on local disk.

Port of ``msfwsi_tpu/utils/imagenet.py`` without its download (the
machines that run the port have no network). The reference always builds
its encoders with ``pretrained=True`` (``src/models/backbone.py:58-63``).
For an architecture (e.g. ``resnet18``) the weights are:
  1. an explicit local path (``--imagenet-weights /path/file.pth``), or
  2. a file named ``<arch>.pth`` or ``<arch>-*.pth`` in, in order:
     ``$MSFWSI_IMAGENET_DIR``, ``~/.cache/msfwsi_tpu``, ``<repo>/weights``
     and the torch.hub cache ``~/.cache/torch/hub/checkpoints``.

:func:`resolve_imagenet_weights` returns ``None`` when none is found.
"""

from __future__ import annotations

import os

__all__ = ["resolve_imagenet_weights", "search_dirs"]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def search_dirs() -> list[str]:
    dirs = []
    if os.environ.get("MSFWSI_IMAGENET_DIR"):
        dirs.append(os.environ["MSFWSI_IMAGENET_DIR"])
    dirs.append(os.path.expanduser("~/.cache/msfwsi_tpu"))
    dirs.append(os.path.join(_REPO_ROOT, "weights"))
    dirs.append(os.path.expanduser("~/.cache/torch/hub/checkpoints"))
    return dirs


def _find_local(arch: str) -> str | None:
    for d in search_dirs():
        if not os.path.isdir(d):
            continue
        for name in sorted(os.listdir(d)):
            if name == f"{arch}.pth" or (name.startswith(f"{arch}-") and name.endswith(".pth")):
                return os.path.join(d, name)
    return None


def resolve_imagenet_weights(arch: str, explicit: str = "") -> str | None:
    """A local path to torchvision ImageNet weights for ``arch``, or None.
    A non-empty ``explicit`` path that does not exist raises."""
    if explicit:
        if not os.path.exists(explicit):
            raise FileNotFoundError(f"--imagenet-weights file not found: {explicit}")
        return explicit
    return _find_local(arch)
