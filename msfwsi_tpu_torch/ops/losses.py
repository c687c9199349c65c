"""SimSiam losses of MSF-WSI (port of ``msfwsi_tpu/ops/losses.py``).

Reductions run in fp32 whatever the compute dtype.
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["cosine_similarity", "simsiam_loss", "msfwsi_loss"]


def cosine_similarity(a, b, eps: float = 1e-8):
    """Row-wise cosine similarity with torch ``nn.CosineSimilarity``
    clamping: ``dot / max(||a||*||b||, eps)``."""
    a = a.float()
    b = b.float()
    dot = (a * b).sum(dim=-1)
    na = torch.linalg.vector_norm(a, dim=-1)
    nb = torch.linalg.vector_norm(b, dim=-1)
    return dot / (na * nb).clamp_min(eps)


def simsiam_loss(p1, p2, z1, z2):
    """Symmetric negative cosine ``-(cos(p1,z2)+cos(p2,z1))/2`` (batch
    mean); ``z1``/``z2`` arrive detached."""
    return -(cosine_similarity(p1, z2).mean() + cosine_similarity(p2, z1).mean()) * 0.5


def msfwsi_loss(outputs: dict, fuser_weights: Sequence[float]):
    """Total loss over the three paths and four scales, each scale weighted
    by ``fuser_weights``; returns ``(total, {"context", "target", "fuser"})``."""
    per_path = {}
    for path in ("context", "target", "fuser"):
        p1s, p2s, z1s, z2s = outputs[path]
        loss = 0.0
        for i, (p1, p2, z1, z2) in enumerate(zip(p1s, p2s, z1s, z2s)):
            loss += simsiam_loss(p1, p2, z1, z2) * fuser_weights[i]
        per_path[path] = loss
    total = per_path["context"] + per_path["target"] + per_path["fuser"]
    return total, per_path
