"""SimSiam losses of MSF-WSI and the fine-tuning Dice loss (port of
``msfwsi_tpu/ops/losses.py``).

Reductions run in fp32 whatever the compute dtype.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..parallel.mesh import all_reduce_sum

__all__ = ["cosine_similarity", "simsiam_loss", "msfwsi_loss", "dice_loss"]


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


def dice_loss(logits, target, classes: Sequence[int] | None = None, smooth: float = 0.0,
              eps: float = 1e-7, sample_mask=None, group=None):
    """Multiclass soft Dice loss on NHWC logits (smp-compatible).

    ``logits`` (N, H, W, C), ``target`` (N, H, W) integer classes in [0, C).
    Per class c, with sums over the batch and the pixels,
    ``loss_c = 1 - 2*sum(p_c * 1[y=c]) / max(sum(p_c + 1[y=c]), eps)``,
    zeroed when class c never appears in the target; the result is the mean
    of ``loss_c`` over ``classes`` (the reference passes ``[1..C]``, leaving
    out background 0), or over all classes. The softmax runs in fp32.
    ``sample_mask`` (N,): samples at 0 contribute to no sum, so a padded
    batch gives the loss of its real samples exactly. ``group``: the batch
    is split over this data-parallel group; the sums are taken over the
    global batch by a differentiable all-reduce, so every rank gets the
    global loss."""
    num_classes = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1)
    onehot = (target[..., None] == torch.arange(num_classes, device=target.device)).float()
    if sample_mask is not None:
        m = sample_mask.float().view(-1, 1, 1, 1)
        probs = probs * m
        onehot = onehot * m
    dims = (0, 1, 2)
    intersection = (probs * onehot).sum(dim=dims)
    cardinality = (probs + onehot).sum(dim=dims)
    count = onehot.sum(dim=dims)
    if group is not None:
        intersection, cardinality, count = all_reduce_sum(
            torch.stack([intersection, cardinality, count]), group)
    score = (2.0 * intersection + smooth) / (cardinality + smooth).clamp_min(eps)
    present = count > 0
    loss = (1.0 - score) * present.float()
    if classes is not None:
        loss = loss[torch.as_tensor(list(classes), device=loss.device)]
    return loss.mean()
