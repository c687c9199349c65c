"""SimSiam losses of MSF-WSI and the fine-tuning Dice loss (port of
``msfwsi_tpu/ops/losses.py``).

Reductions run in fp32 whatever the compute dtype.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from ..parallel.mesh import all_reduce_sum

__all__ = ["cosine_similarity", "simsiam_loss", "msfwsi_loss", "dice_loss", "dice_loss_packed"]


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


def _pack_target(target):
    """A logical (N, H, W) class map -> (N, H/2, W/2, 4), sub-position-major
    as the packed logits' groups (``ops/s2d.py``)."""
    N, H, W = target.shape
    return target.reshape(N, H // 2, 2, W // 2, 2).permute(0, 1, 3, 2, 4).reshape(
        N, H // 2, W // 2, 4)


def _packed_softmax(z, num_classes: int):
    N, h, w, _ = z.shape
    return torch.softmax(z.float().view(N, h, w, 4, num_classes), dim=-1)


def _packed_onehot(t, num_classes: int):
    return t[..., None] == torch.arange(num_classes, device=t.device)


def _class_weights(num_classes: int, classes, device):
    """(C,) weights of the mean over ``classes`` (all when None), copied to
    ``device`` without a wait for the device's queue."""
    cls = range(num_classes) if classes is None else classes
    w = torch.zeros(num_classes)
    w[list(cls)] = 1.0 / len(cls)
    return w.to(device, non_blocking=True)


class _DicePacked(torch.autograd.Function):
    """The JAX package's custom VJP of the packed Dice loss: the forward
    saves the logits (in their own dtype), the packed target, the sample
    mask, the three (C,) sums and the classes' weights; the backward
    recomputes the softmax in fp32 and returns ``dz`` in the logits' dtype,
    so no fp32 copy of the logits lives across the backward."""

    @staticmethod
    def forward(ctx, z, t, m, classes, smooth, eps, group):
        C = z.shape[-1] // 4
        probs = _packed_softmax(z, C)
        onehot = _packed_onehot(t, C)
        mm = m.view(-1, 1, 1, 1, 1)
        dims = (0, 1, 2, 3)
        sums = torch.stack([(probs * onehot * mm).sum(dim=dims), (probs * mm).sum(dim=dims),
                            (onehot * mm).sum(dim=dims)])
        del probs
        if group is not None:
            dist.all_reduce(sums, group=group)
        inter, psum, osum = sums
        sel = _class_weights(C, classes, z.device)
        ctx.save_for_backward(z, t, m, inter, psum, osum, sel)
        ctx.smooth, ctx.eps, ctx.group = smooth, eps, group
        card = psum + osum
        score = (2.0 * inter + smooth) / (card + smooth).clamp_min(eps)
        return ((1.0 - score) * (osum > 0).float() * sel).sum()

    @staticmethod
    def backward(ctx, gL):
        z, t, m, inter, psum, osum, sel = ctx.saved_tensors
        C = z.shape[-1] // 4
        smooth, eps = ctx.smooth, ctx.eps
        card = psum + osum
        denom = (card + smooth).clamp_min(eps)
        present = (osum > 0).float()
        active = (card + smooth >= eps).float()  # the max()'s pullback
        w_c = gL.float() * sel * present  # d(mean over classes) / d(loss_c)
        # loss_c = 1 - (2I + s)/denom: dI = -2/denom, dcard = (2I + s)/denom^2
        gI = w_c * (-2.0) / denom
        gP = w_c * (2.0 * inter + smooth) / denom.square() * active
        if ctx.group is not None:
            # dice_loss's differentiable all-reduce of the sums sums every
            # rank's (equal) cotangent back onto each rank's local sums; the
            # gradient mean over the group then divides by its size
            scale = float(dist.get_world_size(ctx.group))
            gI, gP = gI * scale, gP * scale
        probs = _packed_softmax(z, C)
        g = (gI * _packed_onehot(t, C) + gP) * m.view(-1, 1, 1, 1, 1)
        dz = probs * (g - (probs * g).sum(dim=-1, keepdim=True))
        return dz.view(z.shape).to(z.dtype), None, None, None, None, None, None


def dice_loss_packed(logits_packed, target, classes: Sequence[int] | None = None,
                     smooth: float = 0.0, eps: float = 1e-7, sample_mask=None, group=None):
    """:func:`dice_loss` on space-to-depth packed NHWC logits (N, H/2, W/2,
    4*C) (the packed head's output, sub-position-major) against the logical
    (N, H, W) ``target``: the softmax within each sub-position's class
    group, the per-class sums over batch, packed pixels and sub-positions
    (the logical pixel set), so it equals ``dice_loss`` on the logical
    logits up to rounding. A custom backward (the JAX package's VJP):
    ``dL/dp = m*(gI*y + gP)`` per class, ``dz = p*(g - sum_k p_k g_k)``.
    ``classes``, ``smooth``, ``eps``, ``sample_mask`` and ``group`` as in
    :func:`dice_loss`; with ``group`` the sums are all-reduced in the
    forward and the gradient is scaled as ``dice_loss``'s."""
    N = logits_packed.shape[0]
    t = _pack_target(target)
    m = (torch.ones((N,), device=logits_packed.device) if sample_mask is None
         else sample_mask.float())
    cls = None if classes is None else tuple(int(c) for c in classes)
    return _DicePacked.apply(logits_packed, t, m, cls, float(smooth), float(eps), group)
