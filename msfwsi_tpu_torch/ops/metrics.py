"""Segmentation quality metrics with smp's semantics (port of
``msfwsi_tpu/ops/metrics.py``; reference usage ``tools/evaluate.py:283-310``,
``tools/ssl_finetune.py:319,440-447``).

The reference shifts labels down by one and ignores ``-1`` so that
background 0 is left out: ``get_stats(pred-1, mask-1, ignore_index=-1)``.

  * ignored pixels count in no class's tp/fp/fn and are taken off tn;
  * a prediction outside ``[0, num_classes)`` is neither tp nor fp, but
    its target still counts as fn;
  * a 0/0 score is 0 (smp's ``zero_division="warn"`` without the warning).

Counts are int64 and are summed as integers before any division: tn over a
slide of 257 or more 256 px tiles passes 2^24, where fp32 stops counting
exactly. Scores are fp32, as the JAX package computes them.
"""

from __future__ import annotations

import torch

__all__ = ["get_stats", "f1_score", "iou_score", "accuracy", "fbeta_score"]


def get_stats(output, target, num_classes: int, ignore_index: int | None = None):
    """Per-image, per-class confusion counts ``(tp, fp, fn, tn)``, each
    (N, num_classes) int64, of integer class maps ``output`` and
    ``target`` (N, ...)."""
    n = output.shape[0]
    output = output.reshape(n, -1)
    target = target.reshape(n, -1)
    num_elements = output.shape[1]
    if ignore_index is not None:
        ignored = target == ignore_index
        output = torch.where(ignored, torch.full_like(output, ignore_index), output)
        ignored_per_sample = ignored.sum(dim=1)
    else:
        ignored_per_sample = torch.zeros((n,), dtype=torch.int64, device=output.device)
    classes = torch.arange(num_classes, device=output.device)
    out_onehot = output[:, :, None] == classes  # (N, P, C)
    tgt_onehot = target[:, :, None] == classes
    tp = (out_onehot & tgt_onehot).sum(dim=1)
    fp = out_onehot.sum(dim=1) - tp
    fn = tgt_onehot.sum(dim=1) - tp
    tn = num_elements - ignored_per_sample[:, None] - tp - fp - fn
    return tp, fp, fn, tn


def _as_int64(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int64)


def _reduce(metric_fn, tp, fp, fn, tn, reduction):
    counts = [_as_int64(c) for c in (tp, fp, fn, tn)]

    def score(*cs):
        s = metric_fn(*(c.to(torch.float32) for c in cs))
        return torch.where(s.isnan(), torch.zeros_like(s), s)

    if reduction == "micro":
        return score(*(c.sum() for c in counts))
    if reduction == "micro-imagewise":
        return score(*(c.sum(-1) for c in counts)).mean()
    if reduction == "macro":
        return score(*(c.sum(0) for c in counts)).mean()
    if reduction == "macro-imagewise":
        return score(*counts).mean(0).mean()
    if reduction is None or reduction == "none":
        return score(*counts)
    raise ValueError(f"unsupported reduction {reduction!r}")


def fbeta_score(tp, fp, fn, tn, beta: float = 1.0, reduction=None):
    b2 = beta**2
    return _reduce(lambda tp, fp, fn, tn: ((1 + b2) * tp) / ((1 + b2) * tp + b2 * fn + fp),
                   tp, fp, fn, tn, reduction)


def f1_score(tp, fp, fn, tn, reduction=None):
    return fbeta_score(tp, fp, fn, tn, beta=1.0, reduction=reduction)


def iou_score(tp, fp, fn, tn, reduction=None):
    return _reduce(lambda tp, fp, fn, tn: tp / (tp + fp + fn), tp, fp, fn, tn, reduction)


def accuracy(tp, fp, fn, tn, reduction=None):
    return _reduce(lambda tp, fp, fn, tn: (tp + tn) / (tp + fp + fn + tn), tp, fp, fn, tn,
                   reduction)
