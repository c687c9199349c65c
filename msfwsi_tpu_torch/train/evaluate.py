"""Per-slide tiled validation (port of ``msfwsi_tpu/train/evaluate.py``;
reference ``tools/evaluate.py:240-326``, ``ssl_finetune.py:477-563``).

  * one slide is one batch: all its tiles, through HookNet in chunks of
    128 (``evaluate.py:270-281``), in eval mode;
  * the predicted mask is the argmax of the target logits, scored by
    ``get_stats(pred-1, mask-1, ignore_index=-1)`` (background ignored);
  * micro F1 / IoU / accuracy per slide and their means over slides; per
    class, the slide's summed counts scored with ``reduction=None``.

A slide is padded to a multiple of the chunk with all-zero tiles: their
masks are 0, so every pixel is ignored and they count nowhere. The counts
accumulate on the device as a (4, C) int64 tensor and are fetched once per
slide. On the card, chunk i+1 is copied from pinned memory on a side stream
while chunk i runs.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import numpy as np
import torch

from .. import resolve_device
from ..data.pipeline import AugConfig, _to_float, make_seg_val_views
from ..ops import augment as A
from ..ops.metrics import accuracy, f1_score, get_stats, iou_score
from ..utils.misc import prefetch_iter

__all__ = [
    "make_chunk_stats",
    "make_chunk_stats_u8",
    "make_chunk_stats_hostviews",
    "make_chunk_stats_for_views",
    "validate_slide_u8",
    "validate_slide_hostviews",
    "validate_slides",
    "validate",
    "SlideScores",
]


@contextlib.contextmanager
def _eval_forward(model, device_type: str, amp: bool):
    """Eval mode, no autograd and (under ``amp``) bf16 autocast; the
    model's train/eval mode is restored after."""
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad(), torch.autocast(device_type, dtype=torch.bfloat16, enabled=amp):
            yield
    finally:
        model.train(was_training)


def _chunk_counts(model, ctx, tgt, tmask, num_classes: int, amp: bool):
    """(4, C) summed tp/fp/fn/tn of one chunk."""
    with _eval_forward(model, ctx.device.type, amp):
        _, tgt_logits = model(ctx, tgt)
    pred = tgt_logits.float().argmax(dim=-1)
    tp, fp, fn, tn = get_stats(pred - 1, tmask.long() - 1, num_classes, ignore_index=-1)
    return torch.stack([tp.sum(0), fp.sum(0), fn.sum(0), tn.sum(0)])


def make_chunk_stats(model, num_classes: int, amp: bool = False) -> Callable:
    """``stats(ctx, tgt, masks, acc) -> acc``: the forward of one chunk of
    normalized views and its counts added to ``acc`` (4, C)."""

    def stats(ctx, tgt, masks, acc):
        return acc + _chunk_counts(model, ctx, tgt, masks, num_classes, amp)

    return stats


def make_chunk_stats_hostviews(model, num_classes: int, cfg: AugConfig = AugConfig(),
                               amp: bool = False) -> Callable:
    """``stats(ctx_u8, tgt_u8, tmask, acc) -> acc`` on host-built uint8
    views (:func:`..data.pipeline.make_seg_val_views_host`): ``/255`` and
    Normalize on the device, then the forward and the counts."""

    def stats(ctx_u8, tgt_u8, tmask, acc):
        ctx = A.normalize(_to_float(ctx_u8, cfg.dtype), cfg.mean, cfg.std)
        tgt = A.normalize(_to_float(tgt_u8, cfg.dtype), cfg.mean, cfg.std)
        return acc + _chunk_counts(model, ctx, tgt, tmask, num_classes, amp)

    return stats


def make_chunk_stats_u8(model, num_classes: int, cfg: AugConfig = AugConfig(),
                        amp: bool = False) -> Callable:
    """``stats(imgs_u8, masks_u8, acc) -> acc`` on raw uint8 tiles: the
    evaluation views built on the device (``--val-views device``)."""

    def stats(imgs_u8, masks_u8, acc):
        (ctx, tgt), (_, tmask) = make_seg_val_views(imgs_u8, masks_u8, cfg)
        return acc + _chunk_counts(model, ctx, tgt, tmask, num_classes, amp)

    return stats


def make_chunk_stats_for_views(model, num_classes: int, val_views: str,
                               cfg: AugConfig = AugConfig(), amp: bool = False) -> Callable:
    """The stats function of a ``--val-views`` mode: "host" takes host-built
    uint8 views, "device" raw uint8 tiles."""
    if val_views == "host":
        return make_chunk_stats_hostviews(model, num_classes, cfg, amp)
    if val_views == "device":
        return make_chunk_stats_u8(model, num_classes, cfg, amp)
    raise ValueError(f"unknown val_views {val_views!r} (host or device)")


def _pad_to_multiple(arr: np.ndarray, chunk: int) -> np.ndarray:
    pad = (-arr.shape[0]) % chunk
    if pad:
        arr = np.concatenate([arr, np.zeros((pad, *arr.shape[1:]), arr.dtype)], axis=0)
    return arr


def _chunks_cuda(arrays, chunk: int, device):
    """Yield each chunk of ``arrays`` on ``device``: staged in one of two
    pinned slots, copied on a side stream, the current stream made to wait
    for the copy. The next chunk is staged when the consumer asks for it,
    after it has queued its work on the current one."""
    side = torch.cuda.Stream(device)
    cur = torch.cuda.current_stream(device)
    slots = [[torch.empty((chunk, *a.shape[1:]), dtype=torch.from_numpy(a[:0]).dtype,
                          pin_memory=True) for a in arrays] for _ in range(2)]
    copied = [None, None]
    for i, lo in enumerate(range(0, arrays[0].shape[0], chunk)):
        slot = i % 2
        if copied[slot] is not None:
            copied[slot].synchronize()  # the slot's last copy must be done
        for p, a in zip(slots[slot], arrays):
            p.numpy()[:] = a[lo : lo + chunk]
        with torch.cuda.stream(side):
            out = [p.to(device, non_blocking=True) for p in slots[slot]]
            copied[slot] = torch.cuda.Event()
            copied[slot].record(side)
        cur.wait_event(copied[slot])
        for t in out:
            t.record_stream(cur)
        yield out


def _run_chunked_stats(stats_fn: Callable, arrays: tuple, num_classes: int, chunk: int,
                       device) -> tuple[dict, tuple]:
    """Pad ``arrays`` to a multiple of ``chunk``, run ``stats_fn`` over the
    chunks with the counts kept on ``device``, and fetch the sums once.
    Returns (micro scores, (tp, fp, fn, tn) sums as int64 numpy)."""
    dev = resolve_device(device)
    arrays = tuple(_pad_to_multiple(np.ascontiguousarray(a), chunk) for a in arrays)
    acc = torch.zeros((4, num_classes), dtype=torch.int64, device=dev)
    if dev.type == "cuda":
        chunks = _chunks_cuda(arrays, chunk, dev)
    else:
        chunks = ([torch.from_numpy(a[lo : lo + chunk]) for a in arrays]
                  for lo in range(0, arrays[0].shape[0], chunk))
    for args in chunks:
        acc = stats_fn(*args, acc)
    sums = acc.cpu().numpy()  # the slide's one device-to-host fetch
    micro = {
        "f1": float(f1_score(*sums, reduction="micro")),
        "iou": float(iou_score(*sums, reduction="micro")),
        "acc": float(accuracy(*sums, reduction="micro")),
    }
    return micro, tuple(sums)


def validate_slide_u8(stats_fn: Callable, imgs_u8, masks_u8, num_classes: int,
                      chunk: int = 128, device="cuda"):
    """One slide from raw uint8 tiles with a :func:`make_chunk_stats_u8`
    function."""
    return _run_chunked_stats(stats_fn, (imgs_u8, masks_u8), num_classes, chunk, device)


def validate_slide_hostviews(stats_fn: Callable, ctx_u8, tgt_u8, tmask, num_classes: int,
                             chunk: int = 128, device="cuda"):
    """One slide from host-built uint8 views with a
    :func:`make_chunk_stats_hostviews` function."""
    return _run_chunked_stats(stats_fn, (ctx_u8, tgt_u8, tmask), num_classes, chunk, device)


class SlideScores:
    """The reference's validation aggregates (``evaluate.py:251-256,319-326``):
    per-slide micro scores, and per-class scores of each slide's counts."""

    def __init__(self, class_names):
        self.class_names = list(class_names)
        self.micro = {"f1": [], "iou": [], "acc": []}
        self.per_class = {m: {c: [] for c in self.class_names} for m in ("f1", "iou", "acc")}
        self.counts = []  # per slide, its (4, C) int64 tp/fp/fn/tn sums

    def update(self, micro: dict, sums):
        self.counts.append(np.stack(sums))
        for k, v in micro.items():
            self.micro[k].append(v)
        raw = {"f1": f1_score(*sums), "iou": iou_score(*sums), "acc": accuracy(*sums)}
        for m, scores in raw.items():
            for idx, cls in enumerate(self.class_names):
                self.per_class[m][cls].append(float(scores[idx]))

    def summary(self) -> dict:
        out = {f"{k}_micro": float(np.mean(v)) for k, v in self.micro.items()}
        for m in ("f1", "iou", "acc"):
            for cls in self.class_names:
                out[f"{m}_{cls}"] = float(np.mean(self.per_class[m][cls]))
        return out


def validate_slides(stats_fn: Callable, slides, val_views: str, class_names,
                    chunk: int = 128, device="cuda", on_slide: Callable | None = None):
    """The CLI's per-slide validation loop: ``slides`` yields ``(ctx_u8,
    tgt_u8, tmask)`` for "host" views or ``(imgs_u8, masks_u8)`` for
    "device" views; the next slide's decode and host views are made on a
    background thread while the current one runs. ``on_slide(i, micro)`` is
    called after each slide. Returns the :class:`SlideScores`."""
    validate_one = validate_slide_hostviews if val_views == "host" else validate_slide_u8
    scores = SlideScores(class_names)
    for i, item in enumerate(prefetch_iter(slides)):
        micro, sums = validate_one(stats_fn, *item, num_classes=len(scores.class_names),
                                   chunk=chunk, device=device)
        scores.update(micro, sums)
        if on_slide is not None:
            on_slide(i, micro)
    return scores


def validate(model, slides, class_names, chunk: int = 128, stats_fn: Callable | None = None,
             amp: bool = False, device="cuda") -> dict:
    """One validation pass over ``slides``, each ``(ctx, tgt, masks)``:
    normalized context and target views (T, s, s, 3) and the target masks
    (T, s, s). ``stats_fn`` is a :func:`make_chunk_stats` function, built
    from ``model`` when not given. Returns the summary: the micro scores'
    means over slides and the per-class means."""
    scores = SlideScores(class_names)
    num_classes = len(scores.class_names)
    stats_fn = stats_fn or make_chunk_stats(model, num_classes, amp)
    for ctx, tgt, masks in slides:
        micro, sums = _run_chunked_stats(
            stats_fn, (ctx, tgt, np.asarray(masks).astype(np.int32)), num_classes, chunk, device)
        scores.update(micro, sums)
    return scores.summary()
