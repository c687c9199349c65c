"""Chunked slide prediction: a fine-tuned HookNet over a slide's tiles,
returning the predicted class-index masks (port of
``msfwsi_tpu/train/predict.py``).

Heads:
  * ``"target"``: argmax of the target logits, the seg_size center crop of
    each tile at full resolution (the map the reference scores);
  * ``"context"``: argmax of the context logits, the whole tile at seg_size
    (1/4 scale for 1024 px tiles; stitched slide maps have no gaps).

Predictions leave the card as uint8, each chunk's copied into pinned host
memory on a side stream as soon as the chunk is queued; the host waits once
per slide. The chunks go up through the validation's pinned side-stream
path (:func:`.evaluate._chunks_cuda`). :func:`predict_slide` serves any
chunk function that returns a tuple of tensors, the feature extraction's
too. Under a ``mesh`` each data rank runs its slice of every chunk and the
outputs are gathered to rank 0, which alone gets the slide's arrays.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..data.pipeline import AugConfig, _to_float, make_seg_val_views
from ..ops import augment as A
from ..ops.geometry import TileGrid
from .evaluate import _chunks_cuda, _eval_forward, shard_chunks

__all__ = [
    "HEADS",
    "make_chunk_preds_hostviews",
    "make_chunk_preds_u8",
    "make_chunk_preds_for_views",
    "predict_slide",
    "stitch_context_preds",
    "stitch_target_preds",
]

HEADS = ("context", "target")


def _check_heads(heads) -> tuple:
    heads = tuple(heads)
    bad = [h for h in heads if h not in HEADS]
    if bad or not heads:
        raise ValueError(f"heads must be a non-empty subset of {HEADS}, got {heads!r}")
    return heads


def _preds(model, ctx, tgt, heads, amp: bool) -> tuple:
    """The uint8 argmax of each head's fp32 logits (the first index at
    ties, as ``jnp.argmax``)."""
    with _eval_forward(model, ctx.device.type, amp):
        by_head = dict(zip(HEADS, model(ctx, tgt)))
    return tuple(by_head[h].float().argmax(dim=-1).to(torch.uint8) for h in heads)


def make_chunk_preds_hostviews(model, cfg: AugConfig = AugConfig(), heads=("target",),
                               amp: bool = False) -> Callable:
    """``preds(ctx_u8, tgt_u8) -> tuple[(chunk, s, s) uint8 per head]`` on
    host-built uint8 views (:func:`..data.pipeline.make_seg_val_views_host`):
    ``/255`` and Normalize on the device, then the forward."""
    heads = _check_heads(heads)

    def preds(ctx_u8, tgt_u8):
        ctx = A.normalize(_to_float(ctx_u8, cfg.dtype), cfg.mean, cfg.std)
        tgt = A.normalize(_to_float(tgt_u8, cfg.dtype), cfg.mean, cfg.std)
        return _preds(model, ctx, tgt, heads, amp)

    return preds


def make_chunk_preds_u8(model, cfg: AugConfig = AugConfig(), heads=("target",),
                        amp: bool = False) -> Callable:
    """``preds(imgs_u8)`` on raw uint8 tiles (chunk, tile, tile, 3): the
    evaluation views built on the device, with all-zero masks
    (``--val-views device``)."""
    heads = _check_heads(heads)

    def preds(imgs_u8):
        zeros = torch.zeros(imgs_u8.shape[:3], dtype=torch.int32, device=imgs_u8.device)
        (ctx, tgt), _ = make_seg_val_views(imgs_u8, zeros, cfg)
        return _preds(model, ctx, tgt, heads, amp)

    return preds


def make_chunk_preds_for_views(model, val_views: str, cfg: AugConfig = AugConfig(),
                               heads=("target",), amp: bool = False) -> Callable:
    """The prediction function of a ``--val-views`` mode: "host" takes
    host-built uint8 views, "device" raw uint8 tiles."""
    if val_views == "host":
        return make_chunk_preds_hostviews(model, cfg, heads, amp)
    if val_views == "device":
        return make_chunk_preds_u8(model, cfg, heads, amp)
    raise ValueError(f"unknown val_views {val_views!r} (host or device)")


def _run_cuda(fn: Callable, arrays: tuple, chunk: int, total: int, dev) -> list:
    """Each chunk's outputs copied into pinned host buffers of ``total``
    rows on a side stream, right after the chunk is queued; one wait."""
    side = torch.cuda.Stream(dev)
    cur = torch.cuda.current_stream(dev)
    host = None
    for i, args in enumerate(_chunks_cuda(arrays, chunk, dev)):
        out = fn(*args)
        if host is None:
            host = [torch.empty((total, *o.shape[1:]), dtype=o.dtype, pin_memory=True)
                    for o in out]
        queued = torch.cuda.Event()
        queued.record(cur)
        side.wait_event(queued)
        with torch.cuda.stream(side):
            for h, o in zip(host, out):
                h[i * chunk : (i + 1) * chunk].copy_(o, non_blocking=True)
                o.record_stream(side)  # not reused before its copy is done
    done = torch.cuda.Event()
    done.record(side)
    done.synchronize()  # the slide's one wait
    return host


def predict_slide(fn: Callable, arrays: tuple, chunk: int = 128, device="cuda", mesh=None
                  ) -> tuple[np.ndarray, ...] | None:
    """Run one slide's per-tile ``arrays`` (``(ctx_u8, tgt_u8)`` for host
    views, ``(imgs_u8,)`` for raw tiles) through a chunk function ``fn``,
    padded to a multiple of ``chunk``. Returns one numpy array per output
    of ``fn``, trimmed to the slide's tile count. Under a ``mesh`` with
    several data ranks (every rank calls it): rank 0 gets the arrays, the
    others None."""
    dev = resolve_device(device)
    n = int(arrays[0].shape[0])
    arrays, chunk = shard_chunks(arrays, chunk, mesh)
    total = arrays[0].shape[0]
    if dev.type == "cuda":
        host = _run_cuda(fn, arrays, chunk, total, dev)
    else:
        outs = [fn(*(torch.from_numpy(a[lo : lo + chunk]) for a in arrays))
                for lo in range(0, total, chunk)]
        host = [torch.cat(parts) for parts in zip(*outs)]
    local = [h.numpy() for h in host]
    if mesh is None or mesh.data == 1:
        return tuple(h[:n].copy() for h in local)
    parts = [None] * mesh.data if mesh.is_main else None
    dist.gather_object(local, parts, dst=0, group=mesh.data_group)
    if not mesh.is_main:
        return None
    # each rank holds rows [r * chunk, (r + 1) * chunk) of every whole chunk
    return tuple(np.stack([p[i].reshape(-1, chunk, *p[i].shape[1:]) for p in parts], axis=1)
                 .reshape(-1, *parts[0][i].shape[1:])[:n].copy() for i in range(len(local)))


def stitch_context_preds(preds: np.ndarray, indices, grid: TileGrid, seg_size: int = 256
                         ) -> np.ndarray:
    """Per-tile CONTEXT predictions (whole tile at seg_size) as one slide
    map at ``seg_size / tile_size`` scale. ``indices`` are the prep-time
    tile ids (the ``<idx>.png`` names), row-major on ``grid``; tiles the
    prep dropped stay class 0; the canvas is cropped to the scaled slide."""
    canvas = np.zeros((grid.num_h * seg_size, grid.num_w * seg_size), np.uint8)
    for p, idx in zip(preds, indices):
        i_h, i_w = divmod(int(idx), grid.num_w)
        canvas[i_h * seg_size : (i_h + 1) * seg_size, i_w * seg_size : (i_w + 1) * seg_size] = p
    sh = -(-grid.height * seg_size // grid.tile_size)  # ceil
    sw = -(-grid.width * seg_size // grid.tile_size)
    return canvas[:sh, :sw]


def stitch_target_preds(preds: np.ndarray, indices, grid: TileGrid, seg_size: int = 256
                        ) -> np.ndarray:
    """Per-tile TARGET predictions (full-resolution seg_size center crops)
    on a full-resolution slide canvas; outside the crops (and for dropped
    tiles) class 0."""
    canvas = np.zeros((grid.height, grid.width), np.uint8)
    off = (grid.tile_size - seg_size) // 2
    for p, idx in zip(preds, indices):
        y, x = grid.origin(int(idx))
        y, x = y + off, x + off
        y1, x1 = min(y + seg_size, grid.height), min(x + seg_size, grid.width)
        if y1 <= y or x1 <= x:
            continue  # the crop lies wholly in the padded margin
        canvas[y:y1, x:x1] = p[: y1 - y, : x1 - x]
    return canvas
