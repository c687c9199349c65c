"""Host-side tile batch loader that feeds the card.

Port of ``msfwsi_tpu/data/loader.py``. The host only decodes tiles and
batches their uint8 pixels; every augmentation runs on the device
(:mod:`.pipeline`).

  * Files are sharded like ``DistributedSampler``: a seeded shuffle of the
    whole list per epoch (``SeedSequence([seed, epoch])``), padded to a
    multiple of the world size, then strided by rank.
  * A background thread decodes each batch, with the port's C++ decoder
    (:mod:`..native`, threads of its own, outside the interpreter lock) or
    a thread pool over ``load_fn``.
  * On the card the decoder writes straight into a ring of ``prefetch + 1``
    pinned staging buffers; the copy to the device runs on a side CUDA
    stream and records an event, the consumer's stream waits on that event
    (no host sync), and the device batch is ``record_stream``-ed so its
    memory is not reused before the consumer's work is done. A staging
    buffer is written again only after its last copy has finished.
  * On the CPU the loader yields plain CPU tensors and pins nothing.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from os import path as osp
from typing import Callable, Iterator, Sequence

import numpy as np
import torch

from .. import native, resolve_device

__all__ = ["NUM_THREADS", "TileBatchLoader", "synthetic_tile_library"]

NUM_THREADS = 8  # decode threads of a loader


def _shard_files(files: list, epoch_seed, rank: int, world_size: int, shuffle: bool) -> list:
    files = list(files)
    if shuffle:
        rng = np.random.default_rng(epoch_seed)
        order = rng.permutation(len(files))
        files = [files[i] for i in order]
    if world_size > 1:
        # DistributedSampler parity: pad to a multiple of the world size, stride.
        pad = (-len(files)) % world_size
        files = files + files[:pad]
        files = files[rank::world_size]
    return files


class TileBatchLoader:
    """Iterates uint8 batches of tiles from a file list, on ``device``.

    Args:
      root: directory the manifest paths are relative to.
      files: relative image paths, or tuples of them ((img, mask) pairs);
        a batch of tuples is a tuple of batches.
      batch_size: this rank's batch size.
      load_fn: file record -> numpy array (or tuple of arrays); default:
        the native decoder, one batch per call.
      drop_last: drop the trailing partial batch (the reference's pretrain
        loader does, ``ssl_train.py:274``).
      pad_last: with ``drop_last=False``, wrap-pad the trailing batch to
        ``batch_size`` with the epoch's first files; :meth:`valid_mask`
        marks the real samples.
      rank, world_size: this process's shard of the files.
      device: where batches are delivered (``"cuda"`` by default; raises
        without a card unless given ``"cpu"``).
    """

    def __init__(
        self,
        root: str,
        files: Sequence,
        batch_size: int,
        *,
        load_fn: Callable | None = None,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        pad_last: bool = False,
        num_threads: int = NUM_THREADS,
        prefetch: int = 2,
        rank: int = 0,
        world_size: int = 1,
        device="cuda",
    ):
        if pad_last and drop_last:
            raise ValueError("pad_last requires drop_last=False (a dropped trailing batch "
                             "leaves nothing to wrap-pad)")
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} outside world size {world_size}")
        self.root = root
        self.files = list(files)
        self.batch_size = batch_size
        self.load_fn = load_fn
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.pad_last = pad_last
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.rank = rank
        self.world_size = world_size
        self.device = resolve_device(device)

    def _local_count(self) -> int:
        n = len(self.files)
        return -(-n // self.world_size) if self.world_size > 1 else n

    def __len__(self):
        """Batches per epoch on this rank: the count :meth:`epoch` yields."""
        n_local = self._local_count()
        n = n_local // self.batch_size
        if not self.drop_last and n_local % self.batch_size:
            n += 1
        return n

    def last_batch_valid(self) -> int:
        """Real (non-padded) samples in this rank's final batch of an epoch
        (``batch_size`` when the list divides evenly; DistributedSampler's
        duplicate pads count as real, as in the reference)."""
        rem = self._local_count() % self.batch_size
        return rem if (rem and not self.drop_last) else self.batch_size

    def last_batch_valid_mask(self) -> torch.Tensor:
        """(batch_size,) bool mask on the device, False on the wrap-padded
        suffix of the epoch's final batch (requires ``pad_last``)."""
        if not self.pad_last:
            raise ValueError("last_batch_valid_mask requires pad_last (without it the "
                             "trailing batch is genuinely short: no mask needed)")
        return torch.arange(self.batch_size, device=self.device) < self.last_batch_valid()

    def valid_mask(self, batch_index: int) -> torch.Tensor:
        """(batch_size,) bool mask on the device for epoch batch
        ``batch_index``: all True except the final batch's wrap-pads."""
        if batch_index == len(self) - 1:
            return self.last_batch_valid_mask()
        return torch.ones(self.batch_size, dtype=torch.bool, device=self.device)

    def _batches(self, files):
        n = len(files)
        stop = n - n % self.batch_size if self.drop_last else n
        for i in range(0, stop - stop % self.batch_size, self.batch_size):
            yield files[i : i + self.batch_size]
        rem = stop % self.batch_size
        if rem:
            tail = files[stop - rem :]
            if self.pad_last:
                need = self.batch_size - rem
                tail = tail + (files * (need // max(1, len(files)) + 1))[:need]
            yield tail

    def _shapes(self, rec) -> list[tuple]:
        """Each part's array shape, from the first record."""
        if self.load_fn is not None:
            out = self.load_fn(rec)
            return [a.shape for a in (out if isinstance(out, tuple) else (out,))]
        recs = rec if isinstance(rec, (tuple, list)) else (rec,)
        shapes = []
        for r in recs:
            h, w, c = native.probe(osp.join(self.root, r))
            shapes.append((h, w) if c == 1 else (h, w, c))
        return shapes

    def _fill(self, batch_files, outs, pool):
        """Decode one batch into ``outs`` (one uint8 array per part)."""
        if self.load_fn is None:
            for j, out in enumerate(outs):
                paths = [osp.join(self.root, rec[j] if isinstance(rec, (tuple, list)) else rec)
                         for rec in batch_files]
                shape = out.shape[1:]
                native.decode_batch(paths, shape[0], shape[1], 1 if len(shape) == 2 else shape[2],
                                    self.num_threads, out=out)
            return

        def put(j_rec):
            j, rec = j_rec
            arrays = self.load_fn(rec)
            for out, a in zip(outs, arrays if isinstance(arrays, tuple) else (arrays,)):
                out[j] = a

        for _ in pool.map(put, enumerate(batch_files)):
            pass

    def epoch(self, epoch: int = 0) -> Iterator:
        """Yield one epoch of batches on the device: a uint8 tensor, or a
        tuple of them for tuple records.

        A background thread decodes ahead of the consumer (``prefetch``
        batches). Breaking out of the loop ends and joins that thread; an
        error in it is raised here once the epoch's batches are consumed.
        """
        files = _shard_files(
            self.files,
            epoch_seed=np.random.SeedSequence([self.seed & 0x7FFFFFFF, epoch]),
            rank=self.rank, world_size=self.world_size, shuffle=self.shuffle,
        )
        cuda = self.device.type == "cuda"
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()
        errors: list[BaseException] = []
        abandoned = threading.Event()

        def _put(item) -> bool:
            while not abandoned.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_threads) as pool:
                    if cuda:
                        _produce_cuda(pool)
                    else:
                        shapes = None
                        for batch_files in self._batches(files):
                            shapes = shapes or self._shapes(batch_files[0])
                            outs = [np.empty((len(batch_files), *s), np.uint8) for s in shapes]
                            self._fill(batch_files, outs, pool)
                            if not _put([torch.from_numpy(o) for o in outs]):
                                return
            except Exception as e:  # raised in the consumer, never a hang
                errors.append(e)
            finally:
                _put(stop)

        def _produce_cuda(pool):
            with torch.cuda.device(self.device):
                side = torch.cuda.Stream()
                shapes = None
                ring: list = []  # per slot: (pinned tensors, event of its last copy)
                for i, batch_files in enumerate(self._batches(files)):
                    if shapes is None:
                        shapes = self._shapes(batch_files[0])
                        ring = [([torch.empty((self.batch_size, *s), dtype=torch.uint8,
                                              pin_memory=True) for s in shapes], None)
                                for _ in range(self.prefetch + 1)]
                    pinned, copied = ring[i % len(ring)]
                    if copied is not None:
                        copied.synchronize()  # the slot's last copy must be done
                    n = len(batch_files)
                    self._fill(batch_files, [p[:n].numpy() for p in pinned], pool)
                    with torch.cuda.stream(side):
                        dev = [p[:n].to(self.device, non_blocking=True) for p in pinned]
                        done = torch.cuda.Event()
                        done.record(side)
                    ring[i % len(ring)] = (pinned, done)
                    if not _put((dev, done)):
                        return

        thread = threading.Thread(target=produce, daemon=True, name="TileBatchLoader")
        thread.start()
        completed = False
        try:
            while True:
                item = q.get()
                if item is stop:
                    completed = True
                    break
                if cuda:
                    item, done = item
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(done)
                    for t in item:
                        t.record_stream(stream)
                yield item[0] if len(item) == 1 else tuple(item)
        finally:
            abandoned.set()
            thread.join()
            # Raise background failures only on an epoch consumed to its end;
            # an abandoned generator (GeneratorExit) closes quietly.
            if errors and completed:
                raise errors[0]


def synthetic_tile_library(
    n_slides: int = 4,
    tiles_per_slide: int = 8,
    tile_size: int = 1024,
    num_classes: int = 5,
    seed: int = 0,
):
    """In-memory synthetic tile corpus mirroring the prep output: smooth
    colour fields + blobby masks, for smoke tests and benchmarks."""
    rng = np.random.default_rng(seed)
    imgs, masks, slide_ids = [], [], []
    for s in range(n_slides):
        for t in range(tiles_per_slide):
            yy, xx = np.mgrid[0:tile_size, 0:tile_size]
            freq = rng.uniform(1, 4, size=(2, 3))
            phase = rng.uniform(0, 2 * np.pi, size=3)
            img = np.stack(
                [
                    127
                    + 120
                    * np.sin(
                        freq[0, c] * np.pi * yy / tile_size
                        + freq[1, c] * np.pi * xx / tile_size
                        + phase[c]
                    )
                    for c in range(3)
                ],
                axis=-1,
            ).astype(np.uint8)
            cy, cx = rng.integers(0, tile_size, 2)
            r = rng.integers(tile_size // 8, tile_size // 2)
            blob = ((yy - cy) ** 2 + (xx - cx) ** 2) < r**2
            mask = np.zeros((tile_size, tile_size), np.uint8)
            cls = int(rng.integers(1, num_classes + 1))
            mask[blob] = cls
            # Tint the blob with a class-specific colour so the labels are
            # learnable from pixels.
            tint = np.array(
                [
                    64 + (191 * cls) % 192,
                    64 + (113 * cls) % 192,
                    64 + (53 * cls) % 192,
                ],
                np.int32,
            )
            img = img.astype(np.int32)
            img[blob] = (img[blob] + 2 * tint) // 3
            img = img.astype(np.uint8)
            imgs.append(img)
            masks.append(mask)
            slide_ids.append(s)
    return np.stack(imgs), np.stack(masks), np.asarray(slide_ids)
