"""The ``("data", "model")`` layout of ranks, process-group bring-up and the
collectives the distributed paths use (port of ``msfwsi_tpu/parallel/mesh.py``).

One process drives one device. The world's ranks are laid out as a
``data x model`` grid, row-major: adjacent ranks share a ``"model"`` group
(the fuser-head shards, whose collectives move activations every layer),
and ranks ``m, m + model, m + 2*model, ...`` share a ``"data"`` group (the
batch split; BatchNorm statistics and gradients are reduced over it).

Where JAX lets GSPMD insert the collectives, the port calls them itself,
through ``torch.distributed`` (NCCL on the card, gloo on the CPU):

  * :func:`all_reduce_sum` / :func:`all_reduce_mean` are differentiable:
    their backward all-reduces the incoming gradient, as JAX's ``psum`` /
    ``pmean`` transpose, so a BatchNorm or a Dice loss over the global batch
    gets the cross-rank terms of its gradient;
  * :func:`average_gradients` takes one mean of every gradient per step,
    after accumulation, in flat buckets;
  * :func:`gather_rows` concatenates a tensor's rows over a group.

Bring-up (:func:`plan_launch`, :func:`launch`) reads the reference's flags
with the reference's meaning (``ssl_train.py:62-71,135-141``), or
``torchrun``'s ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``, or uses a
process group the caller formed already.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import socket
from typing import Any, Callable, Iterable, Sequence

import torch
import torch.distributed as dist

__all__ = [
    "MeshSpec",
    "Mesh",
    "make_mesh",
    "DistPlan",
    "plan_launch",
    "launch",
    "all_reduce_sum",
    "all_reduce_mean",
    "gather_rows",
    "average_gradients",
    "take_rows",
    "rank_draws",
    "broadcast_object",
]

# Gradients are all-reduced in flat buckets of at most this many bytes.
BUCKET_BYTES = 64 << 20


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape; ``data=-1`` means "all remaining ranks"."""

    data: int = -1
    model: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int]:
        model = self.model
        if model < 1:
            raise ValueError(f"model axis size must be >= 1, got {model}")
        data = self.data if self.data != -1 else n_devices // model
        if data < 1 or data * model != n_devices:
            raise ValueError(f"mesh {data}x{model} does not cover {n_devices} devices")
        return data, model


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the ``data x model`` grid and the two groups it
    belongs to. A group is None where its axis has size 1: collectives over
    it are skipped."""

    data: int
    model: int
    rank: int
    data_group: Any = None
    model_group: Any = None
    world_group: Any = None

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def make_mesh(spec: MeshSpec | None = None) -> Mesh:
    """The mesh of the current process group (a world of 1 when none is
    initialized). Every rank must call it, in the same order as its other
    group creations: it makes the ``"data"`` and ``"model"`` groups."""
    spec = spec or MeshSpec()
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    data, model = spec.resolve(world)
    if world == 1:
        return Mesh(1, 1, 0)
    whole = dist.group.WORLD

    def groups(members: Sequence[Sequence[int]]):
        if len(members[0]) == 1:
            return None
        if len(members[0]) == world:
            return whole
        mine = None
        for ranks in members:  # every rank creates every group, in order
            g = dist.new_group(list(ranks))
            if rank in ranks:
                mine = g
        return mine

    model_groups = [range(d * model, (d + 1) * model) for d in range(data)]
    data_groups = [range(m, world, model) for m in range(model)]
    return Mesh(data, model, rank, data_group=groups(data_groups),
                model_group=groups(model_groups), world_group=whole)


# ---------------------------------------------------------------- bring-up


@dataclasses.dataclass(frozen=True)
class DistPlan:
    """How this run forms its process group. ``nprocs`` > 1: spawn that many
    workers on this node, worker ``i`` taking rank ``rank + i``; else this
    process is rank ``rank``. ``existing``: a group is already formed (by the
    caller); it is used as it is and left alone at the end."""

    world: int
    rank: int
    nprocs: int
    init_method: str
    backend: str
    existing: bool = False


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _backend(device: torch.device, requested: str | None) -> str:
    """``nccl`` on the card and ``gloo`` on the CPU; an explicit request
    for another is honoured, except ``nccl`` for CPU tensors, which it
    cannot move."""
    default = "nccl" if device.type == "cuda" else "gloo"
    if requested is None:
        return default
    if requested == "nccl" and device.type != "cuda":
        raise ValueError("--dist-backend nccl needs --device cuda; a CPU run uses gloo")
    return requested


def plan_launch(device: torch.device, *, world_size: int = -1, rank: int = -1,
                dist_url: str = "", dist_backend: str | None = None,
                multiprocessing_distributed: bool = False,
                environ=None) -> DistPlan | None:
    """The process group a run asks for, or None for a plain single process.

      * a group the caller already formed is used as it is;
      * ``torchrun``'s ``RANK`` / ``WORLD_SIZE`` (``LOCAL_RANK`` picks the
        card), rendezvous ``env://`` unless ``dist_url`` is given; they
        take precedence over the flags below, so a recipe's flags run
        under ``torchrun`` as they are;
      * ``multiprocessing_distributed``: ``world_size`` counts nodes and
        ``rank`` is this node's; one worker is spawned per visible card (on
        ``--device cpu``, where there is no card to count, ``world_size``
        workers on this host), so the world is ``world_size * nprocs``;
      * else ``world_size`` > 1: this process is rank ``rank`` of
        ``world_size``, each started by the user (``--dist-url`` needed).

    ``dist_url`` empty on one node: a free ``tcp://localhost`` port.
    ``dist_backend`` None: ``nccl`` on the card, ``gloo`` on the CPU."""
    env = os.environ if environ is None else environ
    if dist.is_available() and dist.is_initialized():
        return DistPlan(dist.get_world_size(), dist.get_rank(), 1, "", dist.get_backend(),
                        existing=True)
    if "RANK" in env and "WORLD_SIZE" in env:
        return DistPlan(int(env["WORLD_SIZE"]), int(env["RANK"]), 1, dist_url or "env://",
                        _backend(device, dist_backend))
    if multiprocessing_distributed:
        nodes = max(world_size, 1)
        if device.type == "cuda":
            nprocs = torch.cuda.device_count()
        else:
            nprocs, nodes = nodes, 1
        if nprocs < 1:
            raise RuntimeError("--multiprocessing-distributed found no card to spawn a worker on")
        node = max(rank, 0)
        if not dist_url:
            if nodes > 1:
                raise ValueError(f"--world-size {nodes} nodes need --dist-url (the rendezvous "
                                 "of rank 0's node)")
            dist_url = f"tcp://localhost:{_free_port()}"
        return DistPlan(nodes * nprocs, node * nprocs, nprocs, dist_url,
                        _backend(device, dist_backend))
    if world_size > 1:
        if rank < 0 or rank >= world_size:
            raise ValueError(f"--world-size {world_size} needs --rank in [0, {world_size})")
        if not dist_url:
            raise ValueError(f"--world-size {world_size} without --multiprocessing-distributed "
                             "needs --dist-url (the rendezvous every rank reaches)")
        return DistPlan(world_size, rank, 1, dist_url, _backend(device, dist_backend))
    return None


def _worker_device(device: torch.device, local_rank: int) -> torch.device:
    if device.type != "cuda":
        return device
    dev = torch.device("cuda", local_rank)
    torch.cuda.set_device(dev)
    return dev


@contextlib.contextmanager
def process_group(plan: DistPlan, rank: int, device: torch.device):
    """Form the group of ``plan`` as ``rank`` (a failure raises; there is no
    fallback to a world of 1) and destroy it on exit, unless it existed."""
    if plan.existing:
        yield
        return
    dist.init_process_group(plan.backend, init_method=plan.init_method,
                            world_size=plan.world, rank=rank)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _spawned(local_rank: int, plan: DistPlan, device: torch.device, fn: Callable, args):
    rank = plan.rank + local_rank
    dev = _worker_device(device, local_rank)
    with process_group(plan, rank, dev):
        fn(*args, dev)


def launch(plan: DistPlan | None, device: torch.device, fn: Callable, *args):
    """Run ``fn(*args, device)`` under ``plan``: in this process (no plan,
    an existing group, or one worker here), or in ``plan.nprocs`` spawned
    workers, each on its card (``LOCAL_RANK`` or the worker index picks
    it). Returns ``fn``'s result in this process, None after a spawn."""
    if plan is None:
        return fn(*args, device)
    if plan.nprocs > 1:
        import torch.multiprocessing as mp

        mp.spawn(_spawned, args=(plan, device, fn, args), nprocs=plan.nprocs, join=True)
        return None
    dev = device if plan.existing else _worker_device(device, int(os.environ.get("LOCAL_RANK", 0)))
    with process_group(plan, plan.rank, dev):
        return fn(*args, dev)


def broadcast_object(obj, src: int = 0):
    """``obj`` of rank ``src`` on every rank (itself without a group)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


# ------------------------------------------------------------- collectives


def _group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


class _AllReduceSum(torch.autograd.Function):
    """Sum over ``group``; the backward sums the incoming gradients over the
    group in turn (the transpose of a sum that every rank reads)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.contiguous().clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``group`` (``x`` itself for None)."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


def all_reduce_mean(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable mean of ``x`` over ``group``, JAX's ``pmean``."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group) / _group_size(group)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in rank order (equal
    shapes on every rank); no gradient."""
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(_group_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def _buckets(tensors: Iterable[torch.Tensor]):
    bucket, size = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if bucket and (size + nbytes > BUCKET_BYTES or t.dtype != bucket[0].dtype):
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += nbytes
    if bucket:
        yield bucket


def average_gradients(params: Iterable[torch.nn.Parameter], group) -> None:
    """Replace every ``.grad`` of ``params`` by its mean over ``group``: one
    all-reduce per flat bucket (a bucket holds one dtype). Parameters
    without a gradient (the fused Adafactor's, whose factors the optimizer
    gathers itself) are left out."""
    if group is None:
        return
    n = _group_size(group)
    grads = sorted((p.grad for p in params if p.grad is not None), key=lambda g: str(g.dtype))
    for bucket in _buckets(grads):
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        off = 0
        for g in bucket:
            g.copy_(flat[off : off + g.numel()].view_as(g))
            off += g.numel()


def take_rows(tree, batch: int, lo: int, hi: int):
    """Rows ``[lo, hi)`` of the samples of a nested dict / list / tuple of
    tensors whose leading axes are ``batch`` or sample-major ``m * batch``
    (view parameters: per sample, or per target tile)."""
    if isinstance(tree, dict):
        return {k: take_rows(v, batch, lo, hi) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(take_rows(v, batch, lo, hi) for v in tree)
    m = tree.shape[0] // batch
    if m * batch != tree.shape[0]:
        raise ValueError(f"leading axis {tree.shape[0]} is not a multiple of the batch {batch}")
    return tree[lo * m : hi * m]


def rank_draws(mesh: Mesh | None, n: int, params, draw: Callable):
    """This data rank's rows of a global batch's random draws: ``params``
    given for the global batch of ``n * ranks`` samples, or drawn by
    ``draw(n * ranks)``, cut to the rank's ``n`` contiguous rows. Every
    rank draws the same global parameters, so a world-N step sees the
    views of one process's. Without data ranks, ``params`` as given (None:
    the caller draws for its ``n``)."""
    if mesh is None or mesh.data == 1:
        return params
    total = n * mesh.data
    if params is None:
        params = draw(total)
    return take_rows(params, total, mesh.data_rank * n, (mesh.data_rank + 1) * n)
