"""Multi-process harness of the port's distributed tests
(``tests/test_torch_distributed.py``, ``test_torch_tp.py``,
``test_torch_dist_cli.py``).

:func:`run_world` runs ``fn(rank, *args)`` in ``world`` spawned processes
over gloo on the CPU, rendezvous through a ``file://`` store in the test's
``tmp_path`` (no TCP port, so parallel test workers cannot collide), one
thread each, and returns each rank's result. Every join has a timeout: a
hang fails the test and its processes are killed. The workers below import
the port alone (never JAX), so a spawned process starts fast.
"""

from __future__ import annotations

import hashlib
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as mp

TIMEOUT = 300.0  # seconds a join may take; a hang fails the test, its ranks killed


def _entry(rank: int, world: int, init: str, out: str, fn, args):
    torch.set_num_threads(1)
    import torch.distributed as dist

    try:
        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
        try:
            result = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        torch.save(result, f"{out}/rank{rank}.pt")
    except BaseException:  # noqa: BLE001 — recorded for the parent, then re-raised
        Path(f"{out}/rank{rank}.err").write_text(traceback.format_exc())
        raise


def run_world(fn, world: int, tmp_path, *args, timeout: float = TIMEOUT) -> list:
    """``[fn(rank, *args) for rank in range(world)]``, each rank in its own
    process of a gloo group of ``world``."""
    out = Path(tmp_path) / f"world_{fn.__name__}"
    out.mkdir(parents=True)
    init = f"file://{out}/store"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(r, world, init, str(out), fn, args))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout)
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(10)
    errors = [(out / f"rank{r}.err").read_text() for r in range(world)
              if (out / f"rank{r}.err").exists()]
    assert not errors, "\n".join(errors)
    assert not hung, f"{len(hung)} of {world} ranks still running after {timeout} s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


# ------------------------------------------------------------------ workers


def cases(rank: int, calls: dict) -> dict:
    """Several workers in one world, in turn: ``{name: (fn, args)}`` ->
    ``{name: fn(rank, *args)}`` (one spawn pays the processes' start-up
    once). A barrier follows each, so a file that one writes (rank 0) is
    whole before the next reads it."""
    import torch.distributed as dist

    out = {}
    for name, (fn, args) in calls.items():
        out[name] = fn(rank, *args)
        dist.barrier()
    return out


def rows(tree, rank: int, world: int):
    """This rank's contiguous rows of a dict of global numpy batches (B or
    sample-major B*K leading axes), as tensors."""
    B = min(v.shape[0] for v in tree.values())
    n = B // world
    out = {}
    for k, v in tree.items():
        m = v.shape[0] // B
        out[k] = torch.from_numpy(np.ascontiguousarray(v[rank * n * m : (rank + 1) * n * m]))
    return out


def digests(tensors: dict) -> dict:
    """``{key: (shape, sha1 of the bytes)}``: bit-equality and shapes of a
    rank's tensors without sending them back."""
    return {k: (tuple(v.shape), hashlib.sha1(v.detach().reshape(-1).contiguous()
                                             .view(torch.uint8).numpy().tobytes()).hexdigest())
            for k, v in tensors.items()}


def ssl_steps(rank: int, config_kwargs: dict, batches: list, model_parallel: int = 1,
              resume_from: str | None = None, save_dir: str | None = None):
    """Train steps of the port's SSL state under ``MeshSpec(model=
    model_parallel)`` on this rank's rows of each global views batch.
    Returns the losses, the gathered full state dict (rank 0), the
    :func:`digests` of this rank's state dict and optimizer state, and
    the checkpoint path."""
    from msfwsi_tpu_torch.parallel import tp
    from msfwsi_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from msfwsi_tpu_torch.train import checkpoint as C
    from msfwsi_tpu_torch.train import ssl as S

    mesh = make_mesh(MeshSpec(model=model_parallel))
    config = S.SSLConfig(**config_kwargs)
    state = S.create_ssl_state(config, device="cpu", mesh=mesh)
    if resume_from:
        C.restore_checkpoint(resume_from, state, "cpu")
    fw = tuple(config.fuser_weights)
    losses = []
    for views in batches:
        local = rows(views, mesh.data_rank, mesh.data)
        m = S.ssl_train_step(state, local, fw, accum_steps=config.accum_steps)
        losses.append({k: float(v) for k, v in m.items()})
    path = C.save_checkpoint(save_dir, state, 0, config.arch) if save_dir else None
    full = tp.full_state_dict(state.model)
    factors = factor_stats(state)
    sd = state.optimizer.state_dict()
    subs = {"": sd} if "state" in sd else {f"{k}/": v for k, v in sd.items()}
    opt = {f"{name}{i}" if name else i: digests({k: v for k, v in st.items() if torch.is_tensor(v)})
           for name, sub in subs.items() for i, st in sub["state"].items()}
    return {"losses": losses, "full": full if rank == 0 else None,
            "factors": factors if rank == 0 else None,
            "local": digests(state.model.state_dict()), "opt": opt,
            "path": path, "step": state.step}


def factor_stats(state) -> dict:
    """``{weight name: {"v_row", "v_col"}}`` of the fused Adafactor's state
    (empty without one), a split weight's factors gathered over the model
    group (a collective: every rank calls it)."""
    from msfwsi_tpu_torch.parallel import tp

    fused = getattr(state.optimizer, "optimizers", {}).get("fused_adafactor")
    if fused is None:
        return {}
    sd = tp.gather_optimizer_state(state.optimizer, state.model)["fused_adafactor"]
    names = {p: n for n, p in state.model.named_parameters()}
    params = [p for g in fused.param_groups for p in g["params"]]
    return {names[params[int(i)]]: {k: st[k].float() for k in ("v_row", "v_col")}
            for i, st in sd["state"].items()}


def fused_ssl_steps(rank: int, config_kwargs: dict, aug_kwargs: dict, tiles: np.ndarray,
                    seed: int, world: int):
    """One fused step (on-device views from a generator seeded ``seed``) on
    this rank's rows of the global uint8 ``tiles``; with ``world`` 1 the
    single-process step on all of them. Returns the loss and the state."""
    from msfwsi_tpu_torch.data.pipeline import AugConfig
    from msfwsi_tpu_torch.parallel.mesh import make_mesh
    from msfwsi_tpu_torch.train import ssl as S

    mesh = make_mesh() if world > 1 else None
    config = S.SSLConfig(**config_kwargs)
    state = S.create_ssl_state(config, device="cpu", mesh=mesh)
    step = S.make_fused_step(config, AugConfig(**aug_kwargs), device="cpu", mesh=mesh)
    n = tiles.shape[0] // world
    m = step(state, torch.from_numpy(tiles[rank * n : (rank + 1) * n]),
             torch.Generator().manual_seed(seed))
    sd = state.model.state_dict()
    return {"loss": float(m["loss"]), "state": sd if rank == 0 else None, "digests": digests(sd)}


def finetune_step(rank: int, config_kwargs: dict, seg_size: int, imgs, masks, valid,
                  view_params, world: int, keep_grads: bool = False):
    """One fused fine-tuning step on this rank's rows of the global batch
    (``valid`` its wrap-pad mask), the view parameters given for the
    global batch. Returns the metrics and the state dict, and with
    ``keep_grads`` the gradients the optimizer was given (after the mean
    over the ranks), by parameter name."""
    from msfwsi_tpu_torch.data.pipeline import AugConfig
    from msfwsi_tpu_torch.models.hooknet import build_hooknet
    from msfwsi_tpu_torch.parallel.mesh import make_mesh
    from msfwsi_tpu_torch.train import finetune as FT

    mesh = make_mesh() if world > 1 else None
    config = FT.FinetuneConfig(**config_kwargs)
    model = build_hooknet(torch.Generator().manual_seed(0), arch=config.arch,
                          classes=config.num_classes)
    state = FT.create_finetune_state(config, device="cpu", model=model, mesh=mesh)
    step = FT.make_fused_finetune_step(config, AugConfig(seg_size=seg_size), device="cpu",
                                       mesh=mesh)
    grads = {}
    if keep_grads:
        optimizer_step = state.optimizer.step

        def step_keeping_grads(*a, **kw):
            grads.update((n, p.grad.detach().clone())
                         for n, p in state.model.named_parameters() if p.grad is not None)
            return optimizer_step(*a, **kw)

        state.optimizer.step = step_keeping_grads
    n = imgs.shape[0] // world
    sl = slice(rank * n, (rank + 1) * n)
    m = step(state, torch.from_numpy(imgs[sl]), torch.from_numpy(masks[sl]),
             view_params=view_params, valid=torch.from_numpy(valid[sl]))
    sd = state.model.state_dict()
    return {"metrics": {k: v.clone() for k, v in m.items()},
            "state": sd if rank == 0 else None, "digests": digests(sd),
            "grads": grads if rank == 0 else None}


def cli(rank: int, module: str, argv: list, keys=("log_dir", "process_group", "start_epoch",
                                                   "summary", "slides", "out_dir", "tiles")):
    """``msfwsi_tpu_torch.<module>.main(argv)`` on this rank of the formed
    group; returns the small entries of its result (and of each epoch
    record), or the message of the ValueError it raised."""
    import importlib

    try:
        out = importlib.import_module(f"msfwsi_tpu_torch.{module}").main(argv)
    except ValueError as e:
        return {"error": str(e)}
    small = {k: out[k] for k in keys if k in out}
    if "epochs" in out:
        small["epochs"] = [{k: v for k, v in e.items() if not torch.is_tensor(v)}
                           for e in out["epochs"]]
    return small


def split_predictor(rank: int, seed: int = 0):
    """A ``Predictor(192, 3)`` split over the 2 ranks as the fuser heads
    are (its first ``Linear`` row-parallel: 3 outputs do not divide, 192
    inputs do; the second column-parallel) against the same head whole in
    this process: the output, the input's gradient and every parameter's
    (split ones gathered) for a fixed upstream gradient."""
    from torch import nn

    from msfwsi_tpu_torch.models.backbone import Predictor
    from msfwsi_tpu_torch.models.resnet import torch_style_init
    from msfwsi_tpu_torch.parallel import tp
    from msfwsi_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    gen = torch.Generator().manual_seed(seed)
    whole = torch_style_init(Predictor(192, 3), gen)
    holder = nn.Module()
    holder.inter_projector = nn.ModuleList()
    holder.inter_predictor = nn.ModuleList([Predictor(192, 3)])
    holder.inter_predictor[0].load_state_dict(whole.state_dict())
    tp.shard_msfwsi(holder, make_mesh(MeshSpec(model=2)))
    split = holder.inter_predictor[0]
    x = torch.randn(6, 192, generator=gen)
    w = torch.randn(6, 192, generator=gen)
    out = {}
    for name, head in (("whole", whole), ("split", split)):
        xi = x.clone().requires_grad_(True)
        y = head(xi)
        (y * w).sum().backward()
        shards = tp.named_shards(holder)
        grads = {k: (shards[f"inter_predictor.0.{k}"].gather(p.grad)
                     if name == "split" and f"inter_predictor.0.{k}" in shards else p.grad)
                 for k, p in head.named_parameters()}
        out[name] = {"y": y.detach(), "x_grad": xi.grad, "grads": grads}
    out["splits"] = {k: s.dim for k, s in tp.named_shards(holder).items()}
    return out
