"""Shared helpers of the parity tests between the JAX package and the
PyTorch port (``tests/test_torch_*.py``).

Randomness is matched by parameters: :func:`jax_view_params` draws every
view parameter with the JAX package's own samplers, under exactly the key
tree of ``msfwsi_tpu/data/pipeline.py`` (``make_ssl_views`` ->
``_context_view`` / ``_target_view`` -> ``augment``), and returns them in
the structure of ``msfwsi_tpu_torch.data.pipeline.sample_ssl_views``.
"""

from __future__ import annotations

import functools
import importlib.util
import sys
from pathlib import Path

import jax
import numpy as np
import torch

from msfwsi_tpu.ops import augment as JA

_BLUR_LIMIT, _SIGMA_LIMIT = (19, 23), (0.1, 2.0)


def t(x) -> torch.Tensor:
    """numpy / JAX array -> CPU torch tensor (float64 stays float64)."""
    return torch.from_numpy(np.array(x))


def to_torch(tree):
    """A pytree of JAX arrays -> the same structure of CPU torch tensors."""
    return jax.tree.map(t, tree)


def blur_or_sharpen_draws(key, B: int, dtype):
    """JAX ``blur_or_sharpen``'s draws under ``key``, as port parameters."""
    k_apply, k_pick, k_blur, k_sharp = jax.random.split(key, 4)
    kmax = JA._blur_kmax(dtype, _BLUR_LIMIT, _SIGMA_LIMIT)
    return {
        "apply": jax.random.uniform(k_apply, (B, 1, 1, 1)) < 0.5,
        "pick_blur": jax.random.uniform(k_pick, (B, 1, 1, 1)) < 0.5,
        "taps": JA._blur_taps(k_blur, B, _BLUR_LIMIT, _SIGMA_LIMIT, kmax),
        "sharp": JA._sharpen_kern(k_sharp, B),
    }


def _context_draws(key, B: int, src_hw, cfg):
    k = jax.random.split(key, 5)
    return {
        "flip": jax.random.uniform(k[4], (B,)) < 0.5,
        "boxes": JA.sample_rrc_boxes(k[0], B, src_hw, cfg.rrc_scale),
        "jitter": JA._sample_jitter_params(k[1], B, JA.ColorJitterConfig(), cfg.dtype),
        "gray": jax.random.uniform(k[2], (B, 1, 1, 1)) < 0.2,
        "blur_or_sharpen": blur_or_sharpen_draws(k[3], B, cfg.dtype),
    }


def _target_draws(key, B: int, cfg):
    K = cfg.grid**2
    k = jax.random.split(key, 6)
    return {
        "jitter": JA._sample_jitter_params(k[0], B, JA.ColorJitterConfig(), cfg.dtype),
        "gray": jax.random.uniform(k[1], (B, 1, 1, 1)) < 0.2,
        "blur_or_sharpen": blur_or_sharpen_draws(k[2], B, cfg.dtype),
        "perm": jax.vmap(lambda kk: jax.random.permutation(kk, K))(jax.random.split(k[3], B)),
        "boxes": JA.sample_rrc_boxes(k[4], B * K, (cfg.tile_px, cfg.tile_px), cfg.rrc_scale),
        "flip": jax.random.uniform(k[5], (B * K,)) < 0.5,
    }


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def view_draws(key, B: int, src_hw, cfg):
    """All four views' draws of JAX ``make_ssl_views(key, ...)``, as JAX
    arrays (``jax_view_params`` converts them)."""
    kc1, kc2, kt1, kt2 = jax.random.split(key, 4)
    return {
        "context1": _context_draws(kc1, B, src_hw, cfg),
        "context2": _context_draws(kc2, B, src_hw, cfg),
        "target1": _target_draws(kt1, B, cfg),
        "target2": _target_draws(kt2, B, cfg),
    }


def jax_view_params(key, B: int, src_hw, cfg):
    """All four views' parameters of JAX ``make_ssl_views(key, ...)``;
    ``cfg`` is the JAX package's ``AugConfig``."""
    return to_torch(view_draws(key, B, tuple(src_hw), cfg))


def port_aug_config(cfg):
    """The port's AugConfig with the fields of a JAX ``AugConfig``."""
    from msfwsi_tpu_torch.data.pipeline import AugConfig

    return AugConfig(mean=tuple(cfg.mean), std=tuple(cfg.std), img_size=cfg.img_size,
                     grid=cfg.grid, tile_px=cfg.tile_px, rrc_scale=tuple(cfg.rrc_scale),
                     compute_dtype=cfg.compute_dtype)


def numpy_tree(tree):
    """A JAX variables pytree as nested dicts of numpy arrays."""
    return jax.tree.map(np.asarray, dict(tree))


def seg_view_draws(key, B: int, dtype):
    """JAX ``make_seg_train_views(key, ...)``'s draws (``split(key)`` into
    the jitter key and the flip key), as the port's parameters."""
    k_cj, k_flip = jax.random.split(key)
    flip = jax.random.uniform(k_flip, (B, 1, 1, 1)) < 0.5
    jitter = JA._sample_jitter_params(k_cj, B, JA.ColorJitterConfig(), dtype)
    return {"flip": t(flip[:, 0, 0, 0]), "jitter": [t(p) for p in jitter]}


def state_numpy(module) -> dict:
    """A module's state dict as numpy copies: a ``Tensor.numpy()`` view
    would let a later in-place update of the module (a train-mode
    BatchNorm's running stats) reach a JAX computation still reading the
    buffer asynchronously."""
    return {k: w.detach().numpy().copy() for k, w in module.state_dict().items()}


def jax_tool(name: str):
    """The JAX package's CLI module ``tools/<name>.py``, imported from its
    file (``tools/`` put on ``sys.path`` for its ``_common`` imports)."""
    tools = Path(__file__).resolve().parents[1] / "tools"
    if str(tools) not in sys.path:
        sys.path.insert(0, str(tools))
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", tools / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ssl_random_views(B: int, scale: int, size: int, seed: int) -> dict:
    """An SSL batch of random-normal views as numpy arrays, drawn as
    ``tests/test_factored.py::random_batch`` draws it (spatial target keys,
    the inverse jigsaw permutations as ``rev1``/``rev2``)."""
    rng = np.random.default_rng(seed)
    K = scale**2
    rev = np.stack([rng.permutation(K) for _ in range(B)])
    views = {k: rng.normal(size=(n, size, size, 3)).astype(np.float32)
             for k, n in (("context1", B), ("context2", B), ("target1_spatial", B * K),
                          ("target2_spatial", B * K))}
    return {**views, "rev1": np.argsort(rev, axis=1), "rev2": np.argsort(rev, axis=1)}


def jax_suite_distances(model, jstate, lr: float, bf16: bool, adafactor_heads: bool) -> dict:
    """Each parameter of the port's MSFWSI ``model`` against the JAX train
    state's, under ``tests/test_factored.py``'s bounds: every element within
    2.5 lr (4x that with bf16 heads) and at most max(2, 0.5%) of a tensor's
    elements outside ``tol + tol * |ref|`` (tol 5e-5, or 1e-2 with bf16
    heads) where the parameters take Adafactor (the fuser heads, with
    ``adafactor_heads``). The others take Adam, whose
    first step moves a weight by lr times its gradient's sign, so there a
    gradient near 0 that changes sign between the two implementations moves
    an element by 2 lr: there the count is ``tests/test_torch_ssl.py``'s
    for Adam across the two implementations, 5% of a tensor (the JAX suite
    compares two runs of one forward, where no gradient changes sign).
    Asserts them and returns the worst ``max|d| / lr`` and loose fraction
    of each kind, with their parameters."""
    from msfwsi_tpu_torch.train.checkpoint import jax_msfwsi_to_torch

    tol = 1e-2 if bf16 else 5e-5
    want = jax_msfwsi_to_torch(numpy_tree({"params": jstate.params,
                                           "batch_stats": jstate.batch_stats}))
    worst = {}
    for name, p in model.named_parameters():
        ref = want[name].numpy()
        d = np.abs(p.detach().float().numpy() - ref)
        loose = int((d > tol + tol * np.abs(ref)).sum())
        kind = "inter" if adafactor_heads and name.startswith("inter_") else "adam"
        assert d.max() <= 2.5 * lr * (4 if bf16 else 1), (name, float(d.max()) / lr)
        assert loose <= max(2, int((5e-3 if kind == "inter" else 5e-2) * d.size)), (
            name, loose, d.size)
        for key, v in (("max_d_over_lr", float(d.max()) / lr), ("loose_fraction", loose / d.size)):
            if v >= worst.get((kind, key), (0.0,))[0]:
                worst[(kind, key)] = (v, name)
    return worst


def _unmasked(tree):
    """A nested dict without optax's ``MaskedNode`` entries (the leaves a
    ``multi_transform`` group does not own)."""
    import optax

    if isinstance(tree, optax.MaskedNode):
        return None
    if hasattr(tree, "items"):
        out = {k: _unmasked(v) for k, v in tree.items()}
        return {k: v for k, v in out.items()
                if v is not None and not (isinstance(v, dict) and not v)}
    return np.asarray(tree)


def _opt_states(opt_state):
    """The Adam, Adafactor and fused-Adafactor states inside a JAX SSL
    optimizer state, by kind."""
    import optax
    from optax._src.factorized import FactoredState

    from msfwsi_tpu.train.factored import FacAdafactorState

    kinds = {optax.ScaleByAdamState: "adam", FactoredState: "adafactor",
             FacAdafactorState: "fused_adafactor"}
    found = jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: type(x) in kinds)
    return [(kinds[type(s)], s) for s in found if type(s) in kinds]


def load_jax_ssl_state(state, jstate) -> None:
    """Set the port's SSL train ``state`` to the JAX train state's: weights,
    BatchNorm statistics, and the optimizer's moments or factored statistics
    (the port's Adafactor keeps a torch weight's statistics along the
    weight's own axes, so a square weight's ``v_row`` is JAX's ``v_col``)."""
    from msfwsi_tpu_torch.train.checkpoint import jax_msfwsi_to_torch
    from msfwsi_tpu_torch.train.factored import factored_dims

    state.model.load_state_dict(jax_msfwsi_to_torch(numpy_tree(
        {"params": jstate.params, "batch_stats": jstate.batch_stats})))

    def port(tree):
        return jax_msfwsi_to_torch({"params": _unmasked(tree), "batch_stats": {}})

    names = {p: n for n, p in state.model.named_parameters()}
    sources = {}  # kind -> state key -> {port name: tensor}, the groups' states merged
    for kind, js in _opt_states(jstate.opt_state):
        fields = ({"exp_avg": js.mu, "exp_avg_sq": js.nu} if kind == "adam" else
                  {k: getattr(js, k) for k in ("v_row", "v_col", "v") if hasattr(js, k)})
        for key, tree in fields.items():
            sources.setdefault(kind, {}).setdefault(key, {}).update(port(tree))
    opt = state.optimizer
    for kind, port_opt in getattr(opt, "optimizers", {"adam": opt}).items():
        src = sources[kind]
        for group in port_opt.param_groups:
            for p in group["params"]:
                st, n = port_opt.state[p], names[p]
                keys = {k: k for k in src if k in st}
                dims = factored_dims(tuple(p.shape)) if kind == "adafactor" and st else None
                if dims is not None and dims[0] != 1 - factored_dims(tuple(p.shape)[::-1])[0]:
                    keys = {"v_row": "v_col", "v_col": "v_row"}  # another kept axis
                for mine, theirs in keys.items():
                    st[mine].copy_(src[theirs][n].reshape(st[mine].shape))


def jax_fused_factors(jstate) -> dict:
    """``{port weight name: {"v_row", "v_col"}}`` of the fused Adafactor's
    state in a JAX SSL train state (``v_row`` the input axis, ``v_col`` the
    output axis, as the port keeps them), as numpy arrays. Each kernel's
    port name comes from converting the whole state with every leaf filled
    with its own index."""
    from msfwsi_tpu_torch.train.checkpoint import jax_msfwsi_to_torch

    tree = numpy_tree({"params": jstate.params, "batch_stats": jstate.batch_stats})
    paths, treedef = jax.tree_util.tree_flatten_with_path(tree)
    ids = jax.tree_util.tree_unflatten(treedef, [np.full(np.shape(v), i, np.float32)
                                                 for i, (_, v) in enumerate(paths)])
    keys = [jax.tree_util.keystr(p) for p, _ in paths]
    name_of = {keys[int(t.reshape(-1)[0])]: n for n, t in jax_msfwsi_to_torch(ids).items()
               if not n.endswith("num_batches_tracked")}
    out = {}
    for kind, js in _opt_states(jstate.opt_state):
        if kind != "fused_adafactor":
            continue
        for key in ("v_row", "v_col"):
            for path, v in jax.tree_util.tree_flatten_with_path(_unmasked(getattr(js, key)))[0]:
                name = name_of["['params']" + jax.tree_util.keystr(path)]
                out.setdefault(name, {})[key] = np.asarray(v, np.float32)
    return out


def jax_ssl_state_from_port(jconfig, model):
    """A fresh JAX SSL train state for ``jconfig`` holding the port
    ``model``'s weights and BatchNorm statistics (through the JAX package's
    own converter, which spares the JAX init), its fuser-head Dense leaves
    cast to bf16 when ``jconfig.inter_dtype`` says so."""
    import jax.numpy as jnp

    from msfwsi_tpu.train import ssl as JS
    from msfwsi_tpu.train.checkpoint import torch_msfwsi_to_flax

    # copies: a view would let the port's in-place updates reach a JAX step
    # still reading the buffer asynchronously (see ``state_numpy``)
    v = torch_msfwsi_to_flax({k: w.detach().float().numpy().copy() for k, w in
                              model.state_dict().items()})
    bf16 = jconfig.inter_dtype == "bfloat16"

    def leaf(path, x):
        keys = [getattr(k, "key", str(k)) for k in path]
        dense = keys[0].startswith("inter_") and keys[-2].startswith("fc")
        return jnp.asarray(x, jnp.bfloat16 if bf16 and dense else jnp.float32)

    params = jax.tree_util.tree_map_with_path(leaf, v["params"])
    tx = JS.make_ssl_optimizer(jconfig)
    return JS.SSLTrainState(step=jnp.zeros((), jnp.int32), params=params,
                            batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]),
                            opt_state=tx.init(params), tx=tx, model=jconfig.build_model())


def ssl_steps_against_jax(jconfig, state, steps: int):
    """``steps`` train steps of the JAX package (``make_jitted_train_step``)
    and of the port
    on ``ssl_random_views`` batches of ``jconfig.batch_size`` (seeds 100,
    101, ...), each from equal
    states: before each step the port takes the JAX state
    (``load_jax_ssl_state``). Returns each step's ``(port loss, JAX loss)``,
    each step's ``jax_suite_distances`` and the final JAX state."""
    import jax.numpy as jnp

    from msfwsi_tpu.train import ssl as JS
    from msfwsi_tpu_torch.train import ssl as S

    jstate = jax_ssl_state_from_port(jconfig, state.model)
    jstep = JS.make_jitted_train_step(jconfig, donate=False)
    bf16 = jconfig.inter_dtype == "bfloat16"
    losses, worst = [], []
    for i in range(steps):
        load_jax_ssl_state(state, jstate)
        views = ssl_random_views(jconfig.batch_size, jconfig.scale, jconfig.img_size, 100 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in views.items()})
        m = S.ssl_train_step(state, {k: torch.from_numpy(v) for k, v in views.items()},
                             tuple(jconfig.fuser_weights), accum_steps=jconfig.accum_steps)
        losses.append((float(m["loss"]), float(jm["loss"])))
        worst.append(jax_suite_distances(state.model, jstate, jconfig.init_lr, bf16,
                                         jconfig.inter_opt != "adam"))
    return losses, worst, jstate
