"""The port's fine-tuning slice against the JAX package: the Dice loss and
its gradient (against both JAX forms), the smp metrics, the fused
fine-tuning step, the SSL checkpoint surgery, per-slide validation, the
``best_ft_model.pth.tar`` round trip, and the ``ssl_finetune`` CLI end to
end on the CPU (resnet10, 64 px views, 3 classes plus background)."""

import copy
import importlib.util
import re
import shlex
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from msfwsi_tpu.data import pipeline as JP
from msfwsi_tpu.models.hooknet import HookNet as JHookNet
from msfwsi_tpu.ops import losses as JL
from msfwsi_tpu.ops import metrics as JM
from msfwsi_tpu.ops import s2d
from msfwsi_tpu.train import evaluate as JEV
from msfwsi_tpu.train import finetune as JFT
from msfwsi_tpu.train.checkpoint import load_torch_file, torch_hooknet_to_flax
from msfwsi_tpu_torch import ssl_finetune, ssl_train
from msfwsi_tpu_torch.data import pipeline as P
from msfwsi_tpu_torch.diag.datapath import smooth_tiles, write_bcss_dataset, write_bcss_masks
from msfwsi_tpu_torch.models.hooknet import HookNet, build_hooknet
from msfwsi_tpu_torch.ops import losses as L
from msfwsi_tpu_torch.ops import metrics as M
from msfwsi_tpu_torch.train import checkpoint as C
from msfwsi_tpu_torch.train import evaluate as EV
from msfwsi_tpu_torch.train import finetune as FT
from msfwsi_tpu_torch.train import ssl as S
from msfwsi_tpu_torch.train.checkpoint import jax_hooknet_to_torch
from torch_parity import numpy_tree, seg_view_draws, state_numpy, t

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
B, SEG, NUM_FG = 4, 64, 3
ARCH = "resnet10"
CLASS_NAMES = ("a", "b", "c")


# ---- Dice -------------------------------------------------------------------

def _dice_inputs(seed=0):
    rng = np.random.default_rng(seed)
    logits = (2 * rng.normal(size=(B, 16, 16, NUM_FG + 1))).astype(np.float32)
    target = rng.integers(0, NUM_FG + 1, (B, 16, 16)).astype(np.int32)
    target[:, :, :] = np.where(target == 2, 1, target)  # class 2 absent: its term is 0
    return logits, target


@pytest.mark.parametrize("masked", [False, True], ids=["all", "sample_mask"])
def test_dice_loss_and_gradient_match_jax(masked):
    """The value against JAX's ``dice_loss`` and its packed custom-VJP form
    on space-to-depth logits, fp32 within 1e-6 (measured 1.5e-7), and the
    gradient against ``jax.grad`` of both within 1e-6 (measured 3.2e-10);
    with ``sample_mask`` the masked sample gets a zero gradient."""
    logits, target = _dice_inputs()
    mask = np.array([True, True, False, True]) if masked else None
    classes = list(range(1, NUM_FG + 1))
    jm = None if mask is None else jnp.asarray(mask)

    def jdice(z):
        return JL.dice_loss(z, jnp.asarray(target), classes=classes, sample_mask=jm)

    def jpacked(zp):
        return JL.dice_loss_packed(zp, jnp.asarray(target), classes=classes, sample_mask=jm)

    z = t(logits).requires_grad_(True)
    loss = L.dice_loss(z, t(target), classes=classes, sample_mask=None if mask is None else t(mask))
    loss.backward()
    packed = s2d.space_to_depth(jnp.asarray(logits))
    assert float(loss) == pytest.approx(float(jdice(jnp.asarray(logits))), abs=1e-6)
    assert float(loss) == pytest.approx(float(jpacked(packed)), abs=1e-6)
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(jax.grad(jdice)(jnp.asarray(logits))),
                               atol=1e-6)
    np.testing.assert_allclose(z.grad.numpy(),
                               np.asarray(s2d.depth_to_space(jax.grad(jpacked)(packed))),
                               atol=1e-6)
    if masked:
        assert float(z.grad[2].abs().max()) == 0.0
    # every class: background and the absent class included
    assert float(L.dice_loss(t(logits), t(target))) == pytest.approx(
        float(JL.dice_loss(jnp.asarray(logits), jnp.asarray(target))), abs=1e-6)


# ---- metrics ---------------------------------------------------------------

REDUCTIONS = ("micro", "micro-imagewise", "macro", "macro-imagewise", None)


def test_get_stats_and_scores_match_jax():
    """Counts exact, with ``ignore_index`` and predictions outside the class
    range; every reduction of F1 / IoU / accuracy within 1e-6 (measured 6.0e-8)."""
    rng = np.random.default_rng(1)
    pred = rng.integers(-1, NUM_FG + 1, (6, 32, 32))
    mask = rng.integers(-1, NUM_FG, (6, 32, 32))
    mask[0] = -1  # a fully ignored image
    for ignore in (None, -1):
        got = M.get_stats(t(pred), t(mask), NUM_FG, ignore_index=ignore)
        want = JM.get_stats(jnp.asarray(pred), jnp.asarray(mask), NUM_FG, ignore_index=ignore)
        for g, w in zip(got, want):
            assert g.dtype == torch.int64
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for fn in ("f1_score", "iou_score", "accuracy"):
        for red in REDUCTIONS:
            g = getattr(M, fn)(*got, reduction=red)
            w = getattr(JM, fn)(*want, reduction=red)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, err_msg=f"{fn} {red}")
    with pytest.raises(ValueError, match="reduction"):
        M.f1_score(*got, reduction="weighted")


def test_counts_past_two_to_the_24_are_summed_as_integers():
    """A slide of 300 tiles of 65536 pixels: tn sums past 2^24, where fp32
    stops counting exactly. The summed counts are exact int64 and the
    scores equal JAX's (which sums int32 first) within 1e-6 (measured 1.2e-7)."""
    rng = np.random.default_rng(2)
    tp = rng.integers(0, 3000, (300, NUM_FG))
    fp = rng.integers(0, 3000, (300, NUM_FG))
    fn = rng.integers(0, 3000, (300, NUM_FG))
    tn = 65536 - tp - fp - fn
    counts = (tp, fp, fn, tn)
    assert int(tn.sum()) > 2**24 and float(np.float32(tn.sum())) != float(tn.sum() + 1)
    for fn_name in ("f1_score", "iou_score", "accuracy"):
        for red in REDUCTIONS:
            g = getattr(M, fn_name)(*counts, reduction=red)
            w = getattr(JM, fn_name)(*(jnp.asarray(c, jnp.int32) for c in counts), reduction=red)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    acc = M.accuracy(*counts, reduction="micro")
    want = (tp.sum() + tn.sum()) / (tp.sum() + fp.sum() + fn.sum() + tn.sum())
    assert float(acc) == pytest.approx(float(np.float32(want)), abs=1e-7)


# ---- the fine-tuning step ----------------------------------------------------

def _model():
    return build_hooknet(torch.Generator().manual_seed(0), arch=ARCH, classes=NUM_FG + 1)


def _jax_state(jconfig, model):
    v = torch_hooknet_to_flax(state_numpy(model))
    params = jax.tree.map(jnp.asarray, v["params"])
    tx = optax.adam(jconfig.init_lr, b1=0.9, b2=0.999, eps=1e-8)
    return JFT.SegTrainState(step=jnp.zeros((), jnp.int32), params=params,
                             batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]),
                             opt_state=tx.init(params), tx=tx, model=jconfig.build_model())


def _tiles(seed, n=B, size=4 * SEG, classes=NUM_FG + 1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8),
            rng.integers(0, classes, (n, size, size), dtype=np.uint8))


@pytest.mark.parametrize("lam", [1.0, 0.5, 0.0])
def test_fused_finetune_step_matches_jax(lam):
    """One fp32 fused step (views from JAX's draws) from the same weights:
    the loss to a relative 1e-4 (measured 7.8e-8), the train counts exact,
    every running stat to rtol 1e-3 / atol 1e-5, and each weight within 2 lr
    of JAX's with at most 5% of a tensor outside rtol 1e-3 / atol 1e-5
    (``test_torch_ssl.py``'s bounds for Adam's first step, which moves a
    weight by lr times its gradient's sign). A branch whose loss term has
    weight 0 is left exactly as it was, as in JAX (lam 1: the context head;
    lam 0: the whole target branch)."""
    jconfig = JFT.FinetuneConfig(arch=ARCH, class_names=CLASS_NAMES, batch_size=B, amp=False,
                                 seg_size=SEG, lam=lam)
    config = FT.FinetuneConfig(arch=ARCH, class_names=CLASS_NAMES, batch_size=B, amp=False,
                               lam=lam)
    model = _model()
    init = copy.deepcopy(model.state_dict())
    jstate = _jax_state(jconfig, model)
    state = FT.create_finetune_state(config, device="cpu", model=model)
    imgs, masks = _tiles(lam != 1.0)
    key = jax.random.key(3)
    jstate, jm = JFT.make_jitted_fused_finetune_step(jconfig, JP.AugConfig(seg_size=SEG),
                                                     donate=False)(
        jstate, jnp.asarray(imgs), jnp.asarray(masks), key)
    step = FT.make_fused_finetune_step(config, P.AugConfig(seg_size=SEG), device="cpu")
    m = step(state, t(imgs), t(masks), view_params=seg_view_draws(key, B, jnp.float32))
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4)
    for k in ("tp", "fp", "fn", "tn"):
        assert tuple(m[k].shape) == (B, NUM_FG)
        np.testing.assert_array_equal(m[k].numpy(), np.asarray(jm[k]), err_msg=k)
    assert state.step == 1

    want = jax_hooknet_to_torch(numpy_tree({"params": jstate.params,
                                            "batch_stats": jstate.batch_stats}))
    got = state.model.state_dict()
    buffers = {n for n, _ in state.model.named_buffers()}
    lr = config.init_lr
    for k, w in want.items():
        close = np.isclose(got[k].numpy(), w.numpy(), rtol=1e-3, atol=1e-5)
        if k in buffers:
            assert close.all(), (k, float((got[k] - w).abs().max()))
        else:
            assert (~close).mean() <= 0.05, (k, float((~close).mean()))
            assert float((got[k] - w).abs().max()) <= 2 * lr + 1e-6, k
    frozen = ("context_branch.segmentation_head." if lam == 1.0
              else "target_branch." if lam == 0.0 else None)
    if frozen is not None:
        same = [k for k in got if k.startswith(frozen) and k not in buffers]
        assert same and all(torch.equal(got[k], init[k]) for k in same)
        assert all(torch.equal(got[k], want[k]) for k in same)


def test_step_takes_a_short_batch_and_a_valid_mask():
    """The trailing short batch of a single-device epoch (3 of 4) trains;
    a ``valid`` mask gives the loss of the real samples alone."""
    config = FT.FinetuneConfig(arch=ARCH, class_names=CLASS_NAMES, batch_size=B, amp=False)
    cfg = P.AugConfig(seg_size=SEG)
    state = FT.create_finetune_state(config, device="cpu", model=_model())
    imgs, masks = _tiles(4)
    step = FT.make_fused_finetune_step(config, cfg, device="cpu")
    m = step(state, t(imgs[:3]), t(masks[:3]), torch.Generator().manual_seed(0))
    assert np.isfinite(float(m["loss"])) and tuple(m["tp"].shape) == (3, NUM_FG)
    p = P.sample_seg_train_views(torch.Generator().manual_seed(1), B, cfg)
    (ctx, tgt), (cm, tm) = P.make_seg_train_views(t(imgs), t(masks), cfg, params=p)
    state.model.train()
    with torch.no_grad():
        _, logits = state.model(ctx, tgt)
        short = L.dice_loss(logits[:3], tm[:3], classes=[1, 2, 3])
        masked = L.dice_loss(logits, tm, classes=[1, 2, 3],
                             sample_mask=torch.tensor([True, True, True, False]))
    assert float(masked) == pytest.approx(float(short), abs=1e-6)
    m = step(state, t(imgs), t(masks), view_params=p, valid=torch.tensor([1, 1, 1, 0]).bool())
    assert "valid" in m and np.isfinite(float(m["loss"]))


def test_entry_points_need_a_gpu_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    config = FT.FinetuneConfig(arch=ARCH, class_names=CLASS_NAMES, batch_size=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FT.create_finetune_state(config)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FT.make_fused_finetune_step(config, P.AugConfig())
    stats = EV.make_chunk_stats_u8(_model(), NUM_FG)
    imgs, masks = _tiles(0, n=1, size=SEG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EV.validate_slide_u8(stats, imgs, masks, NUM_FG)


def test_config_lr_and_accum():
    config = FT.FinetuneConfig(batch_size=16, lr=1e-3)
    assert config.init_lr == pytest.approx(1e-3 * 0.5)
    assert config.num_classes == 6
    with pytest.raises(ValueError,
                       match=r"not ported yet, ROADMAP\.md queue 1, the large-model memory path"):
        FT.FinetuneConfig(accum_steps=2)


def _ssl_checkpoint(tmp_path, arch=ARCH):
    """An SSL checkpoint written by the port's CLI (one epoch, 2 steps)."""
    out = ssl_train.main(["--synthetic", "4", "-a", arch, "--scale", "2", "-i", "32",
                          "--tile-px", "32", "-b", "2", "--epochs", "1", "--save-freq", "1",
                          "--device", "cpu", "--imagenet-weights", "none",
                          "--log-dir", str(tmp_path / "ssl")])
    return Path(out["log_dir"]) / "checkpoint_0000.pth.tar", out["state"]


def test_load_ssl_encoders_from_a_port_checkpoint(tmp_path):
    """Both branch encoders equal the SSL run's encoders bit for bit,
    running stats included; the decoders keep their init; Adam is new."""
    path, ssl_state = _ssl_checkpoint(tmp_path)
    config = FT.FinetuneConfig(arch=ARCH, class_names=CLASS_NAMES, batch_size=2, amp=False)
    state = FT.create_finetune_state(config, device="cpu", model=_model())
    decoder = copy.deepcopy(state.model.target_branch.decoder.state_dict())
    old_opt = state.optimizer
    state = FT.load_ssl_encoders(state, C.load_torch_file(str(path)), config)
    for branch, enc in (("context_branch", "context_encoder"), ("target_branch", "target_encoder")):
        got = getattr(state.model, branch).encoder.state_dict()
        want = getattr(ssl_state.model, enc).state_dict()
        assert sorted(got) == sorted(want)
        assert all(torch.equal(got[k], want[k]) for k in want), branch
    assert all(torch.equal(v, decoder[k])
               for k, v in state.model.target_branch.decoder.state_dict().items())
    assert state.optimizer is not old_opt and not state.optimizer.state


# ---- validation -------------------------------------------------------------

def _slides():
    """Two slides of 3 and 130 raw 128 px tiles (130 crosses a chunk)."""
    out = []
    for seed, n in ((10, 3), (11, 130)):
        imgs, masks = _tiles(seed, n=n, size=2 * SEG)
        out.append((imgs, masks))
    return out


@pytest.fixture(scope="module")
def val_setup():
    model = _model()
    model.eval()
    v = torch_hooknet_to_flax(state_numpy(model))
    return model, jax.tree.map(jnp.asarray, v), _slides()


@pytest.mark.parametrize("val_views", ["host", "device"])
def test_validate_slides_matches_jax(val_setup, val_views, monkeypatch):
    """Per-slide scores (micro and per class) equal the JAX package's
    ``validate_slides`` on the same weights within 1e-6 (measured 0); host
    views from the port's numpy path (JAX made to take its own numpy path
    too)."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    model, variables, slides = val_setup
    cfg = P.AugConfig(seg_size=SEG)
    jcfg = JP.AugConfig(seg_size=SEG)
    if val_views == "host":
        ours = [P.make_seg_val_views_host(i, m, cfg, num_threads=2) for i, m in slides]
        theirs = [JP.make_seg_val_views_host(i, m, jcfg) for i, m in slides]
    else:
        ours = theirs = slides
    seen = []
    scores = EV.validate_slides(EV.make_chunk_stats_for_views(model, NUM_FG, val_views, cfg),
                                iter(ours), val_views, CLASS_NAMES, device="cpu",
                                on_slide=lambda i, micro: seen.append(i))
    jmodel = JHookNet(arch=ARCH, classes=NUM_FG + 1)
    jscores = JEV.validate_slides(JEV.make_chunk_stats_for_views(jmodel, NUM_FG, val_views, jcfg),
                                  variables, iter(theirs), val_views, CLASS_NAMES)
    assert seen == [0, 1]
    got, want = scores.summary(), jscores.summary()
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
    assert all(0.0 <= v <= 1.0 for v in got.values())


def test_padding_changes_no_score(val_setup):
    """The same 6-tile slide in one chunk of 6 (no padding) and in chunks of
    4 (2 zero tiles of padding): equal counts and scores."""
    model, _, slides = val_setup
    stats = EV.make_chunk_stats_u8(model, NUM_FG, P.AugConfig(seg_size=SEG))
    imgs, masks = slides[1][0][:6], slides[1][1][:6]
    a = EV.validate_slide_u8(stats, imgs, masks, NUM_FG, chunk=6, device="cpu")
    b = EV.validate_slide_u8(stats, imgs, masks, NUM_FG, chunk=4, device="cpu")
    assert a[0] == b[0]
    for x, y in zip(a[1], b[1]):
        np.testing.assert_array_equal(x, y)
    tmask = P.make_seg_val_views(t(imgs), t(masks), P.AugConfig(seg_size=SEG))[1][1]
    # per class tp + fp + fn + tn counts every pixel not ignored (mask 0)
    assert int(sum(x.sum() for x in a[1])) == NUM_FG * (6 * SEG * SEG - int((tmask == 0).sum()))


# ---- checkpoints -------------------------------------------------------------

def test_best_ft_model_reads_back_in_the_jax_package(tmp_path):
    """``best_ft_model.pth.tar`` written by the port: ``{epoch, arch,
    state_dict}`` under ``module.``; the JAX package's
    ``torch_hooknet_to_flax`` reads it into a JAX HookNet whose eval logits
    are the port's within 1e-4 (measured 6.1e-6); the port's loader gives
    the same model back exactly."""
    model = _model()
    path = C.save_best_ft_model(str(tmp_path), model, epoch=4, arch=ARCH)
    assert Path(path).name == "best_ft_model.pth.tar"
    payload = torch.load(path, weights_only=True)
    assert payload["epoch"] == 5 and payload["arch"] == ARCH
    assert all(k.startswith("module.") for k in payload["state_dict"])
    variables = torch_hooknet_to_flax({k: np.asarray(v) for k, v in load_torch_file(path).items()})
    rng = np.random.default_rng(6)
    x1, x2 = (rng.normal(size=(2, SEG, SEG, 3)).astype(np.float32) for _ in range(2))
    jctx, jtgt = JHookNet(arch=ARCH, classes=NUM_FG + 1).apply(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(x1), jnp.asarray(x2), train=False)
    model.eval()
    with torch.no_grad():
        ctx, tgt = model(t(x1), t(x2))
    np.testing.assert_allclose(ctx.numpy(), np.asarray(jctx), atol=1e-4)
    np.testing.assert_allclose(tgt.numpy(), np.asarray(jtgt), atol=1e-4)
    back = C.load_ft_model(path, HookNet(arch=ARCH, classes=NUM_FG + 1))
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in back.state_dict().items())


# ---- the CLI -----------------------------------------------------------------

def _jax_cli_parser():
    tools = str(REPO / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    spec = importlib.util.spec_from_file_location("jax_ssl_finetune_cli",
                                                  REPO / "tools/ssl_finetune.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build_parser()


def _surface(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.nargs, type(a).__name__,
                     tuple(a.choices) if a.choices is not None else None,
                     getattr(a.type, "__name__", None))
            for a in parser._actions if a.option_strings and a.dest != "help"}


def test_flag_surface_covers_the_jax_cli():
    """Every option string of ``tools/ssl_finetune.py::build_parser`` with
    its default, type, nargs, action and choices; the port adds ``--device``."""
    want, got = _surface(_jax_cli_parser()), _surface(ssl_finetune.build_parser())
    assert len(want) == 40
    assert {d: got.get(d) for d in want} == want
    assert set(got) - set(want) == {"device"}


def _recipe_commands():
    """Every fine-tuning command of ``scripts/*.sh``, shell variables filled in."""
    for script in ("bcss", "paip", "c16"):
        text = (REPO / "scripts" / f"{script}.sh").read_text()
        for i, m in enumerate(re.finditer(r"python tools/ssl_finetune\.py((?:[^\n]*\\\n)*[^\n]*)",
                                          text)):
            cmd = m.group(1).replace("\\\n", " ")
            for var, value in (("${log_path}", "logs/x"), ("${LOG_PATH}", "logs/x"),
                               ("${f}", "3"), ("${i}", "0499"), ("${frac}", "0.5"),
                               ("${fold}", "2")):
                cmd = cmd.replace(var, value)
            yield f"{script}-{i}", shlex.split(cmd)


@pytest.mark.parametrize("name,argv", list(_recipe_commands()))
def test_recipes_parse_verbatim(name, argv):
    args = ssl_finetune.build_parser().parse_args(argv)
    assert ssl_finetune._unsupported(args) == [] and args.amp and args.batch_size == 64
    assert args.data_name in ("bcss", "paip") and args.device == "cuda"
    assert args.weights.endswith(".pth.tar") and "$" not in " ".join(argv)


def test_accum_steps_raises_naming_the_queue_item(tmp_path):
    with pytest.raises(ValueError,
                       match=r"not ported yet, ROADMAP\.md queue 1, the large-model memory path"):
        ssl_finetune.main(["--accum-steps", "2", "--synthetic", "2", "--device", "cpu",
                           "--log-dir", str(tmp_path / "run")])
    assert not (tmp_path / "run").exists()
    with pytest.raises(RuntimeError if not torch.cuda.is_available() else ValueError,
                       match="device='cpu'" if not torch.cuda.is_available() else "data-name"):
        ssl_finetune.main(["--synthetic", "2", "--data-name", "c16",
                           "--log-dir", str(tmp_path / "gpu")])


def _cli(tmp_path, name, *extra):
    return ssl_finetune.main(["-a", ARCH, "--seg-size", str(SEG), "-b", "4", "--device", "cpu",
                              "-p", "1", "--seed", "0", "--log-dir", str(tmp_path / name),
                              *extra])


def test_synthetic_run_writes_best_model(tmp_path):
    out = _cli(tmp_path, "syn", "--synthetic", "4", "--epochs", "2")
    assert len(out["epochs"]) == 2
    for e in out["epochs"]:
        assert np.isfinite(e["loss"]) and e["steps"] == 3  # 12 train tiles, b4
        assert all(0.0 <= e[k] <= 1.0 for k in ("train_f1", "val_f1", "val_iou", "val_acc"))
    best = Path(out["log_dir"]) / "best_ft_model.pth.tar"
    saved = C.load_torch_file(str(best))
    assert out["epochs"][0]["is_best"] and len(saved) == len(out["state"].model.state_dict())
    assert "packed-tail accepted for parity but inert" in (Path(out["log_dir"]) / "log.txt"
                                                           ).read_text()


@pytest.fixture(scope="module")
def bcss_dir(tmp_path_factory):
    """A BCSS-style directory: 14 tiles of 128 px as PNG, grey mask PNGs
    (classes 0-5 from the red channel), the last 4 tiles one validation
    slide of fold 0."""
    root = str(tmp_path_factory.mktemp("bcss") / "data")
    tiles = smooth_tiles(14, 2 * SEG, seed=3)
    files = write_bcss_dataset(root, tiles)
    write_bcss_masks(root, files, (tiles[..., 0] // 43).astype(np.uint8), n_val=4)
    return root


def test_bcss_run_from_port_ssl_weights_and_pack(bcss_dir, tmp_path):
    """``--weights`` from a port SSL run: before any step (``--epochs 0``)
    both branch encoders equal the checkpoint's encoders, and a ``--mean``
    other than the SSL run's (its ``configs.txt``) is warned of; then training
    and validation from PNG with host and with device views, and from a
    ``--packed-cache``, with the same loss as from PNG. The two kinds of
    views differ by design, as in the JAX package: the host's context view
    is resized in uint8 and rounded (the reference's cv2 split of work),
    the device's stays fp32, so a few argmaxes move; their scores are held
    within 1e-3 (measured 7.2e-5)."""
    ckpt, ssl_state = _ssl_checkpoint(tmp_path)
    base = ("--data-name", "bcss", "--train-data", bcss_dir, "--weights", str(ckpt))
    out = _cli(tmp_path, "zero", *base, "--epochs", "0", "--mean", "0.5", "0.5", "0.5")
    log = (Path(out["log_dir"]) / "log.txt").read_text()
    assert "--mean [0.5, 0.5, 0.5] differs from the checkpoint's training run" in log
    assert "=> --std" not in log
    for branch, enc in (("context_branch", "context_encoder"), ("target_branch", "target_encoder")):
        got = getattr(out["state"].model, branch).encoder.state_dict()
        want = getattr(ssl_state.model, enc).state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want)
    runs = {}
    for name, extra in (("host", ()), ("device", ("--val-views", "device")),
                        ("pack", ("--packed-cache", str(tmp_path / "pack")))):
        runs[name] = _cli(tmp_path, name, *base, "--epochs", "1", *extra)
        e = runs[name]["epochs"][0]
        assert e["steps"] == 3 and np.isfinite(e["loss"])  # 10 train tiles: 4, 4, 2
        assert (Path(runs[name]["log_dir"]) / "best_ft_model.pth.tar").exists()
    h, d, p = (runs[k]["epochs"][0] for k in ("host", "device", "pack"))
    for k in ("val_f1", "val_iou", "val_acc"):
        assert d[k] == pytest.approx(h[k], abs=1e-3), k
    assert p["loss"] == pytest.approx(h["loss"], abs=1e-6)
    assert len(list((tmp_path / "pack").glob("pack_*.npy"))) == 2
    assert "=> validation slides: 1" in (Path(runs["host"]["log_dir"]) / "log.txt").read_text()
