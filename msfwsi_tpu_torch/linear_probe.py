"""Linear and kNN probes of SSL features (port of ``tools/linear_probe.py``):
score a pretrained encoder without fine-tuning.

    python -m msfwsi_tpu_torch.linear_probe --features feats/train --features-val feats/val \\
        --train-data ../data/bcss/L0_1024_s512 --data-name bcss

Fits a multinomial logistic regression (full-batch ``torch.optim.Adam`` on
softmax cross-entropy plus ``l2 * sum(W^2)``, ``W ~ N(0, 0.01^2)`` from a
generator seeded by ``--seed``, ``b = 0``) on features written by the
``extract_features`` CLI, standardized with the train split's statistics,
and reports smp-compatible micro and per-class F1 and accuracy with a
bootstrap 95% interval of the validation accuracy. ``--probe knn`` is the
fit-free weighted kNN instead: cosine similarity, the top-k train
neighbours each voting ``exp(sim / T)`` for its label (the train split
scored against itself leaves each tile's own vote out).

A tile's label is its dominant class in the prep CSV (argmax of
``[1 - ratio_masked_area, ratio_masked_1_area, ...]``), read by the
port's manifest reader (no pandas). The flags are the JAX CLI's, plus ``--device``.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp

import numpy as np
import torch

from . import _cli
from .data import datasets as D
from .ops import metrics as M

__all__ = ["build_parser", "main", "load_labels", "load_features", "fit_probe", "knn_predict",
           "score", "bootstrap_ci"]


def load_labels(train_data: str, data_name: str) -> tuple[dict, int]:
    """``{(slide, stem): dominant class}`` from the prep CSV's ratios, and
    the number of classes (background 0 included)."""
    name = "data.csv" if data_name == "bcss" else "train_data.csv"
    rows = D._read_csv(train_data, name)
    cols = rows[0].keys() if rows else ()
    ratio_cols = []
    while f"ratio_masked_{len(ratio_cols) + 1}_area" in cols:
        ratio_cols.append(f"ratio_masked_{len(ratio_cols) + 1}_area")
    if not ratio_cols:
        raise ValueError(f"{name} has no ratio_masked_<c>_area columns")
    ratios = np.array([[float(r[c]) for c in ratio_cols] for r in rows], np.float64)
    bg = 1.0 - np.array([float(r["ratio_masked_area"]) for r in rows], np.float64)
    labels = np.argmax(np.concatenate([bg[:, None], ratios], axis=1), axis=1)
    out = {(r["filename"], osp.splitext(osp.basename(r["filename_img"]))[0]): int(y)
           for r, y in zip(rows, labels)}
    return out, len(ratio_cols) + 1


def load_features(feat_dir: str, key: str, labels: dict, agg: str, logger):
    """(X float32, y int32) of the labelled tiles of an ``extract_features``
    output directory; target stacks (T, K, C) pooled by ``agg``."""
    xs, ys, missing = [], [], 0
    slides = sorted(f for f in os.listdir(feat_dir) if f.endswith(".npz"))
    if not slides:
        raise FileNotFoundError(f"no .npz feature files under {feat_dir}")
    for f in slides:
        slide = osp.splitext(f)[0]
        z = np.load(osp.join(feat_dir, f))
        if key not in z.files:
            raise KeyError(f"{f} has no key {key!r} (has {sorted(set(z.files) - {'stems'})}); "
                           "re-run extract_features with matching --branch/--scales")
        x = z[key].astype(np.float32)
        if x.ndim == 3:  # target branch: (T, K, C)
            x = x.mean(axis=1) if agg == "mean" else x.reshape(x.shape[0], -1)
        for stem, row in zip(z["stems"], x):
            y = labels.get((slide, str(stem)))
            if y is None:
                missing += 1
                continue
            xs.append(row)
            ys.append(y)
    if missing:
        logger.warning(f"=> {missing} tiles in {feat_dir} have no CSV label; skipped")
    if not xs:
        raise ValueError(f"no labeled tiles found in {feat_dir}")
    return np.stack(xs), np.asarray(ys, np.int32)


def fit_probe(X, y, num_classes: int, epochs: int, lr: float, l2: float, seed: int,
              device="cpu", init=None):
    """Full-batch Adam on softmax cross-entropy plus ``l2 * sum(W^2)`` from
    ``W ~ N(0, 0.01^2)`` (a CPU generator seeded by ``seed``) and ``b = 0``,
    or from ``init = (W, b)``. Returns ``((W, b) as numpy, the loss of the
    last step's parameters before its update)``."""
    if init is None:
        W = torch.randn((X.shape[1], num_classes), generator=torch.Generator().manual_seed(seed))
        W = W * 0.01
        b = torch.zeros((num_classes,))
    else:
        W, b = (torch.as_tensor(np.array(a, np.float32)) for a in init)
    W = W.to(device).requires_grad_(True)
    b = b.to(device).requires_grad_(True)
    opt = torch.optim.Adam([W, b], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    Xd = torch.as_tensor(X, dtype=torch.float32, device=device)
    yd = torch.as_tensor(y, dtype=torch.int64, device=device)
    loss = None
    for _ in range(epochs):
        opt.zero_grad(set_to_none=True)
        loss = torch.nn.functional.cross_entropy(Xd @ W + b, yd) + l2 * (W * W).sum()
        loss.backward()
        opt.step()
    final = float(loss.detach()) if loss is not None else float("nan")
    return (W.detach().cpu().numpy(), b.detach().cpu().numpy()), final


def knn_predict(X_tr, y_tr, X_va, num_classes: int, k: int, temperature: float,
                chunk: int = 4096, exclude_self: bool = False, device="cpu") -> np.ndarray:
    """Weighted-kNN labels (Wu et al. 2018): cosine similarity of
    L2-normalized embeddings, each of the top-k train neighbours voting its
    label with weight ``exp(sim / T)``; chunked over the query rows.
    ``exclude_self``: query row i is train row i, whose own column is masked
    out before the top-k."""
    k = max(min(k, X_tr.shape[0] - 1 if exclude_self else X_tr.shape[0]), 1)

    def norm(a):
        return a / (np.linalg.norm(a, axis=1, keepdims=True) + 1e-12)

    Xt = torch.as_tensor(norm(X_tr), dtype=torch.float32, device=device)
    yt = torch.as_tensor(y_tr, dtype=torch.int64, device=device)
    Xq = torch.as_tensor(norm(X_va), dtype=torch.float32, device=device)
    cols = torch.arange(Xt.shape[0], device=device)
    preds = []
    for i in range(0, Xq.shape[0], chunk):
        q = Xq[i : i + chunk]
        sim = q @ Xt.T
        if exclude_self:
            rows = i + torch.arange(q.shape[0], device=device)
            sim = sim.masked_fill(rows[:, None] == cols[None, :], float("-inf"))
        top_sim, top_idx = torch.topk(sim, k, dim=1)
        w = torch.exp(top_sim / temperature)
        votes = torch.zeros((q.shape[0], num_classes), device=device).scatter_add_(
            1, yt[top_idx], w)
        preds.append(votes.argmax(dim=1).to(torch.int32))
    return torch.cat(preds).cpu().numpy()


def score(X, y, params, num_classes: int, pred=None) -> dict:
    """Accuracy, micro F1 and per-class F1 of ``pred`` (or of the linear
    probe ``params`` on ``X``) against ``y``."""
    if pred is None:
        W, b = params
        pred = np.argmax(X @ W + b, axis=1).astype(np.int32)
    tp, fp, fn, tn = M.get_stats(torch.as_tensor(pred[None]).long(),
                                 torch.as_tensor(y[None]).long(), num_classes)
    return {
        "acc": float((pred == y).mean()),
        "micro_f1": float(M.f1_score(tp, fp, fn, tn, reduction="micro")),
        "f1_per_class": [float(v) for v in M.f1_score(tp, fp, fn, tn)[0]],
    }


def bootstrap_ci(pred, y, n_boot: int = 10000, seed: int = 0) -> list[float]:
    """Nonparametric 95% interval of the accuracy over tiles (tiles
    resampled with replacement by ``numpy.random.default_rng(seed)``)."""
    rng = np.random.default_rng(seed)
    N = len(y)
    idx = rng.integers(0, N, size=(n_boot, N))
    accs = (pred[idx] == y[idx]).mean(axis=1)
    return [float(np.percentile(accs, 2.5)), float(np.percentile(accs, 97.5))]


def main(argv=None) -> dict:
    """Run the CLI on ``argv``. Returns the train and val results."""
    parser = build_parser()
    args, dev, _ = _cli.start(parser, argv)
    return _cli.run(args, argv, __spec__.name, lambda logger: _probe(args, dev, logger))


def _probe(args, dev, logger) -> dict:
    labels, num_classes = load_labels(args.train_data, args.data_name)
    X_tr, y_tr = load_features(args.features, args.key, labels, args.agg, logger)
    X_va, y_va = load_features(args.features_val, args.key, labels, args.agg, logger)
    logger.info(f"=> probe on {args.key}: {X_tr.shape[0]} train / {X_va.shape[0]} val tiles, "
                f"{X_tr.shape[1]} dims, {num_classes} classes")
    if args.probe == "knn":
        k = min(args.knn_k, X_tr.shape[0])
        logger.info(f"=> weighted kNN: k={k}, T={args.knn_t} (no fit)")
        pred_tr = knn_predict(X_tr, y_tr, X_tr, num_classes, k, args.knn_t, exclude_self=True,
                              device=dev)
        pred_va = knn_predict(X_tr, y_tr, X_va, num_classes, k, args.knn_t, device=dev)
        params = mu = sigma = None
    else:
        # standardized with the train statistics (folds into (W, b))
        mu = X_tr.mean(axis=0)
        sigma = X_tr.std(axis=0) + 1e-6
        X_tr = (X_tr - mu) / sigma
        X_va = (X_va - mu) / sigma
        params, final_loss = fit_probe(X_tr, y_tr, num_classes, args.epochs, args.lr, args.l2,
                                       args.seed, device=dev)
        logger.info(f"=> fitted {args.epochs} epochs, final loss {final_loss:.4f}")
        W, b = params
        pred_tr = np.argmax(X_tr @ W + b, axis=1).astype(np.int32)
        pred_va = np.argmax(X_va @ W + b, axis=1).astype(np.int32)
    results = {"train": score(X_tr, y_tr, params, num_classes, pred=pred_tr),
               "val": score(X_va, y_va, params, num_classes, pred=pred_va)}
    results["val"]["acc_ci95"] = bootstrap_ci(pred_va, y_va)
    results["val"]["pred"] = [int(v) for v in pred_va]
    results["val"]["labels"] = [int(v) for v in y_va]
    for split, r in results.items():
        ci = "  ci95 [%.3f, %.3f]" % tuple(r["acc_ci95"]) if "acc_ci95" in r else ""
        logger.info(f"=> {split}: acc {r['acc']:.4f}{ci}  micro-F1 {r['micro_f1']:.4f}  "
                    f"per-class F1 {['%.3f' % v for v in r['f1_per_class']]}")
    out = args.out or osp.join(args.log_dir, "probe")
    if params is not None:
        np.savez(out + ".npz", W=params[0], b=params[1], mu=mu, sigma=sigma, key=args.key,
                 num_classes=num_classes)
    with open(out + ".json", "w") as f:
        json.dump({"key": args.key, "probe": args.probe, "num_classes": num_classes, **results},
                  f, indent=2)
    logger.info(f"=> wrote {out}.json" + ("" if params is None else f" / {out}.npz"))
    return results


def build_parser():
    parser = argparse.ArgumentParser(description="MSF-WSI linear probe (PyTorch port)")
    parser.add_argument("--features", type=str, required=True,
                        help="train features dir (extract_features --split train)")
    parser.add_argument("--features-val", type=str, required=True,
                        help="val features dir (extract_features --split val)")
    parser.add_argument("--train-data", type=str, required=True,
                        help="prepared dataset root (labels come from its CSV ratios)")
    parser.add_argument("--data-name", type=str, default="bcss", choices=("bcss", "paip"))
    parser.add_argument("--key", type=str, default="context_s4",
                        help="feature key to probe (e.g. context_s4, target_s4)")
    parser.add_argument("--agg", choices=("mean", "flatten"), default="mean",
                        help="how to pool target-branch (T, K, C) stacks")
    parser.add_argument("--probe", choices=("linear", "knn"), default="linear",
                        help="linear = fit logistic regression; knn = fit-free weighted kNN "
                        "(cosine sim, exp(sim/T) votes)")
    parser.add_argument("--knn-k", type=int, default=20,
                        help="neighbours for --probe knn (clamped to N_train)")
    parser.add_argument("--knn-t", type=float, default=0.07,
                        help="vote temperature for --probe knn")
    parser.add_argument("--epochs", type=int, default=200)
    parser.add_argument("--lr", type=float, default=1e-2)
    parser.add_argument("--l2", type=float, default=1e-4)
    parser.add_argument("--seed", type=int, default=3407)
    parser.add_argument("--log-dir", default="./logs/temp", type=str)
    parser.add_argument("--out", type=str, help="output stem (default <log_dir>/probe)")

    # The port's own
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


if __name__ == "__main__":
    main()
