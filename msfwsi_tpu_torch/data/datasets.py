"""Dataset manifests of SSL pretraining and fine-tuning: which tile files
are in play.

Port of the pretrain and seg parts of ``msfwsi_tpu/data/datasets.py``, reading the
CSVs with the ``csv`` module (the port has no pandas) and keeping the JAX
package's selection exactly:

  * BCSS (``data.csv``): rows whose slide code, ``filename.split("-")[1]``,
    is in the fold's validation set are dropped (a name without a ``-``
    has no code and is kept), then rows with ``ratio_masked_area`` under
    the threshold, then ``frac`` of the rest is drawn as pandas'
    ``sample(frac, random_state=1)`` draws it;
  * PAIP (``train_data.csv``): the same, with fold membership by the full
    file name, and ``fold=-1`` keeping every file;
  * Camelyon16 (``dataset.json``): ``n_sample`` tiles per slide drawn
    anew each epoch from ``(seed, epoch)``;
  * fine-tuning: (image, mask) pairs of the same training rows (threshold
    0.1 for BCSS, 0.7 for PAIP), and the fold's validation slides grouped
    by ``filename`` in first-appearance order, without frac, with BCSS's
    ``shift`` tiles left out.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import os
import random

import numpy as np

__all__ = [
    "BCSS_VAL_SET",
    "PAIP_VAL_SET",
    "bcss_pretrain_files",
    "paip_pretrain_files",
    "Camelyon16Manifest",
    "SegSample",
    "SlideGroup",
    "bcss_seg_samples",
    "bcss_seg_val_slides",
    "paip_seg_samples",
    "paip_seg_val_slides",
]

# bcss.py:13-19
BCSS_VAL_SET = [
    ["OL", "LL", "E2", "EW", "GM", "S3"],
    ["E2", "EW", "HN", "D8", "AC", "AQ"],
    ["BH", "EW", "LL", "GI", "A1", "A7"],
    ["E9", "BH", "A8", "AR", "EW", "LL"],
    ["D8", "AQ", "AR", "C8", "OL", "A7"],
]

# paip.py:13-19
PAIP_VAL_SET = [
    ["01_01_0100", "01_01_0101", "01_01_0103", "01_01_0106", "01_01_0113",
     "01_01_0115", "01_01_0120", "01_01_0121", "01_01_0133", "01_01_0135"],
    ["01_01_0083", "01_01_0093", "01_01_0096", "01_01_0107", "01_01_0110",
     "01_01_0113", "01_01_0118", "01_01_0121", "01_01_0123", "01_01_0131"],
    ["01_01_0088", "01_01_0100", "01_01_0104", "01_01_0115", "01_01_0122",
     "01_01_0128", "01_01_0129", "01_01_0132", "01_01_0133", "01_01_0134"],
    ["01_01_0083", "01_01_0085", "01_01_0094", "01_01_0101", "01_01_0104",
     "01_01_0108", "01_01_0117", "01_01_0122", "01_01_0124", "01_01_0133"],
    ["01_01_0089", "01_01_0091", "01_01_0094", "01_01_0108", "01_01_0110",
     "01_01_0122", "01_01_0123", "01_01_0127", "01_01_0134", "01_01_0137"],
]


def _read_csv(data_path: str, name: str) -> list[dict]:
    with open(os.path.join(data_path, name), newline="") as f:
        return list(csv.DictReader(f))


def _ratio(row: dict) -> float:
    """``ratio_masked_area`` as pandas parses it: an empty cell is NaN (and
    so below every threshold); anything else must be a number."""
    value = row["ratio_masked_area"].strip()
    return float(value) if value else float("nan")


def _bcss_slide_code(name: str) -> str | None:
    parts = name.split("-")
    return parts[1] if len(parts) > 1 else None


def _apply_common(rows: list[dict], threshold: float, frac: float) -> list[dict]:
    rows = [r for r in rows if _ratio(r) >= threshold]
    # pandas' DataFrame.sample(frac, replace=False, random_state=1)
    # (bcss.py:74): RandomState(1).choice(n, round(frac * n), replace=False).
    n = len(rows)
    pick = np.random.RandomState(1).choice(n, size=round(frac * n), replace=False)
    return [rows[i] for i in pick]


def bcss_pretrain_files(
    data_path: str, fold: int = 0, threshold: float = 0.1, frac: float = 1.0
) -> list[str]:
    """Train-fold tile image paths (relative to ``data_path``)."""
    val = set(BCSS_VAL_SET[fold])
    rows = [r for r in _read_csv(data_path, "data.csv")
            if _bcss_slide_code(r["filename"]) not in val]
    return [r["filename_img"] for r in _apply_common(rows, threshold, frac)]


def paip_pretrain_files(
    data_path: str, fold: int = 0, threshold: float = 0.1, frac: float = 1.0
) -> list[str]:
    rows = _read_csv(data_path, "train_data.csv")
    if fold != -1:  # paip.py:210-211: fold -1 keeps every training file
        val = set(PAIP_VAL_SET[fold])
        rows = [r for r in rows if r["filename"] not in val]
    return [r["filename_img"] for r in _apply_common(rows, threshold, frac)]


@dataclasses.dataclass(frozen=True)
class SegSample:
    img: str
    mask: str


@dataclasses.dataclass(frozen=True)
class SlideGroup:
    filename: str
    samples: tuple[SegSample, ...]


def _seg_samples(rows: list[dict]) -> list[SegSample]:
    return [SegSample(r["filename_img"], r["filename_mask"]) for r in rows]


def _slide_groups(rows: list[dict], threshold: float) -> list[SlideGroup]:
    """Rows at or above ``threshold`` grouped by ``filename``, in order of
    first appearance (pandas' ``unique()``)."""
    groups: dict[str, list[dict]] = {}
    for r in rows:
        if _ratio(r) >= threshold:
            groups.setdefault(r["filename"], []).append(r)
    return [SlideGroup(name, tuple(_seg_samples(rs))) for name, rs in groups.items()]


def bcss_seg_samples(data_path: str, fold: int = 0, threshold: float = 0.1,
                     frac: float = 1.0) -> list[SegSample]:
    """Train-fold (image, mask) pairs, selected as :func:`bcss_pretrain_files`."""
    val = set(BCSS_VAL_SET[fold])
    rows = [r for r in _read_csv(data_path, "data.csv")
            if _bcss_slide_code(r["filename"]) not in val]
    return _seg_samples(_apply_common(rows, threshold, frac))


def bcss_seg_val_slides(data_path: str, fold: int = 0,
                        threshold: float = 0.1) -> list[SlideGroup]:
    """The fold's validation slides; ``shift`` tiles left out (``bcss.py:135-136``)."""
    val = set(BCSS_VAL_SET[fold])
    rows = [r for r in _read_csv(data_path, "data.csv")
            if _bcss_slide_code(r["filename"]) in val and "shift" not in r["filename"]]
    return _slide_groups(rows, threshold)


def paip_seg_samples(data_path: str, fold: int = 0, threshold: float = 0.7,
                     frac: float = 1.0) -> list[SegSample]:
    val = set(PAIP_VAL_SET[fold])
    rows = [r for r in _read_csv(data_path, "train_data.csv") if r["filename"] not in val]
    return _seg_samples(_apply_common(rows, threshold, frac))


def paip_seg_val_slides(data_path: str, fold: int = 0,
                        threshold: float = 0.7) -> list[SlideGroup]:
    val = set(PAIP_VAL_SET[fold])
    rows = [r for r in _read_csv(data_path, "train_data.csv") if r["filename"] in val]
    return _slide_groups(rows, threshold)


class Camelyon16Manifest:
    """JSON-manifest pretrain corpus with per-epoch resampling.

    ``resample(epoch)`` draws ``n_sample`` tiles per slide and shuffles,
    seeded by (seed, epoch), so a resumed run draws what an uninterrupted
    one did (``camelyon.py:79-83``).
    """

    def __init__(self, data_path: str, n_sample: int = 500, mode: str = "train", seed: int = 0):
        self.data_path = data_path
        self.n_sample = n_sample
        self.mode = mode
        self.seed = seed
        with open(os.path.join(data_path, "dataset.json")) as f:
            meta = json.load(f)
        self.train_ids = meta["train_ids"]
        self.val_ids = meta["val_ids"]
        self.test_ids = meta["test_ids"]
        self.file_ending = meta.get("file_ending", ".png")

        self.all_data: dict[str, list[str]] = {}
        tr_dir = os.path.join(data_path, "imagesTr")
        if mode == "train":
            for d in sorted(os.listdir(tr_dir)):
                if d in self.train_ids:
                    self.all_data[d] = sorted(
                        f"imagesTr/{d}/{f}" for f in os.listdir(os.path.join(tr_dir, d))
                    )
        elif mode == "all":
            for sub in ("imagesTr", "imagesTs"):
                sdir = os.path.join(data_path, sub)
                if not os.path.isdir(sdir):
                    continue
                for d in sorted(os.listdir(sdir)):
                    self.all_data[d] = sorted(
                        f"{sub}/{d}/{f}" for f in os.listdir(os.path.join(sdir, d))
                    )
        else:
            raise ValueError(f"unknown mode {mode!r}")

    def resample(self, epoch: int) -> list[str]:
        rng = random.Random(f"{self.seed}-{epoch}")
        files = []
        for slide in self.all_data:
            pool = self.all_data[slide]
            files.extend(rng.sample(pool, k=len(pool))[: self.n_sample])
        rng.shuffle(files)
        return files
