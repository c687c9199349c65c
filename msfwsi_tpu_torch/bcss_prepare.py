"""BCSS tile extraction CLI of the port (from ``tools/bcss_prepare.py``).

    python -m msfwsi_tpu_torch.bcss_prepare -p ../data/bcss/raw \\
        -o ../data/bcss/L0_1024_s512 -s 1024 --overlap 512

The flags and defaults are the JAX tool's (``-p/-o/-l/-s/--overlap``; the
reference's ``--level`` is parsed and, as there, unused). It reads the
region PNGs under ``<data-path>/images`` and ``<data-path>/masks`` with the
port's decoder and writes the tile library and ``data.csv`` that every
port CLI reads (:func:`.data.prepare.prepare_bcss`), then prints the CSV's
(rows, columns) as the JAX tool prints ``df.shape``. It is a host tool: it
launches nothing on the card, so it has no ``--device`` flag (nor does the
JAX tool, which needs no device either).
"""

from __future__ import annotations

import argparse

from .data.prepare import CSV_COLUMNS, prepare_bcss

__all__ = ["build_parser", "main"]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Patch extraction for BCSS")
    parser.add_argument("-p", "--data-path", type=str, default="", help="Path to the dataset")
    parser.add_argument(
        "-o", "--out-path", type=str, default="", help="Path to the save processed dataset"
    )
    parser.add_argument(
        "-l", "--level", type=int, default=0, choices=range(0, 7),
        help="Region level for WSI, chose from [0, 6]",
    )
    parser.add_argument("-s", "--tile-size", type=int, default=256, help="Size of tiles")
    parser.add_argument("--overlap", type=int, default=0, help="Overlaps of tiles")
    return parser


def main(argv=None) -> tuple[int, int]:
    """Run the CLI on ``argv``; returns and prints (rows, columns) of the
    written ``data.csv``."""
    args = build_parser().parse_args(argv)
    rows = prepare_bcss(args.data_path, args.out_path, tile_size=args.tile_size,
                        shift=args.overlap)
    shape = (len(rows), len(CSV_COLUMNS))
    print(shape)
    return shape


if __name__ == "__main__":
    main()
