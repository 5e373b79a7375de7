"""Shared-memory bank conflicts of the renderer's stage-2 gathers (K2, K5
in genre_shapehd_tpu_torch/csrc/render_kernel.cu), from the tap tables
alone; runs on the CPU.

  PYTHONPATH=. python3 tools/probe_stage2_banks.py [--row-words 64 65 68]

A staged bf16 slab keeps row m of c at m * P 4-byte words.  A warp's
gather instruction reads element (m0 + i, z0 + j) of 32 samples; its
wavefronts are the largest number of distinct words that fall in one of
the 32 banks.  Prints, per row stride P and per lane mapping, the mean
wavefronts of a gather instruction over every ph row at the main shape
(V = 128, R = 128, S = 256, M = 192): K2's (lane l owns samples 8l ..
8l + 7), K5's (lane l owns 4l .. 4l + 3 of each round of 128) and one
sample per lane (s = 32k + l).  1.0 is conflict-free.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from genre_shapehd_tpu_torch.ops.render_sph_fast import tap_tables


def lane_samples(mapping: str) -> np.ndarray:
    """(instructions, 32) sample index per lane of each instruction of a
    256-sample row."""
    lane = np.arange(32)
    if mapping == "k2":
        return lane[None, :] * 8 + np.arange(8)[:, None]
    if mapping == "k5":
        j, i = np.meshgrid(np.arange(2), np.arange(4), indexing="ij")
        return (128 * j.reshape(-1, 1) + 4 * lane[None, :]
                + i.reshape(-1, 1))
    return lane[None, :] + 32 * np.arange(8)[:, None]


def mean_wavefronts(z_lo, m_lo, row_words: int, mapping: str) -> float:
    idx = lane_samples(mapping)
    total, count = 0, 0
    for ph in range(z_lo.shape[0]):
        z, m = z_lo[ph][idx], m_lo[ph][idx]
        for dm in (0, 1):
            for dz in (0, 1):
                words = (m + dm) * row_words + (z + dz) // 2
                for w in words:
                    banks = np.bincount(np.unique(w) % 32, minlength=32)
                    total += int(banks.max())
                    count += 1
    return total / count


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--row-words", type=int, nargs="+",
                    default=[64, 65, 67, 68, 71])
    args = ap.parse_args()
    t = tap_tables(128, 128, 256, 192)
    for p in args.row_words:
        print(json.dumps({"row_words": p, **{
            m: round(mean_wavefronts(t["z_lo"], t["m_lo"], p, m), 3)
            for m in ("k2", "k5", "one_per_lane")}}), flush=True)


if __name__ == "__main__":
    main()
