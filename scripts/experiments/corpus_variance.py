#!/usr/bin/env python
"""Per-corpus variance measurement (VERDICT r3 #4).

Explains each corpus's lossy-chart offsets from first principles:

- grid-cell variance at the voronoi-equivalent cell area for k in
  {64, 256, 2048} — positional k-means cells are near-square on uniform
  content, so mean within-cell summed-channel variance is the
  content-side proxy for the voronoi codec's MSE at that k (measured r4:
  codec = 0.75-0.81x proxy on the smooth corpus, 1.60-1.69x on the
  textured one — above 1 exactly when fine texture makes the decoder's
  positional-only wrapped-u32 cells diverge from the 5-D encode
  clusters whose centroid colors they reuse);
- unique-color count and the share of pixels within the dominant
  color mode (8-px-radius ball around the most common quantized color)
  — what the unique-color-weighted k-means sees, i.e. whether
  cluster-colors can reach DIV2K's 0.6-1.3 bits/px id entropy;
- per-channel sigma — overall contrast level.

Usage: python scripts/experiments/corpus_variance.py <pngs...>
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
from cniic_tpu import image_io  # noqa: E402


def grid_cell_variance(img: np.ndarray, k: int) -> float:
    h, w, _ = img.shape
    side = max(1, int(np.sqrt(h * w / k)))
    H, W = h // side * side, w // side * side
    x = img[:H, :W].astype(np.float64)
    cells = x.reshape(H // side, side, W // side, side, 3)
    cells = cells.transpose(0, 2, 1, 3, 4).reshape(-1, side * side, 3)
    return float(cells.var(axis=1).sum(axis=1).mean())


def dominant_share(img: np.ndarray) -> tuple[float, int]:
    px = img.reshape(-1, 3)
    uniq, counts = np.unique(
        (px >> 2).astype(np.uint32) @ np.array([1, 64, 4096], dtype=np.uint32),
        return_counts=True)
    mode_key = uniq[counts.argmax()]
    mode = np.array([mode_key % 64, (mode_key // 64) % 64, mode_key // 4096],
                    dtype=np.int64) * 4 + 2
    d2 = ((px.astype(np.int64) - mode) ** 2).sum(axis=1)
    share = float((d2 <= 64).mean())  # within an 8-px-radius color ball
    n_uniq = len(np.unique(px.astype(np.uint32) @ np.array(
        [1, 256, 65536], dtype=np.uint32)))
    return share, n_uniq


def main():
    paths = sys.argv[1:]
    if not paths:
        print(__doc__, file=sys.stderr)
        return 1
    rows = []
    for p in paths:
        img = image_io.load_image(p)
        v = {k: grid_cell_variance(img, k) for k in (64, 256, 2048)}
        share, n_uniq = dominant_share(img)
        sig = img.astype(np.float64).std(axis=(0, 1))
        rows.append((os.path.basename(p), v, share, n_uniq, sig))
        print(f"{os.path.basename(p)}: cellvar(k=64/256/2048) "
              f"{v[64]:.0f}/{v[256]:.0f}/{v[2048]:.0f}  dominant-ball "
              f"{share:.2f}  uniq {n_uniq}  sigma "
              f"{sig[0]:.1f}/{sig[1]:.1f}/{sig[2]:.1f}")
    if len(rows) > 1:
        for k in (64, 256, 2048):
            m = np.mean([r[1][k] for r in rows])
            print(f"corpus mean cellvar k={k}: {m:.0f}")
        print(f"corpus mean dominant-ball share: "
              f"{np.mean([r[2] for r in rows]):.2f}")
        print(f"corpus mean unique colors: "
              f"{np.mean([r[3] for r in rows]):.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
