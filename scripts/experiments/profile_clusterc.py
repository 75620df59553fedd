#!/usr/bin/env python
"""Where does cluster-colors_32 spend its 2 s/MP at north-star statistics?

Splits the production encode_batch path (codecs/clusterc.py) into its four
stages over real ns1000 chunks and reports per-stage seconds + the k-means
iteration counts.

Usage: python scripts/experiments/profile_clusterc.py [--lanes=8] [--chunks=2]
       [--k=32] <pngs...>
"""

from __future__ import annotations

import glob as globlib
import logging
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from cniic_tpu import huffman, image_io  # noqa: E402
from cniic_tpu.codecs.base import pixels_row_major  # noqa: E402
from cniic_tpu.codecs.clusterc import _palette_stream_parts  # noqa: E402
from cniic_tpu.ops import histogram, kmeans  # noqa: E402


def main() -> int:
    lanes, chunks, k = 8, 2, 32
    paths = []
    for a in sys.argv[1:]:
        if a.startswith("--lanes="):
            lanes = int(a.split("=", 1)[1])
        elif a.startswith("--chunks="):
            chunks = int(a.split("=", 1)[1])
        elif a.startswith("--k="):
            k = int(a.split("=", 1)[1])
        else:
            paths.extend(sorted(globlib.glob(a)) or [a])
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    need = lanes * (chunks + 1)
    paths = sorted(paths)[:need]
    assert len(paths) == need, f"need {need} images, got {len(paths)}"
    groups = [paths[i:i + lanes] for i in range(0, len(paths), lanes)]

    import jax
    print(f"backend={jax.default_backend()} lanes={lanes} k={k}", flush=True)

    def run(group, label):
        imgs = [image_io.load_image(p) for p in group]
        mp = sum(im.shape[0] * im.shape[1] for im in imgs) / 1e6

        t0 = time.perf_counter()
        stats = [histogram.color_histogram(pixels_row_major(im))
                 for im in imgs]
        t_hist = time.perf_counter() - t0
        uniq = [s[0].shape[0] for s in stats]

        # mirror the production path exactly (codecs/clusterc.py
        # encode_batch): lanes sorted by unique count, structural w_bound
        # from the pixel counts — otherwise this profiler re-derives
        # content-driven compile keys production no longer pays for
        t0 = time.perf_counter()
        order = sorted(range(len(stats)),
                       key=lambda i: stats[i][0].shape[0], reverse=True)
        sorted_results = kmeans.kmeans_batch(
            [stats[i][0].astype(np.int64) for i in order], k,
            weights_list=[stats[i][1].astype(np.int64) for i in order],
            w_bound=max(im.shape[0] * im.shape[1] for im in imgs))
        results = [None] * len(stats)
        for pos, i in enumerate(order):
            results[i] = sorted_results[pos]
        t_km = time.perf_counter() - t0
        iters = [r[2] for r in results]

        t0 = time.perf_counter()
        parts = [_palette_stream_parts(k, stats[i][1], stats[i][2],
                                       results[i][0], results[i][1])
                 for i in range(len(imgs))]
        t_parts = time.perf_counter() - t0

        t0 = time.perf_counter()
        huffman.batch_encode_streams(
            [p[0] for p in parts], [p[1] for p in parts],
            [p[2] for p in parts])
        t_huf = time.perf_counter() - t0

        tot = t_hist + t_km + t_parts + t_huf
        print(f"{label}: {mp:.1f} MP  uniq={uniq}  iters={iters}\n"
              f"  hist {t_hist:.2f}s  kmeans {t_km:.2f}s  "
              f"parts {t_parts:.2f}s  huf {t_huf:.2f}s  "
              f"total {tot:.2f}s -> {mp/tot:.3f} MP/s", flush=True)
        return tot, mp

    run(groups[0], "warmup")
    tot = mp = 0.0
    for gi, g in enumerate(groups[1:]):
        t, m = run(g, f"chunk{gi}")
        tot += t
        mp += m
    print(f"steady: {mp/tot:.3f} MP/s over {mp:.1f} MP", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
