#!/usr/bin/env python
"""Census of k-means compile keys over a corpus (no device, no compiles).

Every distinct (n_pad, bs, vp, wp, pk, pw, split, wide, burst, packed,
B) tuple is a fresh compile of the k-means loop. This script replays the
EXACT static-key derivation of ops/kmeans._prep_host_batch over real corpus batches on the
host and prints the distinct keys under (a) the measured-max-weight
policy (pre-r5-fix) and (b) the structural w_bound policy, so the
key-collapse claim is proven over the whole corpus rather than sampled.

Usage: python scripts/experiments/kmeans_key_census.py [--lanes=8] [--k=32]
           [--limit=1000] 'data/ns1000/*.png'
"""

from __future__ import annotations

import glob as globlib
import os
import sys
from collections import Counter

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import jax

jax.config.update("jax_platforms", "cpu")

from cniic_tpu import image_io  # noqa: E402
from cniic_tpu.codecs.base import pixels_row_major  # noqa: E402
from cniic_tpu.ops import histogram  # noqa: E402
from cniic_tpu.ops import kmeans as km  # noqa: E402


def group_key(colors_list, weights_list, k, w_bound=None):
    """The full static compile key for one lane group, via the production
    `ops.kmeans.static_compile_key` (single source of truth — this script
    cannot desync from `_prep_host_batch`/`_drive`). Note `w_dtype` keys
    only the cheap widening and is measured-content-driven by design."""
    ns_max = max(c.shape[0] for c in colors_list)
    max_val = max(int(c.max(initial=0)) for c in colors_list)
    max_w = max(int(w.max(initial=1)) for w in weights_list)
    d2_bound = max(
        int(np.sum(c.max(axis=0, initial=0).astype(np.int64) ** 2))
        for c in colors_list)
    plan = km.static_compile_key(ns_max, max_val, max_w, d2_bound, k,
                                 len(colors_list), w_bound=w_bound)
    return tuple(plan.values())


def main() -> int:
    lanes, k, limit = 8, 32, 1000
    paths = []
    for a in sys.argv[1:]:
        if a.startswith("--lanes="):
            lanes = int(a.split("=", 1)[1])
        elif a.startswith("--k="):
            k = int(a.split("=", 1)[1])
        elif a.startswith("--limit="):
            limit = int(a.split("=", 1)[1])
        else:
            paths.extend(sorted(globlib.glob(a)) or [a])
    paths = sorted(paths)[:limit]
    if not paths:
        print(__doc__, file=sys.stderr)
        return 1

    measured = Counter()
    bounded = Counter()
    for gi in range(0, len(paths), lanes):
        group = paths[gi:gi + lanes]
        cols, wts, wb = [], [], 0
        for p in group:
            im = image_io.load_image(p)
            c, w, _ = histogram.color_histogram(pixels_row_major(im))
            cols.append(c.astype(np.int64))
            wts.append(w.astype(np.int64))
            wb = max(wb, im.shape[0] * im.shape[1])
        measured[group_key(cols, wts, k)] += 1
        bounded[group_key(cols, wts, k, w_bound=wb)] += 1
        if (gi // lanes) % 10 == 0:
            print(f"group {gi//lanes + 1}/{-(-len(paths)//lanes)}: "
                  f"measured={len(measured)} bounded={len(bounded)} keys",
                  flush=True)

    hdr = "(" + ", ".join(km.static_compile_key(
        1, 1, 1, 1, 1, 1).keys()) + ")"
    for name, ctr in (("measured-max_w", measured),
                      ("structural w_bound", bounded)):
        print(f"\n{name}: {len(ctr)} distinct compile key(s) over "
              f"{sum(ctr.values())} groups  {hdr}")
        for key, cnt in ctr.most_common():
            print(f"  {cnt:4d}x  {key}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
