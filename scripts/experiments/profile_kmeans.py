"""GPU probe of the fused k-means kernel against the XLA body at real widths.

Builds the two production k-means batches of the DIV2K-shaped bench cell
(8 synthetic 2040x1356 images, seed 7): voronoi(128) over 4 lanes of 2.77 M
(x, y, r, g, b) points and cluster-colors(32) over the 8 images' weighted
unique colors. For each it checks one kernel iteration against the XLA
iteration with zero tolerance (assignments, int32 statistics, move counts),
then times one assignment+statistics step of both paths, the kernel over a
grid of (sub-block rows, centroid tile, sub-blocks per program).

    python scripts/experiments/profile_kmeans.py [--quick]

Needs a GPU; exits non-zero without one.
"""
from __future__ import annotations

import functools
import importlib.util
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cniic_tpu.codecs.clusterc import pixels_row_major  # noqa: E402
from cniic_tpu.ops import histogram  # noqa: E402
from cniic_tpu.ops import kmeans as km  # noqa: E402
from cniic_tpu.ops import kmeans_pallas as kp  # noqa: E402


def _synth_natural():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "make_synth_corpus.py")
    spec = importlib.util.spec_from_file_location("make_synth_corpus", path)
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m.synth_natural


def div2k_batch(n=8, seed=7):
    synth = _synth_natural()
    rng = np.random.default_rng(seed)
    return [synth(rng, 1356, 2040) for _ in range(n)]


def _time(fn, reps=5):
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


@functools.partial(jax.jit, static_argnames=("k", "bs", "vp", "wp", "pk"))
def _xla_step(pts_f, pts_i, w, valid, cur, cents, k, bs, vp, wp, pk):
    return jax.vmap(lambda *a: km._assign_stats_xla(
        *a, k, bs, vp, wp, pk))(pts_f, pts_i, w, valid, cur,
                                cents.astype(jnp.float32))


@functools.partial(jax.jit, static_argnames=("k", "pk", "bs", "kt", "sub",
                                             "packed"))
def _kernel_step(pop, feat, cur, cents, n, k, pk, bs, kt, sub, packed):
    kpp = max(16, 1 << (k - 1).bit_length())
    cop, csq = kp.centroid_operands(cents, kpp)
    return kp._assign_stats(pop, feat, cur, cop, csq, n,
                            jnp.ones(n.shape, jnp.int32), k=k, pk=pk, bs=bs,
                            kt=kt, sub=sub, packed=packed,
                            interpret=jax.default_backend() != "gpu")


def probe(name, state, k, d2b, configs, report):
    """Check each kernel config against the XLA step (zero tolerance) and
    time both; raises SystemExit on any difference."""
    pts_f, pts_i, w, valid, cur, cents, ns, bs, vp, wp, pk, pw = state
    B, n_pad, d = pts_i.shape
    F = vp * d + wp
    pkc = 1 << max(k - 1, 0).bit_length()
    packed = (d2b + 1) * 2 * pkc < 2**31
    n_dev = jnp.asarray(np.asarray(ns, np.int32))
    pop, feat = kp.point_operands(pts_i, w, vp, wp)
    new_x, sums_x, mv_x = _xla_step(pts_f, pts_i, w, valid, cur, cents,
                                    k, bs, vp, wp, pk)
    t_x = _time(lambda: _xla_step(pts_f, pts_i, w, valid, cur, cents,
                                  k, bs, vp, wp, pk))
    report(f"{name}: B={B} n_pad={n_pad} d={d} k={k} F={F} packed={packed} "
           f"xla_step_ms={t_x * 1e3:.3f}")
    for bs_p, kt, sub in configs:
        new_p, sums_p, mv_p = _kernel_step(pop, feat, cur, cents, n_dev, k,
                                           pkc, bs_p, kt, sub, packed)
        same = (np.array_equal(np.asarray(new_p), np.asarray(new_x))
                and np.array_equal(np.asarray(sums_p)[:, :k, :F],
                                   np.asarray(sums_x))
                and np.array_equal(np.asarray(mv_p), np.asarray(mv_x)))
        t_p = _time(lambda: _kernel_step(pop, feat, cur, cents, n_dev, k,
                                         pkc, bs_p, kt, sub, packed))
        report(f"  kernel bs={bs_p} kt={kt} sub={sub}: "
               f"step_ms={t_p * 1e3:.3f} exact={same}")
        if not same:
            raise SystemExit(f"{name}: kernel differs from the XLA iteration")


def voronoi_state(imgs, k):
    """The voronoi k-means batch of 4 lanes (one chunk, as
    voronoi_centroids_batch runs it): (probe state, d2_bound)."""
    h, wd = imgs[0].shape[:2]
    n = h * wd
    d2b = (wd - 1) ** 2 + (h - 1) ** 2 + 3 * 255 ** 2
    bs, vp, wp, pk, pw, split, wide = km.plan_params(
        max(wd - 1, h - 1, 255), 1, d2b, k, n)
    state = km._voronoi_setup(jnp.asarray(np.stack(imgs[:4])), k, bs)
    return (*state, [n] * 4, bs, vp, wp, pk, pw), d2b


def cluster_colors_state(imgs, k):
    """The cluster-colors batch: every image's weighted unique colors."""
    stats = [histogram.color_histogram(pixels_row_major(im)) for im in imgs]
    prepped = km._prep_host_batch(
        [s[0].astype(np.int64) for s in stats], k,
        [s[1].astype(np.int64) for s in stats],
        w_bound=imgs[0].shape[0] * imgs[0].shape[1])
    return prepped[:12], prepped[14]


def main():
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("profile_kmeans.py needs a GPU")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout)
    quick = "--quick" in sys.argv
    imgs = div2k_batch()

    def report(line):
        print(line, flush=True)

    legs = [
        ("voronoi(128)", voronoi_state, 128,
         [(bs, kt, sub) for bs in (64, 128) for kt in (32, 128)
          for sub in (16, 64)]),
        ("voronoi(2048)", voronoi_state, 2048,
         [(128, kt, sub) for kt in (32, 64) for sub in (8, 16, 64)]),
        ("cluster-colors(32)", cluster_colors_state, 32,
         [(bs, 32, sub) for bs in (64, 128) for sub in (16, 64)]),
    ]
    for name, make, k, grid in legs:
        state, d2b = make(imgs, k)
        n_pad = state[1].shape[1]
        # programs must tile the padded lane exactly
        configs = ([kp.pick_block(n_pad, k)] if quick else
                   [c for c in grid if n_pad % (c[0] * c[2]) == 0])
        probe(name, state, k, d2b, configs, report)


if __name__ == "__main__":
    main()
