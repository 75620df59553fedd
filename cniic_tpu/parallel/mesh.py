"""Multi-chip scaling (SURVEY.md §2.4): SPMD over a device mesh.

The reference's only parallelism is rayon threads over images
(bench.rs:22-27). Two device axes replace it, both built on the SAME iteration
core as the single-chip path (`ops.kmeans._assign_stats_xla` /
`_means_div` / `_steal_indices` — VERDICT r1 #4: no forked math):

* **image-batch sharding** (the production axis): the lockstep batched
  k-means loop in ops/kmeans.py carries a leading lane axis; `shard_batch`
  lays those lanes over the mesh with `jax.sharding.NamedSharding`, so the
  encode of a batch scales linearly in chips with one tiny `all_reduce`
  (the `any(moved > thresh)` loop condition) per iteration. Used
  automatically by `ops.kmeans._drive` when >1 device is visible.
* **point sharding** (`sharded_kmeans`): one huge image's point set split
  over devices via `shard_map`, local matmul assignment + local integer
  digit-plane sums combined with `psum`, centroids replicated, the
  empty-cluster steal resolved with a masked psum gather. Bit-identical to
  the single-device result (int32 block sums are order-independent —
  tested in tests/test_parallel.py).

Everything compiles on virtual CPU devices (`jax.config
jax_num_cpu_devices`), so the sharding is CI-testable without hardware;
`__graft_entry__.dryrun_multichip` additionally runs a real
cluster-colors/voronoi encode batch-sharded over the virtual mesh.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax import shard_map

jax.config.update("jax_enable_x64", True)


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), axis_names=("batch",))


def batch_mesh(batch: int) -> Mesh | None:
    """The mesh `ops.kmeans._drive` shards its lane axis over, or None to
    stay single-device: needs >1 visible device, a divisible batch, and no
    CNIIC_MESH=0 override."""
    if os.environ.get("CNIIC_MESH", "") == "0":
        return None
    ndev = len(jax.devices())
    if ndev <= 1 or batch % ndev != 0:
        return None
    return make_mesh(ndev)


def shard_batch(mesh: Mesh, *arrays):
    """Lay arrays with a leading lane axis over the mesh's batch axis."""
    out = []
    for a in arrays:
        spec = P("batch", *([None] * (a.ndim - 1)))
        out.append(jax.device_put(a, NamedSharding(mesh, spec)))
    return tuple(out)


# ---------------------------------------------------------------------------
# point-sharded k-means: one huge point set split over the mesh
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _sharded_burst(mesh: Mesh, k: int, d: int, n_loc: int, bs: int, vp: int,
                   wp: int, pk: int, pw: int, split: int, wide: bool,
                   burst: int, stall_lim: int):
    """shard_map'd burst of full k-means iterations; points sharded on the
    batch axis, centroids replicated, statistics psum'd. Carries
    the same per-iteration plateau net as the single-chip loops so results
    stay bit-identical."""
    from ..ops import kmeans as km

    def _local(pts_f, pts_i, w, valid, cur, cents_i, it0, moved0, best0,
               stall0, n, thresh):
        off = jax.lax.axis_index("batch") * n_loc

        def cond(state):
            it, _, _, moved, _, stall = state
            return jnp.logical_and(
                jnp.logical_and(moved > thresh, stall < stall_lim),
                it < it0 + burst)

        def body(state):
            it, cur, cents_i, _, best, stall = state
            new, sums_loc, moved_loc = km._assign_stats_xla(
                pts_f, pts_i, w, valid, cur, cents_i.astype(jnp.float32),
                k, bs, vp, wp, pk, pw, split, wide)
            sums = jax.lax.psum(sums_loc, "batch")
            moved = jax.lax.psum(moved_loc, "batch")
            cents_div, wsum = km._means_div(sums, d, k, vp, wp, pw)
            empty = wsum == 0
            # the steal index is global; each shard contributes its point
            # (or zeros) and the psum reassembles exactly pts[steal]
            steal = km._steal_indices(k, it, n)
            loc = steal - off
            in_range = jnp.logical_and(loc >= 0, loc < n_loc)
            cand = jnp.where(in_range[:, None],
                             pts_i[jnp.clip(loc, 0, n_loc - 1)], 0)
            stolen = jax.lax.psum(cand, "batch")
            cents_new = jnp.where(empty[:, None], stolen, cents_div)
            best, stall = km._plateau_update(
                jnp.asarray(True), moved, best, stall)
            return it + 1, new, cents_new, moved, best, stall

        state = (it0, cur, cents_i, moved0, best0, stall0)
        return jax.lax.while_loop(cond, body, state)

    sharded = shard_map(
        _local, mesh=mesh,
        in_specs=(P("batch", None), P("batch", None), P("batch"), P("batch"),
                  P("batch"), P(None, None), P(), P(), P(), P(), P(), P()),
        out_specs=(P(), P("batch"), P(None, None), P(), P(), P()),
    )
    return jax.jit(sharded)


def sharded_kmeans(mesh: Mesh, points: np.ndarray, k: int,
                   weights: np.ndarray | None = None, block: int = 1024,
                   max_iters: int = 10_000, w_bound=None):
    """ops.kmeans.kmeans with the POINT axis sharded over the mesh — the
    multi-chip path for one huge point set. Same init, stop rule, strict-
    move/truncation/repair semantics; bit-identical output (int32 partial
    sums are order-independent under psum).

    Returns (centroids int64[k, d], assignment int32[n], n_iters).
    """
    from ..ops import kmeans as km

    points = np.asarray(points)
    n, d = points.shape
    # same exact-arithmetic feasibility bounds as the single-chip entry
    # points (< 2^27 points/weight, coords <= 16383, int32 weighted
    # values): sharding distributes the work but the psum'd plane sums
    # land in the same int32/long-division budgets
    km._validate_lane(points, weights, k)
    ndev = int(mesh.devices.size)
    max_val = int(points.max(initial=0))
    max_w = 1 if weights is None else max(int(np.max(weights)), 1)
    if w_bound is not None:
        # structural weight bound: shape-driven vp/wp compile keys (same
        # contract as ops/kmeans._prep_host_batch; results are exact —
        # extra leading digit planes are zero)
        if int(w_bound) < max_w:
            raise ValueError(
                f"w_bound {w_bound} below measured max weight {max_w}")
        max_w = int(w_bound)
    d2_bound = int(np.sum(points.max(axis=0, initial=0).astype(np.int64) ** 2))
    # pw must come from the GLOBAL point count: plane-sum partials are
    # psum'd across shards into the same int32 budget
    _, vp, wp, pk, pw, split, wide = km.plan_params(
        max_val, max_w, d2_bound, k, n)

    n_loc = -(-n // (ndev * block)) * block
    n_pad = ndev * n_loc
    pts_i = np.zeros((n_pad, d), np.int32)
    pts_i[:n] = points
    w = np.zeros(n_pad, np.int32)
    w[:n] = 1 if weights is None else weights
    valid = np.zeros(n_pad, bool)
    valid[:n] = True
    cur = np.zeros(n_pad, np.int32)
    ppc = n // k
    tail_start = n - (k - 1) * ppc
    cur[:tail_start] = k - 1
    if k > 1:
        j = np.arange(tail_start, n)
        cur[tail_start:n] = (n - 1 - j) // ppc
    cents = np.zeros((k, d), np.int32)
    for i in range(k - 1):
        cents[i] = points[n - (i + 1) * ppc]
    cents[k - 1] = points[0]

    thresh = km._stop_threshold(n)
    strict = os.environ.get("CNIIC_KMEANS_STRICT", "") == "1"
    stall_lim = (1 << 30) if strict else km._STALL_LIMIT
    burst = max(4, min(64, (1 << 23) // max(n // 8, 1)))
    step = _sharded_burst(mesh, k, d, n_loc, block, vp, wp, pk, pw, split,
                          wide, burst, stall_lim)

    # upload ONCE, narrow (CLAUDE.md transfer rule), widen on device; the
    # burst loop then only moves the small carried state per iteration
    pts_up = pts_i.astype(np.int16) if max_val <= 32767 else pts_i
    w_up = w.astype(np.uint8) if max_w < 256 else w
    cur_up = cur.astype(np.uint16) if k <= 65535 else cur
    pts_f_d, pts_i_d, w_d, cur_d = km._widen(
        jnp.asarray(pts_up), jnp.asarray(w_up), jnp.asarray(cur_up))
    valid_d = jnp.asarray(valid)
    cents_d = jnp.asarray(cents)
    it, moved, stall = 0, n + 1, 0
    best_d = jnp.int32(min(n + 1, 2**31 - 1))
    stall_d = jnp.int32(0)
    while it < max_iters and moved > thresh and stall < stall_lim:
        it_d, cur_d, cents_d, moved_d, best_d, stall_d = step(
            pts_f_d, pts_i_d, w_d, valid_d, cur_d, cents_d, jnp.int32(it),
            jnp.int32(min(moved, 2**31 - 1)), best_d, stall_d,
            jnp.int32(n), jnp.int32(thresh))
        it, moved, stall = int(it_d), int(moved_d), int(stall_d)

    centroids = np.array(cents_d).astype(np.int64)
    assignment = np.asarray(cur_d)[:n]
    active = np.unique(assignment).size
    km._check_active(active, k, n)
    return centroids, assignment, it


@functools.lru_cache(maxsize=8)
def sharded_mse(mesh: Mesh):
    """Batched MSE with the image batch sharded over chips.

    step(x uint8[b, h, w, 3], y uint8[b, h, w, 3]) -> f64[b] per-image MSE.
    """

    def _local(x, y):
        d = x.astype(jnp.float64) - y.astype(jnp.float64)
        per_img = jnp.sum(d * d, axis=(1, 2, 3)) / (x.shape[1] * x.shape[2])
        return per_img

    sharded = shard_map(
        _local, mesh=mesh,
        in_specs=(P("batch"), P("batch")),
        out_specs=P("batch"),
    )
    return jax.jit(sharded)


@functools.lru_cache(maxsize=8)
def sharded_voronoi_reconstruct(mesh: Mesh):
    """Voronoi decode with the pixel rows sharded over chips.

    step(xs u32[n], ys u32[n], cx u32[k], cy u32[k], kmask bool[k]) ->
    int32[n] nearest-centroid ids under the reference's wrapping-u32 metric.
    """

    def _local(xs, ys, cx, cy, kmask):
        dx = cx[None, :] - xs[:, None]
        dy = cy[None, :] - ys[:, None]
        d = dx * dx + dy * dy
        d = jnp.where(kmask[None, :], d, jnp.uint32(0xFFFFFFFF))
        return jnp.argmin(d, axis=1).astype(jnp.int32)

    sharded = shard_map(
        _local, mesh=mesh,
        in_specs=(P("batch"), P("batch"), P(None), P(None), P(None)),
        out_specs=P("batch"),
    )
    return jax.jit(sharded)
