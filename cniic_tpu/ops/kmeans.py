"""K-means on the accelerator (reference src/kmeans.rs rebuilt for dense
device execution).

The reference spends its time in a CPU-clever assign loop (neighbour graphs,
certainty radii, watermark-adaptive pruning, kmeans.rs:145-416). On the
device the dense formulation wins outright: the assignment step is a
(points x d) @ (d x centroids) matmul + argmin, blocked over points so the
distance tile stays in budget; the update step is an exact integer
segment-sum. On the GPU the iteration runs as one fused Triton kernel
(ops/kmeans_pallas.py); this module's XLA body is its reference and the
path for every other backend and regime.

Semantics preserved from the reference:

* init: the point vector is split into k equal contiguous chunks from the
  tail, the initial centroid is the first point of each chunk
  (kmeans.rs:61-108);
* a point moves only to a *strictly* closer centroid — ties keep the
  current cluster (kmeans.rs:349-389);
* means are integer-truncated (u64 division) — weighted for color counts
  (clusterc.rs:92-113), plain component-wise for 5-D pixels
  (clusterc.rs:221-247);
* iteration runs until no point changes cluster (kmeans.rs:21-39);
* empty clusters are repaired by stealing a point (kmeans.rs:110-137) —
  here a hash-of-(iteration, cluster) pick over all points, applied inside
  the device loop (documented divergence: the reference draws
  cluster-then-member from thread_rng; empties are an early-iteration
  transient either way).

Dropped (pure CPU optimizations, no effect on results): the neighbour-graph
pruning and certainty-radius early-outs.

Batching: every device entry point carries a leading batch axis. The burst
loop iterates all lanes together and **freezes** a lane the moment its move
count reaches its stop threshold, so each lane's trajectory is bit-identical
to a single-image run (tested in tests/test_kmeans.py). This is the
reference's rayon-over-images parallelism (bench.rs:22-27) mapped onto a
batch dimension of the device program.
"""

from __future__ import annotations

import functools
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_enable_x64", True)

log = logging.getLogger(__name__)

_BLOCK = 16384


class CrossLaneBoundError(ValueError):
    """A batch-global bound (max_val * max_w across lanes) failed even though
    every lane passes alone — the only ValueError kmeans_batch may legally
    retry per-lane (ADVICE.md r2: a blanket ValueError catch was silently
    downgrading caller bugs like mixed-dimensionality batches)."""


def _assign_stats_xla(pts_f, pts_i, w, valid, cur, cents_f, k: int, bs: int,
                      vp: int, wp: int, pk: int, pw: int = 8,
                      split: int = 32, wide: bool = False):
    """Assignment + centroid statistics for one step (the shardable core).
    Shapes: pts [n_pad, d] (f32 / int32), w int32[n_pad] (0 for padding),
    valid bool[n_pad], cur int32[n_pad], cents_f f32[k, d].
    Returns (new int32[n_pad], sums int32[k, vp*d+wp], moved int32).

    Everything is dense: the assignment is a distance matmul + argmin,
    and the centroid statistics are one-hot matmuls over pw-bit digit planes
    of the weighted values — per-block f32 sums stay exact
    ((2^pw-1)*block <= 255*65536 < 2^24), cross-block accumulation is int32.
    The int32 sums are order-independent, so point-sharded partial sums
    psum'd over a mesh (parallel/mesh.py) are bit-identical to the
    single-device result. No scatters, no 64-bit ops (both are slow to
    compile and have crashed the worker on this stack at megapixel sizes).

    pw is the digit-plane width (8, or 4 for lanes with >= 2^23 points so
    a plane-sum column (2^pw-1)*n plus its carry stays inside int32 —
    VERDICT r3 #2 lifted the old hard 4M-point cap). split/wide extend the
    exact-distance argument to large coordinates; see the d2 comment.
    """
    n_pad, d = pts_f.shape
    nb = n_pad // bs
    kids = jnp.arange(k, dtype=jnp.int32)

    # digit planes of the weighted values + the weights themselves; the
    # static plane counts (vp, wp) come from the caller's value bounds so
    # the stats matmul carries no all-zero columns
    M = (1 << pw) - 1
    prod = pts_i * w[:, None]  # int32, bounded by the caller
    cols = [(prod >> (pw * i)) & M for i in reversed(range(vp))]
    wcols = [((w >> (pw * i)) & M)[:, None] for i in reversed(range(wp))]
    feats = jnp.concatenate(cols + wcols, axis=1).astype(jnp.bfloat16)  # (n, vp*d+wp)

    # EXACT squared distances with the cross term as a matmul. A plain f32
    # dot is not exact on every backend — on the GPU it may run in TF32,
    # which keeps ~10 mantissa bits, and noisy distances make boundary
    # points limit-cycle — so p.c is computed from an exact hi/lo split
    # instead: with split=32, per-dim values <= 8191 give hi <= 255 and
    # lo < 32, both exactly bf16-representable (bf16 holds all integers
    # <= 256); split=64 extends that to values <= 16383 (hi <= 255,
    # lo < 64). Every bf16 partial product is exact in the f32 accumulator
    # and each of the three f32 accumulations stays below 2^24. Any f32
    # product added here must state precision=HIGHEST.
    #
    # Narrow path (wide=False, d2_bound < 2^24): d2 is assembled in f32 as
    # (|p|^2 - p.c) + (|c|^2 - p.c) so every intermediate is an integer
    # within the d2 bound — decisions match f64 exactly, and the (bs, k)
    # tiles are touched once.
    #
    # Wide path (wide=True, d2_bound >= 2^24, e.g. 4K images — VERDICT r3
    # #2): the dot products themselves exceed the f32 integer-exact range,
    # so each sub-2^24 matmul piece is converted to int32 and d2, |p|^2,
    # |c|^2 and the current-distance term are all assembled in int32
    # (bounds: pc <= d2_bound <= 2*16383^2 + 3*255^2 < 2^30, so
    # psq + csq - 2*pc never wraps). Same decisions as f64, at the cost of
    # int32 assembly per tile.
    S = float(split)
    c_hi = jnp.floor(cents_f / S)
    c_lo = cents_f - c_hi * S
    c_mix = jnp.concatenate([c_lo, c_hi], axis=1)  # (k, 2d)
    bf = jnp.bfloat16
    if wide:
        ci = cents_f.astype(jnp.int32)
        csq_i = jnp.sum(ci * ci, axis=1)  # (k,) int32, exact
    else:
        csq = jnp.sum(cents_f * cents_f, axis=1)  # (k,)

    def block(args):
        if wide:
            p, c, f, pib = args
        else:
            p, c, f = args
        p_hi = jnp.floor(p / S)
        p_lo = p - p_hi * S
        m_hh = jnp.dot(p_hi.astype(bf), c_hi.astype(bf).T,
                       preferred_element_type=jnp.float32)
        m_mix = jnp.dot(jnp.concatenate([p_hi, p_lo], axis=1).astype(bf),
                        c_mix.astype(bf).T, preferred_element_type=jnp.float32)
        m_ll = jnp.dot(p_lo.astype(bf), c_lo.astype(bf).T,
                       preferred_element_type=jnp.float32)
        if wide:
            pc_i = (jnp.int32(split * split) * m_hh.astype(jnp.int32)
                    + jnp.int32(split) * m_mix.astype(jnp.int32)
                    + m_ll.astype(jnp.int32))  # (bs, k) exact int32
            psq_i = jnp.sum(pib * pib, axis=1)  # (bs,) int32, exact
            d2 = (psq_i[:, None] - pc_i) + (csq_i[None, :] - pc_i)
            dd = pib - ci[c]
            cur_d2 = jnp.sum(dd * dd, axis=-1)  # int32, exact
        else:
            pc = S * S * m_hh + S * m_mix + m_ll  # (bs, k) exact integers
            psq = jnp.sum(p * p, axis=1)  # (bs,)
            d2 = (psq[:, None] - pc) + (csq[None, :] - pc)
            cur_c = cents_f[c]
            cur_d2 = jnp.sum((p - cur_c) * (p - cur_c), axis=-1)
        if pk:
            # single packed min-reduce = argmin + min in one pass. pk is the
            # next power of two >= k and the host guarantees
            # d2_bound * pk < 2^31, so d2*pk + idx is an exact int32 whose
            # min recovers (min d2, smallest index among ties) — the same
            # first-index tie rule as argmin.
            kidx = jnp.arange(k, dtype=jnp.int32)[None, :]
            packed = jnp.min(d2.astype(jnp.int32) * pk + kidx, axis=1)
            best = (packed % pk).astype(jnp.int32)
            new_b = jnp.where(packed // pk < cur_d2.astype(jnp.int32), best, c)
        else:
            best = jnp.argmin(d2, axis=1).astype(jnp.int32)
            best_d2 = jnp.min(d2, axis=1)
            new_b = jnp.where(best_d2 < cur_d2, best, c)
        onehot = (new_b[:, None] == kids[None, :]).astype(jnp.bfloat16)  # (bs, k)
        # exact: 0/1 x values <= (2^pw - 1), block sums <= 255*bs < 2^24
        sums_b = jnp.dot(onehot.T, f, preferred_element_type=jnp.float32)
        return new_b, sums_b.astype(jnp.int32)

    operands = (pts_f.reshape(nb, bs, d), cur.reshape(nb, bs),
                feats.reshape(nb, bs, vp * d + wp))
    if wide:
        operands = operands + (pts_i.reshape(nb, bs, d),)
    new, sums_blocks = jax.lax.map(block, operands)
    new = jnp.where(valid, new.reshape(-1), 0)
    moved = jnp.sum((new != cur).astype(jnp.int32), dtype=jnp.int32)
    sums = jnp.sum(sums_blocks, axis=0, dtype=jnp.int32)  # (k, vp*d+wp)
    return new, sums, moved


def _iteration(pts_f, pts_i, w, valid, cur, cents_f, k: int, it, n, bs: int,
               vp: int, wp: int, pk: int, pw: int = 8, split: int = 32,
               wide: bool = False):
    """One full assign+update step: the shardable core + integer means."""
    new, sums, moved = _assign_stats_xla(
        pts_f, pts_i, w, valid, cur, cents_f, k, bs, vp, wp, pk, pw, split,
        wide)
    cents_i, empty = _means_from_sums(sums, pts_i, k, it, n, vp, wp, pw)
    return new, cents_i, empty, moved


def _means_div(sums, d: int, k: int, vp: int, wp: int, pw: int = 8):
    """Integer-truncated means from the digit-plane statistics.
    sums int32[k, vp*d+wp]. Returns (cents int32[k, d], wsum int32[k])."""
    base = 1 << pw
    Mk = base - 1
    wsum = jnp.zeros((k,), jnp.int32)
    for i in range(wp):
        wsum = wsum * base + sums[:, vp * d + i]
    denom = jnp.maximum(wsum, 1)[:, None]
    # The value-plane columns are *plane sums* (each <= (2^pw - 1)*n), not
    # digits. Normalize them into true base-2^pw digits by carry
    # propagation, then long-divide in base 16 so every intermediate fits
    # int32: the running remainder stays < denom <= total weight and the
    # host guards total weight < 2^27, so rem*16 + nibble < 2^31. (The
    # previous base-256 division overflowed once a cluster's weight crossed
    # ~2^23 and silently corrupted the palette — ADVICE.md round 1.)
    digits = []  # least-significant first
    carry = jnp.zeros((k, d), jnp.int32)
    for i in reversed(range(vp)):
        v = sums[:, i * d : (i + 1) * d] + carry
        digits.append(v & Mk)
        carry = v >> pw
    # residual carry < n (pw=8, n < 2^23: 3 bytes + slack; pw=4, n < 2^27:
    # 7 nibbles + slack)
    for _ in range(4 if pw == 8 else 8):
        digits.append(carry & Mk)
        carry = carry >> pw
    rem = jnp.zeros((k, d), jnp.int32)
    out = jnp.zeros((k, d), jnp.int32)
    shifts = (4, 0) if pw == 8 else (0,)
    for dig in reversed(digits):
        for shift in shifts:
            cur_v = rem * 16 + ((dig >> shift) & 0xF)
            q = cur_v // denom
            rem = cur_v - q * denom
            out = out * 16 + q
    return out, wsum


def _steal_indices(k: int, it, n):
    """Empty-cluster repair picks (kmeans.rs:110-137 steals a random point;
    here the "random" pick is a Weyl-sequence hash of (iteration, cluster)
    over the valid points — documented RNG divergence, empties are a
    transient of early iterations)."""
    mix = (it + 1) * jnp.int32(-1640531527) + jnp.arange(k, dtype=jnp.int32) * jnp.int32(40503)
    return (mix & jnp.int32(0x7FFFFFFF)) % jnp.maximum(n, 1)


def _means_from_sums(sums, pts_i, k: int, it, n, vp: int, wp: int,
                     pw: int = 8):
    """Integer-truncated means + on-device empty-cluster repair.
    sums int32[k, vp*d+wp]; pts_i int32[n_pad, d] is the steal source.
    Returns (cents int32[k, d], empty bool[k])."""
    d = pts_i.shape[1]
    cents_i, wsum = _means_div(sums, d, k, vp, wp, pw)
    empty = wsum == 0
    steal = _steal_indices(k, it, n)
    cents_i = jnp.where(empty[:, None], pts_i[steal], cents_i)
    return cents_i, empty


@jax.jit
def _widen(pu, wu, cu):
    """Widen the narrow uploaded arrays to the loop's working set on device."""
    pi = pu.astype(jnp.int32)
    return pi.astype(jnp.float32), pi, wu.astype(jnp.int32), cu.astype(jnp.int32)


def _widen_init_body(pu, w_i32, n_dev, k: int):
    """Shared body of the upload-widening entry points: build the init
    state on device. The valid mask, the tail-chunk initial assignment
    (kmeans.rs:61-78) and the first-point-of-chunk centroids are all pure
    index arithmetic over (n, k), so uploading them (2-3 B/point in the
    old layout) was wasted host-to-device traffic. Bit-identical to the
    host-built
    state (pinned by the batch==sequential and golden-stream tests)."""
    B, n_pad, d = pu.shape
    pi = pu.astype(jnp.int32)
    idx = jnp.arange(n_pad, dtype=jnp.int32)

    def lane(p, n):
        ppc = n // k
        tail_start = n - (k - 1) * ppc
        valid = idx < n
        cur = jnp.where(idx < tail_start, k - 1,
                        (n - 1 - idx) // jnp.maximum(ppc, 1)).astype(jnp.int32)
        cur = jnp.where(valid, cur, 0)
        kk = jnp.arange(k, dtype=jnp.int32)
        cents_idx = jnp.where(kk == k - 1, 0, n - (kk + 1) * ppc)
        return valid, cur, p[cents_idx]

    valid, cur, cents = jax.vmap(lane)(pi, n_dev.astype(jnp.int32))
    return pi.astype(jnp.float32), pi, w_i32, valid, cur, cents


@functools.partial(jax.jit, static_argnames=("k",))
def _widen_init(pu, wu, n_dev, k: int):
    """Widen narrow uploads (weights fit their upload dtype whole) and
    build the init state on device — see `_widen_init_body`."""
    return _widen_init_body(pu, wu.astype(jnp.int32), n_dev, k)


@functools.partial(jax.jit, static_argnames=("k",))
def _widen_init_ovf(pu, wlo, ovf_lane, ovf_pos, ovf_hi, n_dev, k: int):
    """u16 weight upload + sparse high-part reassembly: weights are color
    frequencies, so a handful per lane can exceed 65535 (a flat region)
    while the bulk fit u16 — uploading int32 for all of them doubles the
    largest host-to-device transfer of the k-means stage. The low
    halves ride as one u16 plane and the few (lane, pos, hi) overflow
    triples are scattered back on device; the overflow arrays are padded
    to a coarse pow2 bucket (>= _OVF_MIN) with (0, 0, 0) entries — adding
    a zero high part at (0, 0) is a no-op, so padding is exactness-free."""
    w = wlo.astype(jnp.int32)
    w = w.at[ovf_lane, ovf_pos].add(
        ovf_hi.astype(jnp.int32) << 16, mode="drop")
    return _widen_init_body(pu, w, n_dev, k)


# a lane also freezes after this many consecutive iterations without a 2%
# move-count improvement — the plateau safety net for pathological limit
# cycles above the 0.1% threshold. Evaluated per iteration ON DEVICE so the
# trigger point is a pure function of the lane's own trajectory (burst
# boundaries and batch composition cannot shift it — encode_batch stays
# bit-identical to per-image encode even for plateauing lanes).
_STALL_LIMIT = 64


def _plateau_update(act, new_moved, best, stall):
    """Shared stall bookkeeping. The 2% bar is computed by subtraction
    (best - best//50) so the comparison never overflows int32 even for the
    point-sharded path's huge sets (a multiply form wrapped at ~21.5M)."""
    improved = new_moved < best - best // 50
    best = jnp.where(jnp.logical_and(act, improved), new_moved, best)
    stall = jnp.where(act, jnp.where(improved, 0, stall + 1), stall)
    return best, stall


@functools.partial(jax.jit, static_argnames=("k", "max_iters", "bs", "vp",
                                             "wp", "pk", "pw", "split",
                                             "wide", "stall_lim"))
def _kmeans_loop(pts_f, pts_i, w, valid, cur, cents_i, n, thresh, moved0,
                 best0, stall0, it0,
                 k: int, max_iters: int, bs: int = _BLOCK, vp: int = 4,
                 wp: int = 4, pk: int = 0, pw: int = 8, split: int = 32,
                 wide: bool = False, stall_lim: int = _STALL_LIMIT):
    """One device burst over a batch of lanes (leading axis B everywhere).

    Iterates until every lane is frozen (move count at or below its
    `thresh`, or `stall_lim` iterations without a 2% improvement) or the
    burst cap is hit. A frozen lane's assignment/centroids stop updating,
    so per-lane results are bit-identical to running that lane alone.
    `moved0`/`best0`/`stall0` carry the per-lane state across bursts.
    """

    def one_lane(pf, pi, wi, va, cu, ce, it, ni):
        return _iteration(pf, pi, wi, va, cu, ce, k, it, ni, bs, vp, wp, pk,
                          pw, split, wide)

    def active(moved, stall):
        return jnp.logical_and(moved > thresh, stall < stall_lim)

    def cond(state):
        it, _, _, moved, _, stall = state
        return jnp.logical_and(jnp.any(active(moved, stall)),
                               it < it0 + max_iters)

    def body(state):
        it, cur, cents_i, moved, best, stall = state
        new, cents_new, _, new_moved = jax.vmap(
            one_lane, in_axes=(0, 0, 0, 0, 0, 0, None, 0)
        )(pts_f, pts_i, w, valid, cur, cents_i.astype(jnp.float32), it, n)
        act = active(moved, stall)
        cur = jnp.where(act[:, None], new, cur)
        cents_i = jnp.where(act[:, None, None], cents_new, cents_i)
        moved = jnp.where(act, new_moved, moved)
        best, stall = _plateau_update(act, new_moved, best, stall)
        return it + 1, cur, cents_i, moved, best, stall

    state = (it0, cur, cents_i, moved0, best0, stall0)
    return jax.lax.while_loop(cond, body, state)


@functools.partial(jax.jit, static_argnames=("k",))
def _active_counts(cur, valid, k: int):
    """Distinct assigned clusters per lane: (B, n_pad) -> int32[B]."""

    def one(c, v):
        hits = jnp.zeros((k,), jnp.int32).at[jnp.where(v, c, k)].add(
            1, mode="drop")
        return jnp.sum((hits > 0).astype(jnp.int32))

    return jax.vmap(one)(cur, valid)


@functools.partial(jax.jit, static_argnames=("k",))
def _pack_results_u8(cur, cents, k: int):
    """u8 variant of `_pack_results_u16` for the RGB-palette case
    (k <= 256, centroid components <= 255): the assignment fetch is the
    largest device-to-host transfer of the k-means stage, and halving its
    width is free when ids and colors both fit a byte."""
    B = cur.shape[0]
    return jnp.concatenate(
        [cur.astype(jnp.uint8),
         cents.reshape(B, k * cents.shape[2]).astype(jnp.uint8)], axis=1)


@functools.partial(jax.jit, static_argnames=("k",))
def _pack_results_u16(cur, cents, k: int):
    """Assignment + centroids as ONE uint16 array: one device-to-host
    fetch instead of two, packed when values fit u16 (cur < k <= 65535; centroid
    components <= max_val <= 65535 — truncated means / stolen points stay
    within the input range)."""
    B = cur.shape[0]
    return jnp.concatenate(
        [cur.astype(jnp.uint16),
         cents.reshape(B, k * cents.shape[2]).astype(jnp.uint16)], axis=1)


@functools.partial(jax.jit, static_argnames=("k",))
def _voronoi_finish_u16(cur, valid, cents, k: int):
    """Active-cluster counts + centroids in ONE uint16 fetch (voronoi
    doesn't need the assignment on host; coords <= 2047 and colors <= 255
    both fit u16). Saves two device-to-host fetches per bucket."""
    B = cur.shape[0]
    actives = _active_counts.__wrapped__(cur, valid, k).astype(jnp.uint16)
    return jnp.concatenate(
        [actives[:, None],
         cents.reshape(B, k * cents.shape[2]).astype(jnp.uint16)], axis=1)


def plan_params(max_val: int, max_w: int, d2_bound: int, k: int,
                n_max: int = 0):
    """Static iteration parameters from the value bounds (shared by the
    single-chip prep and the sharded step so the two can't drift):

    * bs — point block: bigger blocks amortize per-step dispatch overhead;
      cap the distance tile at ~32MB (bs * k * 4B);
    * vp/wp — digit-plane counts for the weighted values / weights;
    * pk — packed argmin+min single-reduce factor: exact only while
      d2*pk + idx fits int32 (d2 is bounded by the per-dim maxima;
      centroids are truncated means or stolen points, so they stay within
      the same per-dim ranges); 0 disables packing;
    * pw — digit-plane width: 8 while a plane-sum column plus its carry
      fits int32 ((2^pw)*n < 2^31, i.e. n < 2^23), else 4 (n < 2^27 — the
      total-weight cap binds first). VERDICT r3 #2: this is what lifted
      the old hard 4M-point cap;
    * split — hi/lo base of the exact bf16 distance split: 32 keeps
      hi <= 255 (bf16-exact) up to values of 8191, 64 up to 16383;
    * wide — d2 int32-assembly flag: required once d2_bound reaches 2^24
      (dot products leave the f32 integer-exact range — 4K+ images).
    """
    bs = 65536 if k <= 512 else _BLOCK
    bs = int(os.environ.get("CNIIC_KMEANS_BS", bs))
    pw = 8 if n_max < (1 << 23) else 4
    vp = max(1, ((max_val * max_w).bit_length() + pw - 1) // pw)
    wp = max(1, (max_w.bit_length() + pw - 1) // pw)
    pkc = 1 << max(k - 1, 0).bit_length()
    pk = pkc if (d2_bound + 1) * pkc < 2**31 else 0
    split = 32 if max_val <= 8191 else 64
    wide = d2_bound >= (1 << 24)
    return bs, vp, wp, pk, pw, split, wide


def _stop_threshold(n: int) -> int:
    """Practical convergence (documented divergence from the reference's
    strict till-no-change, kmeans.rs:26): with integer-truncated means at
    megapixel scale a small fraction of boundary points limit-cycles
    indefinitely while the clustering cost is long flat, so a lane stops
    once fewer than 0.1% of its points still move. CNIIC_KMEANS_STRICT=1
    restores the strict rule (used by scripts/convergence_study.py, which
    measured zero frontier impact — table in PARITY.md)."""
    if os.environ.get("CNIIC_KMEANS_STRICT", "") == "1":
        return 0
    return max(n >> 10, 0)


def _pallas_block(n_pad: int, k: int, d2b: int):
    """(bs, kt, sub) blocks for the fused Triton iteration, or None to use the
    XLA body. Selected on the GPU backend; the one-matmul cross term needs
    d2b < 2^24 (p.c exactness), and the kernel's two-reduction variant
    covers any k where the packed single-reduction key would leave int32.
    CNIIC_PALLAS_KMEANS=0 forces XLA (the A/B switch), =1 forces the kernel
    on any backend (interpret mode off the GPU — parity tests)."""
    mode = os.environ.get("CNIIC_PALLAS_KMEANS", "")
    if mode == "0" or d2b >= 1 << 24:
        return None
    gpu = jax.default_backend() == "gpu"
    if mode != "1" and not gpu:
        return None
    from . import kmeans_pallas

    return kmeans_pallas.pick_block(n_pad, k, interpret=not gpu)


def _pow2_floor(v: int) -> int:
    return 1 << (max(int(v), 1).bit_length() - 1)


def _pow2_ceil(v: int) -> int:
    v = max(int(v), 1)
    return 1 << (v - 1).bit_length()


def _pad_bucket(n: int, bs: int) -> int:
    """Padded point count: the block multiple rounded up a coarse ladder
    (powers of two and 1.5x, in units of bs — worst-case ~50% padding
    just past a pow2 rung, 33% past a 1.5x rung; pinned by
    test_pad_bucket_ladder_properties). The
    padded size is a SHAPE, i.e. a compile key of every loop executable:
    at natural-image statistics the per-batch unique-color count made
    every 65536-block count a fresh compile.
    Padding rows carry weight 0 and valid=False, so results are invariant
    (pinned by the batch==sequential tests); per-iteration compute over
    the extra rows is bounded by the ladder step and is orders below the
    compile it replaces."""
    blocks = -(-n // bs)
    p = _pow2_ceil(blocks)
    if p > 2 and 3 * (p // 4) >= blocks:
        p = 3 * (p // 4)
    return p * bs


def _burst(n_max: int, B: int) -> int:
    """Iterations per device call of the burst loop (static jit arg —
    must be a coarse function of the batch, see _drive's docstring)."""
    return _pow2_floor(max(4, min(64, (1 << 23) // max(n_max * B // 8, 1))))


def static_compile_key(ns_max: int, max_val: int, max_w: int,
                       d2_bound: int, k: int, B: int,
                       w_bound=None) -> dict:
    """Single source of truth for the static compile key of one batched
    k-means run. Every entry is either a shape or a static jit arg of a
    device executable; two batches with equal dicts share every compiled
    program. `_prep_host_batch` derives its plan FROM this call and
    `_drive` computes its bursts via the same `_burst` leaf, so a corpus census over this function
    (scripts/experiments/kmeans_key_census.py) cannot desync from
    production (r5 review). `pts_dtype`/`w_dtype` key only the cheap
    `_widen_init` widening (at most a handful of variants), not the loop
    executables — they are derived from the MEASURED maxima to keep the
    uploads narrow; everything else is content-independent under a
    structural `w_bound`."""
    plan_w = max_w
    if w_bound is not None:
        if int(w_bound) < max_w:
            raise ValueError(
                f"w_bound {w_bound} below measured max weight {max_w}")
        plan_w = int(w_bound)
    bs, vp, wp, pk, pw, split, wide = plan_params(
        max_val, plan_w, d2_bound, k, ns_max)
    n_pad = _pad_bucket(ns_max, bs)
    pkc = 1 << max(k - 1, 0).bit_length()
    return {
        "n_pad": n_pad, "bs": bs, "vp": vp, "wp": wp, "pk": pk, "pw": pw,
        "split": split, "wide": wide,
        "burst": _burst(n_pad, B),
        "packed": (d2_bound + 1) * 2 * pkc < 2**31,
        "B": B,
        "pts_dtype": ("u8" if max_val <= 255 else
                      "i16" if max_val <= 32767 else "i32"),
        # weights >= 256 upload as u16 low halves + a padded sparse
        # overflow scatter (_widen_init_ovf) — ONE tier for every
        # max_w >= 256, so the key census stays as coarse as the old
        # u8/i32 split while the dominant upload halves (total weight
        # < 2^27 bounds any weight to 27 bits, so hi parts fit u16)
        "w_dtype": "u8" if max_w < 256 else "u16ovf",
    }


def _drive(pts_f, pts_i, w, valid, cur, cents, n_arr, k: int, bs: int,
           vp: int, wp: int, pk: int, pw: int, split: int, wide: bool,
           d2b: int, max_iters: int):
    """Host burst driver around the device iteration loop.

    The convergence loop runs on device in bounded bursts of iterations;
    the host reads the per-lane stop state between calls. Burst size
    scales down with point count to keep per-call runtime bounded.
    Returns (iters, cur_dev, cents_dev).

    Compile-cache discipline: `burst` is a STATIC jit arg of the loop
    bodies, and its raw value would be a fine-grained function of the
    batch content (exact max point count): at natural-image statistics it
    was near-unique per batch, so every kmeans burst recompiled the loop
    at a compile each). It is therefore a pure function of the padded shape bucket,
    quantized to a power of two: burst only splits the identical
    trajectory into device calls (state carries across bursts —
    bit-identical by the chunking tests).
    """
    B = int(n_arr.size)
    thresh = np.array([_stop_threshold(int(n)) for n in n_arr], np.int32)
    # the burst shrinks with the lane count; it is sized from the PADDED
    # point count, which makes it a pure function of the shape bucket (no
    # extra compile variants)
    n_padded = int(pts_i.shape[1])
    burst = _burst(n_padded, B)
    thresh_dev = jnp.asarray(thresh)
    n_dev = jnp.asarray(n_arr.astype(np.int32))
    moved = n_arr.astype(np.int64) + 1  # seed: every lane active
    strict = os.environ.get("CNIIC_KMEANS_STRICT", "") == "1"
    # strict mode restores the reference's pure till-no-change rule: both
    # the 0.1% threshold (thresh=0 via _stop_threshold) and the plateau
    # net are disabled
    stall_lim = (1 << 30) if strict else _STALL_LIMIT
    best_dev = jnp.asarray((n_arr + 1).astype(np.int32))
    stall_dev = jnp.asarray(np.zeros(B, np.int32))

    mesh = None
    if B > 1:
        from ..parallel import mesh as pmesh

        mesh = pmesh.batch_mesh(B)
    # the fused kernel's one-matmul cross term and 8-bit plane rows cover
    # the narrow regime only; wide/4-bit-plane lanes take the XLA body
    blocks = None if (wide or pw != 8 or split != 32) else _pallas_block(
        n_padded, k, d2b)
    if mesh is not None:
        # multi-device: lanes over devices (the reference's rayon-over-
        # images, bench.rs:22-27, as data parallelism). The XLA body is
        # GSPMD-partitioned automatically; the fused kernel is shard_map'd
        # over the lane axis — per-lane trajectories are device-count-
        # independent either way.
        (pts_f, pts_i, w, valid, cur, cents, n_dev, thresh_dev) = \
            pmesh.shard_batch(mesh, pts_f, pts_i, w, valid, cur, cents,
                              n_dev, thresh_dev)
    if blocks is not None:
        from . import kmeans_pallas

        bs_p, kt, sub = blocks
        pop, feat = kmeans_pallas.point_operands(pts_i, w, vp, wp)
        interp = jax.default_backend() != "gpu"
        # the kernel always needs the pow2 >= k for its tiebreak encoding,
        # even when the packed single-reduction key is out of int32 range
        pkc = 1 << max(k - 1, 0).bit_length()
        packed = (d2b + 1) * 2 * pkc < 2**31

        if mesh is not None:
            step = kmeans_pallas.kmeans_loop_pallas_sharded(
                mesh, k, burst, bs_p, kt, sub, vp, wp, pkc, packed,
                stall_lim, interp)

            def run_burst(cur, cents, moved_seed, best_s, stall_s, it):
                its, cur, cents, moved, best, stall = step(
                    pop, feat, pts_i, cur, cents, n_dev, thresh_dev,
                    moved_seed, best_s, stall_s, jnp.int32(it))
                return jnp.max(its), cur, cents, moved, best, stall
        else:
            def run_burst(cur, cents, moved_seed, best_s, stall_s, it):
                return kmeans_pallas.kmeans_loop_pallas(
                    pop, feat, pts_i, cur, cents, n_dev, thresh_dev,
                    moved_seed, best_s, stall_s, jnp.int32(it), k, burst,
                    bs_p, kt, sub, vp, wp, pkc, packed=packed,
                    stall_lim=stall_lim, interpret=interp)
    else:
        def run_burst(cur, cents, moved_seed, best_s, stall_s, it):
            return _kmeans_loop(
                pts_f, pts_i, w, valid, cur, cents, n_dev, thresh_dev,
                moved_seed, best_s, stall_s, jnp.int32(it), k, burst,
                bs=bs, vp=vp, wp=wp, pk=pk, pw=pw, split=split, wide=wide,
                stall_lim=stall_lim)

    it = 0
    stall = np.zeros(B, np.int64)
    while it < max_iters and ((moved > thresh) & (stall < stall_lim)).any():
        it_dev, cur, cents, moved_dev, best_dev, stall_dev = run_burst(
            cur, cents, jnp.asarray(moved.astype(np.int32)), best_dev,
            stall_dev, it)
        it = int(it_dev)
        moved = np.asarray(moved_dev).astype(np.int64)
        stall = np.asarray(stall_dev).astype(np.int64)
    plateaued = (moved > thresh) & (stall >= stall_lim)
    if plateaued.any():
        log.info("k-means: %d lane(s) plateaued at %s moves (%d iterations)",
                 int(plateaued.sum()), moved[plateaued].tolist(), it)
    return it, cur, cents


# overflow-array pad floor for the u16+sparse weight upload: a 1 MP lane
# can hold at most 15 frequencies >= 65536, so 128 covers standard 8-lane
# batches with zero variants; bigger batches grow up the pow2 ladder
_OVF_MIN = 128


def _split_weights_u16(w: np.ndarray):
    """Split int32 weights (B, n_pad) into the u16 low plane + padded
    sparse (lane, pos, hi) overflow triples for `_widen_init_ovf`."""
    wlo = (w & 0xFFFF).astype(np.uint16)
    lanes, poss = np.nonzero(w >= 65536)
    n_ovf = _pow2_ceil(max(len(lanes), _OVF_MIN))
    ovf_lane = np.zeros(n_ovf, np.int32)
    ovf_pos = np.zeros(n_ovf, np.int32)
    ovf_hi = np.zeros(n_ovf, np.uint16)
    ovf_lane[:len(lanes)] = lanes
    ovf_pos[:len(lanes)] = poss
    ovf_hi[:len(lanes)] = (w[lanes, poss] >> 16).astype(np.uint16)
    return wlo, ovf_lane, ovf_pos, ovf_hi


def _prep_host_batch(points_list, k: int, weights_list, w_bound=None):
    """Validate + pad a host-side point batch; returns everything `_drive`
    needs plus the per-lane true sizes.

    w_bound: optional STRUCTURAL upper bound on any single weight (e.g.
    the lane's pixel count when weights are color frequencies). The
    digit-plane counts vp/wp are compile keys of every loop executable,
    and deriving them from the MEASURED per-batch max weight made them
    content-dependent: at north-star statistics max_w flips bit-length
    tiers between chunks, so scattered chunks paid a fresh compile
    (r5 follow-up; the same fragmentation class as the point-count pad
    buckets). A caller-supplied shape-driven bound makes vp/wp pure
    functions of the image geometry. Larger vp/wp are exactness-neutral:
    the planes are a base-2^pw decomposition of the same integers, extra
    leading planes are zero (pinned by tests/test_kmeans.py)."""
    B = len(points_list)
    points_list = [np.asarray(p) for p in points_list]
    d = points_list[0].shape[1]
    ns = np.array([p.shape[0] for p in points_list], np.int64)
    if weights_list is None:
        weights_list = [None] * B
    for p, wl in zip(points_list, weights_list):
        if p.shape[1] != d:
            raise ValueError("kmeans batch lanes must share dimensionality")
        _validate_lane(p, wl, k)
    max_val = max(int(p.max(initial=0)) for p in points_list)
    max_w = max(
        1 if wl is None else max(int(np.max(wl)), 1) for wl in weights_list)
    max_prod = max_val * max_w
    if max_prod >= 2**31:
        # note: a GLOBAL bound — lanes that pass alone can violate it in a
        # mixed batch; kmeans_batch(on_error="collect") falls back to
        # per-lane runs when that happens
        raise CrossLaneBoundError("kmeans weighted values must fit int32")

    d2_bound = max(
        int(np.sum(p.max(axis=0, initial=0).astype(np.int64) ** 2))
        for p in points_list)
    plan = static_compile_key(int(ns.max()), max_val, max_w, d2_bound,
                              k, B, w_bound=w_bound)
    bs, vp, wp, pk, pw, split, wide = (
        plan["bs"], plan["vp"], plan["wp"], plan["pk"], plan["pw"],
        plan["split"], plan["wide"])
    n_pad = plan["n_pad"]
    pts_i = np.zeros((B, n_pad, d), dtype=np.int32)
    w = np.zeros((B, n_pad), dtype=np.int32)
    for b, (p, wl) in enumerate(zip(points_list, weights_list)):
        n = p.shape[0]
        pts_i[b, :n] = p
        w[b, :n] = 1 if wl is None else wl

    # Narrow uploads (host-to-device bytes scale with megapixel point
    # counts): points as uint8 when they are colors,
    # int16 below the exactness bound; weights as uint8 when they fit.
    # The valid mask, tail-chunk init assignment and first-point centroids
    # are index arithmetic and are built ON DEVICE (_widen_init) instead
    # of being uploaded (r3: they were 3-4 B/point of pure overhead).
    # Upload dtypes come from the plan's MEASURED-maxima entries (not
    # plan_w): they key only the cheap _widen_init widening (at most a
    # handful of variants — the loop executables see the widened int32
    # either way), so keeping the narrow upload costs nothing in loop
    # recompiles (r5 review)
    pts_up = pts_i.astype({"u8": np.uint8, "i16": np.int16,
                           "i32": np.int32}[plan["pts_dtype"]])
    if plan["w_dtype"] == "u16ovf":
        wlo_up, ovf_lane, ovf_pos, ovf_hi = _split_weights_u16(w)
        (pts_f, pts_i_dev, w_dev, valid_dev, cur_dev,
         cents_dev) = _widen_init_ovf(
            jnp.asarray(pts_up), jnp.asarray(wlo_up), jnp.asarray(ovf_lane),
            jnp.asarray(ovf_pos), jnp.asarray(ovf_hi),
            jnp.asarray(ns.astype(np.int32)), k)
    else:
        # "i32" is unreachable from static_compile_key (total weight
        # < 2^27 bounds every weight) but kept as the reference upload
        # for the tier bit-identity test
        w_up = w.astype(np.uint8) if plan["w_dtype"] == "u8" else w
        pts_f, pts_i_dev, w_dev, valid_dev, cur_dev, cents_dev = _widen_init(
            jnp.asarray(pts_up), jnp.asarray(w_up),
            jnp.asarray(ns.astype(np.int32)), k)
    return (pts_f, pts_i_dev, w_dev, valid_dev, cur_dev, cents_dev, ns,
            bs, vp, wp, pk, pw, split, wide, d2_bound)


def _validate_lane(p: np.ndarray, wl, k: int) -> None:
    """Cheap per-lane feasibility checks (no padding, no uploads)."""
    n = p.shape[0]
    if k < 1:
        # before n // k: k == 0 must reject like every other infeasible k,
        # not escape collect-mode's ValueError isolation as ZeroDivisionError
        raise ValueError(f"k-means needs k >= 1 (got {k})")
    if n < k:
        raise ValueError(f"k-means needs at least k points ({n} < {k})")
    if n // k == 0:
        raise ValueError("points_per_cluster must be > 0 (kmeans.rs:68)")
    if n >= 2**27:
        # 4-bit digit planes carry any point count the weight cap admits
        # (VERDICT r3 #2 lifted the old 4M cap); the total-weight bound
        # below is what actually binds
        raise ValueError("kmeans point count must be < 2^27 (~134M)")
    if int(p.max(initial=0)) > 16383:
        # the base-64 hi/lo split keeps hi <= 255 (bf16-exact) only up to
        # 16383 — covers 16k x 16k coordinate grids
        raise ValueError("kmeans coordinate values must be <= 16383")
    max_w = 1 if wl is None else max(int(np.max(wl)), 1)
    if int(p.max(initial=0)) * max_w >= 2**31:
        raise ValueError("kmeans weighted values must fit int32")
    tot = n if wl is None else int(np.asarray(wl, np.int64).sum())
    if tot >= 2**27:
        # the base-16 long division's remainder bound (see _iteration)
        raise ValueError("kmeans total weight must be < 2^27 (~134M pixels)")


def _check_active(active: int, k: int, n: int) -> None:
    min_required = min(n, int(0.99 * k))
    if active < min_required:
        # the reference fails hard here (assert!, kmeans.rs:41-57); the
        # runner's per-image continue-on-error is the analog of the panic
        # aborting that image. CNIIC_KMEANS_LAX=1 downgrades to a warning.
        msg = (f"Not enough active clusters: requested {k}, got {active} "
               f"(min allowed: {min_required})")
        if os.environ.get("CNIIC_KMEANS_LAX", "") == "1":
            log.warning("k-means: %s", msg)
        else:
            raise AssertionError(msg)


def kmeans_batch(points_list, k: int, weights_list=None,
                 max_iters: int = 10_000, on_error: str = "raise",
                 w_bound=None):
    """Cluster a batch of integer point sets in lockstep on the device.

    points_list: list of (n_i, d) nonnegative integer arrays (n_i may vary;
    lanes are padded to a common block multiple and masked).
    weights_list: optional list of (n_i,) positive integer frequency weights.
    Returns a list of (centroids int64[k, d], assignment int32[n_i], iters).

    on_error="collect": a lane that fails validation (too few points,
    weight bounds) or the active-cluster floor yields its exception IN
    PLACE of the result tuple instead of aborting the whole batch (the
    runner's per-image continue-on-error then isolates that image,
    mirroring the reference panic's per-image blast radius).

    Batches deeper than CNIIC_KMEANS_LANES (default 8) run as consecutive
    lane chunks: per-lane trajectories are independent (lanes freeze on
    their own stop rule), so results are bit-identical to any chunking,
    and deeper lockstep adds straggler iterations (every lane iterates
    until the chunk's slowest lane converges).
    """
    max_lanes = int(os.environ.get("CNIIC_KMEANS_LANES", "8"))
    if len(points_list) > max_lanes > 0:
        if weights_list is None:
            weights_list = [None] * len(points_list)
        chunks = [(points_list[i:i + max_lanes],
                   weights_list[i:i + max_lanes])
                  for i in range(0, len(points_list), max_lanes)]
        return _kmeans_batch_chunks(chunks, k, max_iters, on_error, w_bound)
    if on_error == "collect":
        keep, errs = [], {}
        if weights_list is None:
            weights_list = [None] * len(points_list)
        for i, (p, wl) in enumerate(zip(points_list, weights_list)):
            try:
                _validate_lane(np.asarray(p), wl, k)
            except (ValueError, AssertionError) as e:
                errs[i] = e
                continue
            keep.append(i)
        if errs:
            out: list = [None] * len(points_list)
            for i, e in errs.items():
                out[i] = e
            if keep:
                sub = kmeans_batch([points_list[i] for i in keep], k,
                                   [weights_list[i] for i in keep],
                                   max_iters=max_iters, on_error="collect",
                                   w_bound=w_bound)
                for i, r in zip(keep, sub):
                    out[i] = r
            return out
    try:
        prepped = _prep_host_batch(points_list, k, weights_list,
                                   w_bound=w_bound)
    except CrossLaneBoundError:
        # cross-lane bound (global max_val*max_w) with individually valid
        # lanes: fall back to per-lane runs so the isolation contract holds
        if on_error != "collect" or len(points_list) <= 1:
            raise
        if weights_list is None:
            weights_list = [None] * len(points_list)
        return [kmeans_batch([p], k, [wl], max_iters=max_iters,
                             on_error="collect", w_bound=w_bound)[0]
                for p, wl in zip(points_list, weights_list)]
    return _finish_prepped(prepped, points_list, k, max_iters, on_error)


def _finish_prepped(prepped, points_list, k: int, max_iters: int,
                    on_error: str):
    """Drive + fetch + result assembly for one prepped lane chunk (the
    tail of `kmeans_batch`, split out so `_kmeans_batch_chunks` can
    overlap the NEXT chunk's prep/upload with this chunk's bursts)."""
    (pts_f, pts_i, w, valid, cur, cents, ns, bs, vp, wp, pk, pw, split,
     wide, d2b) = prepped
    it, cur, cents = _drive(pts_f, pts_i, w, valid, cur, cents,
                            ns, k, bs, vp, wp, pk, pw, split, wide, d2b,
                            max_iters)
    d = cents.shape[2]
    max_val = max(int(np.asarray(p).max(initial=0)) for p in points_list)
    if k <= 65535 and max_val <= 65535:
        # one packed fetch instead of two; u8-packed when ids and
        # centroid components both fit a byte (the RGB palette case)
        pack = _pack_results_u8 if (k <= 256 and max_val <= 255) \
            else _pack_results_u16
        packed = np.asarray(pack(cur, cents, k))
        n_pad = cur.shape[1]
        assign_np = packed[:, :n_pad].astype(np.int32)
        cents_np = packed[:, n_pad:].reshape(-1, k, d).astype(np.int64)
    else:
        cents_np = np.array(cents).astype(np.int64)
        assign_np = np.asarray(cur)
    out = []
    for b, n in enumerate(ns.tolist()):
        assignment = assign_np[b, :n]
        active = np.unique(assignment).size
        try:
            _check_active(active, k, n)
        except AssertionError as e:
            if on_error != "collect":
                raise
            out.append(e)
            continue
        out.append((cents_np[b], assignment, it))
    log.info("k-means: %d iterations over %d lane(s)", it, len(out))
    return out


def _kmeans_batch_chunks(chunks, k: int, max_iters: int, on_error: str,
                         w_bound):
    """Consecutive lane chunks with upload/compute overlap.

    A single worker thread runs the NEXT chunk's host
    prep + upload while the current chunk drives its device bursts and
    fetches its results. Per-lane trajectories are independent, so the
    outputs are bit-identical to the serial loop (pinned by
    test_kmeans_batch_lane_chunking_bit_identical and the prefetch A/B
    test). A chunk whose prefetched prep raises anything falls back to
    the serial `kmeans_batch` call so every validation/fallback contract
    (collect-mode isolation, CrossLaneBoundError per-lane retry) is
    byte-for-byte the serial behavior. CNIIC_KMEANS_PREFETCH=0 disables
    the overlap."""
    serial_chunk = lambda pts, wts: kmeans_batch(  # noqa: E731
        pts, k, wts, max_iters=max_iters, on_error=on_error,
        w_bound=w_bound)
    out = []
    if os.environ.get("CNIIC_KMEANS_PREFETCH", "1") != "1":
        for pts, wts in chunks:
            out.extend(serial_chunk(pts, wts))
        return out
    from concurrent.futures import ThreadPoolExecutor

    def prep(pts, wts):
        try:
            if on_error == "collect":
                # any per-lane validation error must surface through the
                # serial path's isolation machinery, not from here
                for p, wl in zip(pts, wts):
                    _validate_lane(np.asarray(p), wl, k)
            return _prep_host_batch(pts, k, wts, w_bound=w_bound)
        except Exception:
            return None  # serial path re-runs and surfaces it

    with ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(prep, *chunks[0])
        for i, (pts, wts) in enumerate(chunks):
            prepped = fut.result()
            if i + 1 < len(chunks):
                fut = ex.submit(prep, *chunks[i + 1])
            if prepped is None:
                out.extend(serial_chunk(pts, wts))
            else:
                out.extend(_finish_prepped(prepped, pts, k, max_iters,
                                           on_error))
    return out


def kmeans(points: np.ndarray, k: int, weights: np.ndarray | None = None,
           seed: int = 0, max_iters: int = 10_000,
           w_bound=None):  # seed kept for API compat
    """Cluster integer-valued points (single-lane wrapper over kmeans_batch).

    points: (n, d) nonnegative integers (any dtype).
    weights: optional (n,) positive integers (frequency weights).
    w_bound: optional structural weight bound (see _prep_host_batch).
    Returns (centroids int64[k, d], assignment int32[n], n_iters).
    """
    return kmeans_batch([points], k,
                        None if weights is None else [weights],
                        max_iters=max_iters, w_bound=w_bound)[0]


# ---------------------------------------------------------------------------
# voronoi: device-built (x, y, r, g, b) point sets straight from the images
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("k", "bs"))
def _voronoi_setup(imgs, k: int, bs: int):
    """Build the padded 5-D point batch + init state on device from a stacked
    uint8 image batch (B, h, w, 3). Only the raw images cross the link
    (3 B/pixel instead of int16 points + masks, ~6x less traffic); the
    coordinates, tail-chunk init assignment and first-point centroids
    (kmeans.rs:61-78) are index arithmetic, so they're generated on device.
    """
    B, h, wd, _ = imgs.shape
    n = h * wd
    n_pad = -(-n // bs) * bs
    ppc = n // k
    tail_start = n - (k - 1) * ppc

    idx = jnp.arange(n_pad, dtype=jnp.int32)
    valid = idx < n
    cur = jnp.where(idx < tail_start, k - 1,
                    (n - 1 - idx) // jnp.int32(ppc)).astype(jnp.int32)
    cur = jnp.where(valid, cur, 0)
    x = idx % wd
    y = jnp.minimum(idx // wd, h - 1)
    pix = imgs.reshape(B, n, 3).astype(jnp.int32)
    pix = jnp.pad(pix, ((0, 0), (0, n_pad - n), (0, 0)))
    coords = jnp.stack([x, y], axis=1)  # (n_pad, 2)
    pts_i = jnp.concatenate(
        [jnp.broadcast_to(coords[None], (B, n_pad, 2)), pix], axis=2)
    # padding rows keep whatever values land there: weight 0 + the valid
    # mask already zero their contribution to every output

    cents_idx = np.array([n - (i + 1) * ppc for i in range(k - 1)] + [0],
                         np.int32)
    cents = pts_i[:, jnp.asarray(cents_idx), :]

    w = jnp.broadcast_to(valid.astype(jnp.int32)[None], (B, n_pad))
    valid_b = jnp.broadcast_to(valid[None], (B, n_pad))
    cur_b = jnp.broadcast_to(cur[None], (B, n_pad))
    return pts_i.astype(jnp.float32), pts_i, w, valid_b, cur_b, cents


def voronoi_centroids_batch(imgs: np.ndarray, k: int,
                            max_iters: int = 10_000,
                            on_error: str = "raise",
                            return_device_imgs: bool = False):
    """K-means over all pixels as (x, y, r, g, b) points for a same-shape
    image batch (clusterc.rs:206-247), entirely device-resident: upload the
    uint8 images, build points/init on device, fetch only the (B, k, 5)
    centroids (the assignment is not part of the voronoi stream).
    Returns a list of int64[k, 5] (or, with on_error="collect", the
    active-cluster exception in place of a failed lane's centroids).
    With return_device_imgs=True, returns (list, device uint8[B, h, w, 3])
    so callers can reuse the uploaded batch (the fused decode+MSE path
    would otherwise pay the 3 B/pixel upload a second time).
    """
    imgs = np.ascontiguousarray(imgs, dtype=np.uint8)
    B, h, w, _ = imgs.shape
    n = h * w
    # megapixel point sets run 4 lanes per chunk (deeper lockstep adds
    # straggler iterations). CNIIC_KMEANS_LANES overrides; results are
    # bit-identical under any chunking (lanes are independent; pinned by
    # tests).
    max_lanes = int(os.environ.get("CNIIC_KMEANS_LANES", "4"))
    if B > max_lanes > 0:
        outs, devs = [], []
        for i in range(0, B, max_lanes):
            r = voronoi_centroids_batch(
                imgs[i:i + max_lanes], k, max_iters=max_iters,
                on_error=on_error, return_device_imgs=return_device_imgs)
            if return_device_imgs:
                outs.extend(r[0])
                devs.append(r[1])
            else:
                outs.extend(r)
        if return_device_imgs:
            devs = [d for d in devs if d is not None]
            dev = jnp.concatenate(devs, axis=0) if devs else None
            return outs, dev
        return outs
    try:
        if k < 1:
            raise ValueError(f"k-means needs k >= 1 (got {k})")
        if n < k:
            raise ValueError(f"k-means needs at least k points ({n} < {k})")
        if n // k == 0:
            raise ValueError("points_per_cluster must be > 0 (kmeans.rs:68)")
        if n >= 2**27:
            raise ValueError("kmeans point count must be < 2^27 (~134M)")
        if max(h, w) - 1 > 16383:
            raise ValueError("kmeans coordinate values must be <= 16383")
    except ValueError as e:
        if on_error != "collect":
            raise
        # same shape => the whole bucket shares the failure
        return ([e] * B, None) if return_device_imgs else [e] * B

    max_val = max(w - 1, h - 1, 255)
    d2_bound = (w - 1) ** 2 + (h - 1) ** 2 + 3 * 255 ** 2
    bs, vp, wp, pk, pw, split, wide = plan_params(max_val, 1, d2_bound, k, n)

    imgs_dev = jnp.asarray(imgs)
    pts_f, pts_i, w_dev, valid, cur, cents = _voronoi_setup(imgs_dev, k, bs)
    ns = np.full(B, n, np.int64)
    it, cur, cents = _drive(pts_f, pts_i, w_dev, valid, cur, cents,
                            ns, k, bs, vp, wp, pk, pw, split, wide,
                            d2_bound, max_iters)
    if k <= 65535:
        # active counts + centroids in one packed u16 fetch (two fewer
        # device-to-host fetches; coords <= 16383, colors <= 255, and the
        # active count <= k all fit u16)
        packed = np.asarray(
            _voronoi_finish_u16(cur, valid, cents, k)).astype(np.int64)
        actives = packed[:, 0]
        cents_np = packed[:, 1:].reshape(B, k, 5)
    else:
        # k beyond u16: the active count would wrap in the packed fetch
        # (review r4) — fall back to two plain fetches
        actives = np.asarray(_active_counts(cur, valid, k)).astype(np.int64)
        cents_np = np.asarray(cents).astype(np.int64)
    out = []
    for b in range(B):
        try:
            _check_active(int(actives[b]), k, n)
        except AssertionError as e:
            if on_error != "collect":
                raise
            out.append(e)
            continue
        out.append(cents_np[b])
    log.info("k-means: %d iterations over %d voronoi lane(s)", it, B)
    return (out, imgs_dev) if return_device_imgs else out
