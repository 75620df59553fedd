"""Fused k-means assignment+statistics iteration (Pallas through Triton).

The XLA body in ops/kmeans.py writes several (points x k) f32 tiles per
iteration to device memory and reads them back (the three hi/lo partial
products, the assembled distances, the packed key, the one-hot): cuBLAS
cannot fuse the argmin or the one-hot statistics into its epilogue. This
kernel keeps every (points x centroids) tile in registers: device memory
sees the point operands in, the new assignment out, and a (k x F) integer
statistics block per program.

Grid: (program block, lane), both parallel. A program covers `sub`
sub-blocks of `bs` points; it loads its own lane's point count and active
flag, and a frozen lane (stop rule fired) or a program wholly past the
lane's points does no distance work. Centroids are padded to a power of
two `kp` >= 16 and walked in tiles of `kt` inside the program, carrying the
running packed key (or the two-reduction (score, tiebreak) pair for large
k), with padded centroids masked out of the min.

Exactness is inherited from ops/kmeans.py, not re-argued: the base-32
hi/lo bf16 split makes every tensor-core product exact, and the cross term
is ONE dot over a 4d contraction (zero-padded to the operand width `KP`,
16 or 32) with the x32 scale riding the operands (multiples of 32 below
2048 are exact bf16; all terms are nonnegative, so every f32 prefix sum is
<= p.c <= d2_bound < 2^24 and stays integral). Points are scored with
|p-c|^2 - |p|^2 = |c|^2 - 2 p.c (ordering-equivalent per point), and ONE
packed min over score*2pk + tiebreak, with the current centroid's
tiebreak forced to 0, implements argmin + the strict-move/stay-on-tie rule
(caller guarantees (d2_bound+1)*2pk < 2^31). The statistics dot (one-hot^T
@ digit planes) sums 0/1 x <=255 values over a program's rows
(255*bs*sub < 2^24, exact in f32); each program stores its int32 partial
and XLA sums them — integer addition is exact and order-independent, so
the result does not depend on the order in which programs run.

The point operands (`pop`, the hi/lo rows; `feat`, the digit planes) do
not change across iterations, so `point_operands` builds them once per
run; only the centroid operands are rebuilt per iteration.

Parity: tests/test_kmeans_pallas.py pins kernel == _iteration bit-for-bit
(assignments, statistics, move counts) in interpret mode; chip_smoke.py
repeats the check on the GPU at real widths.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .kmeans import _means_from_sums

# rows of a point sub-block, centroids per tile and sub-blocks per program
# (the defaults of `pick_block`), warps per program: measured on the GPU
# (scripts/experiments/profile_kmeans.py; PERF.md)
_BS = 128
_KT = 32
_SUB = 16
_WARPS = 4


def _pow2_ceil(v: int) -> int:
    return 1 << (max(int(v), 1) - 1).bit_length()


def operand_width(d: int) -> int:
    """Padded contraction width of the 4d hi/lo operands (Triton's dot
    needs every operand dimension >= 16, and blocks are powers of two)."""
    return max(16, _pow2_ceil(4 * d))


def feature_width(d: int, vp: int, wp: int) -> int:
    """Padded width of the digit-plane statistics features."""
    return max(16, _pow2_ceil(vp * d + wp))


def pick_block(n_pad: int, k: int, interpret: bool = False):
    """(bs, kt, sub) for a lane of n_pad points and k centroids, or None
    when no power-of-two program block divides n_pad (the caller then keeps
    the XLA body). A program covers bs*sub rows; its one-hot statistics
    stay f32-exact while 255*bs*sub < 2^24. The interpreter runs programs
    one after another, so there a program covers up to 65536 rows."""
    bs = _BS
    while bs >= 16 and n_pad % bs:
        bs //= 2
    if bs < 16:
        return None
    sub = (1 << 16) // bs if interpret else _SUB
    while n_pad % (bs * sub):
        sub //= 2
    return bs, min(_KT, max(16, _pow2_ceil(k))), sub


def _kernel(n_ref, act_ref, pop_ref, feat_ref, cur_ref, cop_ref, csq_ref,
            new_ref, sums_ref, moved_ref,
            *, k: int, kt: int, nt: int, bs: int, sub: int, pk: int,
            packed: bool, interpret: bool):
    j = pl.program_id(0)
    b = pl.program_id(1)
    # explicitly typed constants: under jax_enable_x64 python literals
    # trace as 64-bit
    i32 = jnp.int32
    PK = i32(pk)
    PK2 = i32(2 * pk)
    PK2M = i32(2 * pk - 1)
    BIG = i32(2**31 - 1)
    TIE = i32(2**30)
    FP = feat_ref.shape[1]
    n = n_ref[b]
    start = j * i32(bs * sub)
    active = act_ref[b] > 0
    col = jax.lax.broadcasted_iota(jnp.int32, (bs, kt), 1)

    @pl.when(jnp.logical_and(active, start >= n))
    def _():
        # a program wholly past the lane's points: padding rows keep id 0
        # and contribute nothing
        new_ref[...] = jnp.zeros((bs * sub,), jnp.int32)
        sums_ref[...] = jnp.zeros(sums_ref.shape, jnp.int32)
        moved_ref[...] = i32(0)

    def assign_rows(s):
        """New ids of sub-block s (min over every centroid tile)."""
        rs = pl.ds(s * bs, bs)
        p = pop_ref[rs, :]                                 # (bs, KP) bf16
        cur = cur_ref[rs]                                  # (bs,) int32

        def tile_key(t):
            c = cop_ref[pl.ds(t * kt, kt), :]              # (kt, KP) bf16
            csq = csq_ref[pl.ds(t * kt, kt)]               # (kt,) f32
            pc = pl.dot(p, c, trans_b=True)                # (bs, kt) f32
            si = ((csq[None, :] - pc) - pc).astype(jnp.int32)
            kidx = t * kt + col
            # the CURRENT centroid's tiebreak is 0: at equal score it wins
            # (ties keep the cluster), otherwise the smallest index among
            # the minimizers — argmin-then-strictly-closer in one key
            sel = jnp.where(kidx == cur[:, None], i32(0), PK + kidx)
            return si, sel, kidx < k

        if packed:
            def tile(t, kmin):
                si, sel, real = tile_key(t)
                key = jnp.where(real, si * PK2 + sel, BIG)
                return jnp.minimum(kmin, jnp.min(key, axis=1))

            kmin = jax.lax.fori_loop(i32(0), i32(nt), tile,
                                     jnp.full((bs,), BIG, jnp.int32))
            r = kmin & PK2M
        else:
            # large k: lexicographic (min score, min tiebreak) carried
            # across tiles — needs only d2_bound < 2^24
            def tile(t, carry):
                smin, rmin = carry
                si, sel, real = tile_key(t)
                si = jnp.where(real, si, BIG)
                ts = jnp.min(si, axis=1)
                tr = jnp.min(jnp.where(si == ts[:, None], sel, TIE), axis=1)
                better = ts < smin
                tie = ts == smin
                return (jnp.where(better, ts, smin),
                        jnp.where(better, tr,
                                  jnp.where(tie, jnp.minimum(rmin, tr),
                                            rmin)))

            _, r = jax.lax.fori_loop(
                i32(0), i32(nt), tile,
                (jnp.full((bs,), BIG, jnp.int32),
                 jnp.full((bs,), TIE, jnp.int32)))
        rows = start + s * bs + jax.lax.broadcasted_iota(jnp.int32, (bs,), 0)
        new = jnp.where(r >= PK, r - PK, cur)
        new = jnp.where(rows < n, new, i32(0))
        new_ref[rs] = new
        return new, jnp.sum((new != cur).astype(jnp.int32), dtype=jnp.int32)

    def onehot_stats(new, s, t):
        f = feat_ref[pl.ds(s * bs, bs), :]                 # (bs, FP) bf16
        onehot = (new[:, None] == t * kt + col).astype(jnp.bfloat16)
        return pl.dot(onehot, f, trans_a=True)             # (kt, FP) f32

    @pl.when(jnp.logical_and(active, start < n))
    def _():
        zero = jnp.zeros((kt, FP), jnp.float32)
        if nt == 1:
            # every centroid in one tile: the statistics ride the same pass
            def rows_and_stats(s, carry):
                mv, acc = carry
                new, m = assign_rows(s)
                return mv + m, acc + onehot_stats(new, s, i32(0))

            mv, acc = jax.lax.fori_loop(i32(0), i32(sub), rows_and_stats,
                                        (i32(0), zero))
            sums_ref[...] = acc.astype(jnp.int32)
        else:
            # the one-hot of a tile needs the min over ALL tiles: assign
            # every sub-block first, then walk the tiles over the stored ids
            mv = jax.lax.fori_loop(i32(0), i32(sub),
                                   lambda s, mv: mv + assign_rows(s)[1],
                                   i32(0))
            if not interpret:
                plgpu.debug_barrier()  # the stored ids, seen by all threads

            def tile_stats(t, carry):
                acc = jax.lax.fori_loop(
                    i32(0), i32(sub),
                    lambda s, acc: acc + onehot_stats(
                        new_ref[pl.ds(s * bs, bs)], s, t), zero)
                sums_ref[pl.ds(t * kt, kt), :] = acc.astype(jnp.int32)
                return carry

            jax.lax.fori_loop(i32(0), i32(nt), tile_stats, i32(0))
        moved_ref[...] = mv


def _assign_stats(pop, feat, cur, cop, csq, n1, act, *, k: int, pk: int,
                  bs: int, kt: int, sub: int, packed: bool, interpret: bool):
    """One fused assignment+stats step over the whole batch.

    pop bf16[B, n_pad, KP], feat bf16[B, n_pad, FP], cur int32[B, n_pad],
    cop bf16[B, kp, KP], csq f32[B, kp], n1/act int32[B].
    Returns (new int32[B, n_pad], sums int32[B, kp, FP], moved int32[B]);
    lanes with act == 0 leave `new`, `sums` and `moved` undefined (the
    caller keeps its carried state for them).
    """
    B, n_pad, KP = pop.shape
    FP = feat.shape[2]
    kp = cop.shape[1]
    rows = bs * sub
    nb = n_pad // rows
    kern = functools.partial(_kernel, k=k, kt=kt, nt=kp // kt, bs=bs,
                             sub=sub, pk=pk, packed=packed,
                             interpret=interpret)
    whole = pl.BlockSpec()
    new, parts, moved = pl.pallas_call(
        kern,
        grid=(nb, B),
        in_specs=[
            whole,                                                   # n
            whole,                                                   # act
            pl.BlockSpec((None, rows, KP), lambda j, b: (b, j, 0)),  # pop
            pl.BlockSpec((None, rows, FP), lambda j, b: (b, j, 0)),  # feat
            pl.BlockSpec((None, rows), lambda j, b: (b, j)),         # cur
            pl.BlockSpec((None, kp, KP), lambda j, b: (b, 0, 0)),    # cop
            pl.BlockSpec((None, kp), lambda j, b: (b, 0)),           # csq
        ],
        out_specs=[
            pl.BlockSpec((None, rows), lambda j, b: (b, j)),
            pl.BlockSpec((None, None, kp, FP), lambda j, b: (b, j, 0, 0)),
            pl.BlockSpec((None, None), lambda j, b: (b, j)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((B, n_pad), jnp.int32),
            jax.ShapeDtypeStruct((B, nb, kp, FP), jnp.int32),
            jax.ShapeDtypeStruct((B, nb), jnp.int32),
        ],
        compiler_params=plgpu.CompilerParams(num_warps=_WARPS, num_stages=2),
        backend="triton",
        interpret=interpret,
        name="kmeans_assign_stats",
    )(n1, act, pop, feat, cur, cop, csq)
    # per-program integer partials: exact and order-independent
    return (new, jnp.sum(parts, axis=1, dtype=jnp.int32),
            jnp.sum(moved, axis=1, dtype=jnp.int32))


@functools.partial(jax.jit, static_argnames=("vp", "wp"))
def point_operands(pts_i, w, vp: int, wp: int):
    """The per-run point operands from int32 points (B, n_pad, d) and
    weights (B, n_pad): the hi/lo distance rows bf16[B, n_pad, KP] and the
    8-bit digit planes of the weighted values + weights bf16[B, n_pad, FP]
    (column order as ops.kmeans._assign_stats_xla's features)."""
    d = pts_i.shape[2]
    p = pts_i.astype(jnp.float32)
    hi = jnp.floor(p / 32.0)
    lo = p - hi * 32.0
    rows = jnp.concatenate([hi * 32.0, lo, hi * 32.0, lo], axis=2)
    pop = jnp.pad(rows, ((0, 0), (0, 0), (0, operand_width(d) - 4 * d)))
    prod = pts_i * w[:, :, None]
    planes = [(prod >> (8 * i)) & 0xFF for i in reversed(range(vp))]
    planes += [((w >> (8 * i)) & 0xFF)[:, :, None]
               for i in reversed(range(wp))]
    feat = jnp.concatenate(planes, axis=2)
    feat = jnp.pad(feat, ((0, 0), (0, 0),
                          (0, feature_width(d, vp, wp) - vp * d - wp)))
    return pop.astype(jnp.bfloat16), feat.astype(jnp.bfloat16)


def centroid_operands(cents_i, kp: int):
    """Per-iteration centroid operands from int32 centroids (B, k, d): the
    hi/lo rows bf16[B, kp, KP] (paired with `point_operands`' layout so the
    4d contraction sums to p.c) and |c|^2 f32[B, kp]. Padded centroids are
    zero; the kernel masks them out of the min."""
    B, k, d = cents_i.shape
    c = cents_i.astype(jnp.float32)
    hi = jnp.floor(c / 32.0)
    lo = c - hi * 32.0
    rows = jnp.concatenate([hi * 32.0, hi * 32.0, lo, lo], axis=2)
    cop = jnp.pad(rows, ((0, 0), (0, kp - k), (0, operand_width(d) - 4 * d)))
    # |c|^2 <= d2_bound < 2^24: exact in f32 whatever the summation order
    csq = jnp.pad(jnp.sum(c * c, axis=2), ((0, 0), (0, kp - k)))
    return cop.astype(jnp.bfloat16), csq


@functools.partial(jax.jit, static_argnames=("k", "max_iters", "bs", "kt",
                                             "sub", "vp", "wp", "pk",
                                             "packed", "stall_lim",
                                             "interpret"))
def kmeans_loop_pallas(pop, feat, pts_i, cur, cents_i, n, thresh, moved0,
                       best0, stall0, it0,
                       k: int, max_iters: int, bs: int, kt: int, sub: int,
                       vp: int, wp: int, pk: int, packed: bool = True,
                       stall_lim: int = 1 << 30, interpret: bool = False):
    """Drop-in replacement for ops.kmeans._kmeans_loop with the fused
    kernel as the iteration body (same freeze semantics — threshold stop +
    per-iteration plateau net; the means/empty-repair tail is the shared
    _means_from_sums). pts_i int32[B, n_pad, d] is the steal source."""
    from .kmeans import _plateau_update

    d = pts_i.shape[2]
    F = vp * d + wp
    kp = max(16, _pow2_ceil(k))

    def active(moved, stall):
        return jnp.logical_and(moved > thresh, stall < stall_lim)

    def cond(state):
        it, _, _, moved, _, stall = state
        return jnp.logical_and(jnp.any(active(moved, stall)),
                               it < it0 + max_iters)

    def body(state):
        it, cur, cents_i, moved, best, stall = state
        act = active(moved, stall)
        cop, csq = centroid_operands(cents_i, kp)
        new, sums, new_moved = _assign_stats(
            pop, feat, cur, cop, csq, n, act.astype(jnp.int32),
            k=k, pk=pk, bs=bs, kt=kt, sub=sub, packed=packed,
            interpret=interpret)

        def lane_means(sums_b, pts_b, n_b):
            return _means_from_sums(sums_b[:k, :F], pts_b, k, it, n_b, vp, wp)

        cents_new, _ = jax.vmap(lane_means)(sums, pts_i, n)
        cur = jnp.where(act[:, None], new, cur)
        cents_i = jnp.where(act[:, None, None], cents_new, cents_i)
        moved = jnp.where(act, new_moved, moved)
        best, stall = _plateau_update(act, new_moved, best, stall)
        return it + 1, cur, cents_i, moved, best, stall

    return jax.lax.while_loop(
        cond, body, (it0, cur, cents_i, moved0, best0, stall0))


@functools.lru_cache(maxsize=64)
def kmeans_loop_pallas_sharded(mesh, k: int, max_iters: int, bs: int,
                               kt: int, sub: int, vp: int, wp: int, pk: int,
                               packed: bool, stall_lim: int,
                               interpret: bool):
    """shard_map the fused kernel over the mesh's batch (lane) axis: a
    pallas_call does not partition itself under GSPMD.

    Each device runs the SAME per-lane while_loop over its local lanes;
    lanes are independent (frozen lanes stop updating), so per-lane
    trajectories — and the streams built from them — are bit-identical to
    the single-device kernel path. A device whose lanes all freeze exits
    its burst early; the host continues with the max iteration count
    (devices with active lanes always run the full burst).

    Returns a jitted step: (pop, feat, pts_i, cur, cents_i, n, thresh,
    moved0, best0, stall0, it0) -> (it (ndev,), cur, cents_i, moved, best,
    stall).
    """
    from jax.sharding import PartitionSpec as P

    def _local(pop, feat, pts_i, cur, cents_i, n, thresh, moved0, best0,
               stall0, it0):
        it, cur, cents_i, moved, best, stall = kmeans_loop_pallas(
            pop, feat, pts_i, cur, cents_i, n, thresh, moved0, best0, stall0,
            it0, k=k, max_iters=max_iters, bs=bs, kt=kt, sub=sub, vp=vp,
            wp=wp, pk=pk, packed=packed, stall_lim=stall_lim,
            interpret=interpret)
        return jnp.reshape(it, (1,)), cur, cents_i, moved, best, stall

    lane = P("batch")
    lane3 = P("batch", None, None)
    # the vma check is off: pallas_call outputs carry no replication info
    sharded = jax.shard_map(
        _local, mesh=mesh,
        in_specs=(lane3, lane3, lane3, P("batch", None), lane3,
                  lane, lane, lane, lane, lane, P()),
        out_specs=(lane, P("batch", None), lane3, lane, lane, lane),
        check_vma=False,
    )
    return jax.jit(sharded)
