"""Fused Triton k-means iteration: bit-exact parity with the XLA path.

The kernel must reproduce ops.kmeans._iteration exactly — assignments
(incl. the strict-move tie rule), digit-plane statistics, move counts —
so the full clustering trajectory is identical whichever path runs.
Interpret mode on the CPU backend; the CUDA lowering is guarded in
test_gpu_lowering.py and the on-card parity check is chip_smoke.py.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from cniic_tpu.ops import kmeans as km
from cniic_tpu.ops import kmeans_pallas as kp


def _mk_batch(rng, B, n, d, k, maxval, weighted):
    pts, ws = [], []
    for _ in range(B):
        p = rng.integers(0, maxval, (n, d)).astype(np.int64)
        p[n // 2:] = p[: n - n // 2]  # duplicates -> distance ties
        pts.append(p)
        ws.append(rng.integers(1, 200, n).astype(np.int64) if weighted else None)
    return pts, ws


def _kernel_step(prepped, k, *, bs=128, kt=None, sub=4, packed=True,
                 act=None):
    """One kernel step on a _prep_host_batch state (interpret mode)."""
    (pts_f, pts_i, w, valid, cur, cents, ns, bs_x, vp, wp, pk, pw, split,
     wide, d2b) = prepped
    B = pts_i.shape[0]
    kpp = max(16, 1 << (k - 1).bit_length())
    pkc = 1 << max(k - 1, 0).bit_length()
    pop, feat = kp.point_operands(pts_i, w, vp, wp)
    cop, csq = kp.centroid_operands(cents, kpp)
    act = np.ones(B, np.int32) if act is None else np.asarray(act, np.int32)
    return kp._assign_stats(
        pop, feat, cur, cop, csq, jnp.asarray(ns.astype(np.int32)),
        jnp.asarray(act), k=k, pk=pkc, bs=bs, kt=kt or min(kpp, 128),
        sub=sub, packed=packed, interpret=True)


def _assert_lane_matches_iteration(prepped, k, b, new_p, sums_p, mv_p):
    (pts_f, pts_i, w, valid, cur, cents, ns, bs, vp, wp, pk, pw, split,
     wide, d2b) = prepped
    new_x, cents_x, _, moved_x = km._iteration(
        pts_f[b], pts_i[b], w[b], valid[b], cur[b],
        cents[b].astype(jnp.float32), k, jnp.int32(0),
        jnp.int32(int(ns[b])), bs, vp, wp, pk)
    np.testing.assert_array_equal(np.asarray(new_p[b]), np.asarray(new_x))
    assert int(mv_p[b]) == int(moved_x)
    # same statistics => same means: check through the shared tail
    F = vp * pts_i.shape[2] + wp
    cents_p, _ = km._means_from_sums(
        sums_p[b][:k, :F], pts_i[b], k, jnp.int32(0),
        jnp.int32(int(ns[b])), vp, wp)
    np.testing.assert_array_equal(np.asarray(cents_p), np.asarray(cents_x))


@pytest.mark.parametrize("k,d,weighted", [(8, 3, True), (16, 5, False),
                                          (5, 2, False), (200, 3, True)])
def test_assign_stats_matches_iteration(k, d, weighted):
    """Both reductions (packed key and two-reduce), one centroid tile and
    several (k=200 over kt=128 tiles), blocks past the lane's points."""
    rng = np.random.default_rng(3)
    B, n = 2, 300
    pts, ws = _mk_batch(rng, B, n, d, k, 256, weighted)
    prepped = km._prep_host_batch(pts, k, ws if weighted else None)
    assert prepped[10], "packed argmin must be available at these bounds"
    for packed in (True, False):
        new_p, sums_p, mv_p = _kernel_step(prepped, k, packed=packed)
        for b in range(B):
            _assert_lane_matches_iteration(prepped, k, b, new_p, sums_p,
                                           mv_p)


def test_full_kmeans_matches_xla_path(monkeypatch):
    """End-to-end: the kernel loop (interpret) must yield the exact same
    centroids/assignments/iteration count as the XLA loop."""
    rng = np.random.default_rng(5)
    pts = rng.integers(0, 256, (700, 3)).astype(np.int64)
    wts = rng.integers(1, 9, 700).astype(np.int64)

    monkeypatch.setenv("CNIIC_PALLAS_KMEANS", "0")
    c_x, a_x, i_x = km.kmeans(pts, 12, weights=wts)
    monkeypatch.setenv("CNIIC_PALLAS_KMEANS", "1")
    monkeypatch.setenv("CNIIC_KMEANS_BS", "512")  # a small padded size
    c_p, a_p, i_p = km.kmeans(pts, 12, weights=wts)

    assert i_x == i_p
    np.testing.assert_array_equal(a_x, a_p)
    np.testing.assert_array_equal(c_x, c_p)


def test_two_reduce_variant_matches_packed(monkeypatch):
    """The big-k two-reduction path must make the exact same decisions as
    the packed single-reduction key (and therefore as the XLA oracle)."""
    rng = np.random.default_rng(13)
    pts = rng.integers(0, 256, (700, 3)).astype(np.int64)

    monkeypatch.setenv("CNIIC_PALLAS_KMEANS", "1")
    monkeypatch.setenv("CNIIC_KMEANS_BS", "512")
    c1, a1, i1 = km.kmeans(pts, 12)

    # force the two-reduce variant: the wrapper below overrides
    # packed=False on every kernel call (the packed single-reduce key is
    # what's being cross-checked against)
    real_loop = kp.kmeans_loop_pallas

    def no_pack_loop(*args, **kwargs):
        kwargs["packed"] = False
        return real_loop(*args, **kwargs)

    monkeypatch.setattr(kp, "kmeans_loop_pallas", no_pack_loop)
    c2, a2, i2 = km.kmeans(pts, 12)
    assert i1 == i2
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(c1, c2)


def test_pick_block():
    # the production shapes: a program covers bs*sub rows, centroids in
    # 32-wide tiles
    assert kp.pick_block(65536 * 43, 128) == (128, 32, 16)  # 4 tiles
    assert kp.pick_block(65536 * 8, 32) == (128, 32, 16)
    assert kp.pick_block(65536, 5) == (128, 16, 16)     # kp >= 16 (dot)
    assert kp.pick_block(16384 * 3, 2048) == (128, 32, 16)  # 64 tiles
    # small padded sizes shrink the program, then the block
    assert kp.pick_block(512, 12) == (128, 16, 4)
    assert kp.pick_block(48, 12) == (16, 16, 1)
    assert kp.pick_block(100, 16) is None                # nothing divides
    # the interpreter runs programs in turn: one 65536-row program a lane
    assert kp.pick_block(65536 * 3, 32, interpret=True) == (128, 32, 512)
    assert kp.pick_block(512, 12, interpret=True) == (128, 16, 4)
    for n_pad, k in ((65536, 2048), (512, 3), (2818048, 128)):
        bs, kt, sub = kp.pick_block(n_pad, k)
        assert n_pad % (bs * sub) == 0
        assert 255 * bs * sub < 2**24                    # f32-exact stats
        assert kt & (kt - 1) == 0 and 16 <= kt <= 32


def test_codec_streams_identical_under_forced_kernel(monkeypatch, rng):
    """Codec-level: forcing the fused kernel (interpret off the GPU) must
    produce byte-identical streams to the XLA iteration for both k-means
    codecs — the full-stack version of the step-level parity pins."""
    from cniic_tpu.codecs import from_spec

    imgs = [rng.integers(0, 256, (32, 40, 3)).astype(np.uint8)
            for _ in range(2)]
    for spec in ("cluster-colors(8)", "voronoi(16)"):
        codec = from_spec(spec)
        monkeypatch.setenv("CNIIC_PALLAS_KMEANS", "0")
        xla = codec.encode_batch(imgs)
        monkeypatch.setenv("CNIIC_PALLAS_KMEANS", "1")
        kern = codec.encode_batch(imgs)
        assert xla == kern, spec


@pytest.mark.parametrize("d", [1, 2, 3, 5, 8])
def test_operands_pad_the_contraction_exactly(d):
    """The 4d hi/lo rows are zero-padded to a power of two >= 16 and their
    dot is p.c exactly; the digit-plane features are zero-padded too.
    Values stay inside the kernel's regime (d * max^2 < 2^24)."""
    rng = np.random.default_rng(d)
    B, n, k = 2, 64, 7
    top = min(8192, int((2**24 / d) ** 0.5))
    pts = rng.integers(0, top, (B, n, d)).astype(np.int32)
    w = rng.integers(0, 300, (B, n)).astype(np.int32)
    cents = rng.integers(0, top, (B, k, d)).astype(np.int32)
    pop, feat = kp.point_operands(jnp.asarray(pts), jnp.asarray(w), 4, 2)
    cop, csq = kp.centroid_operands(jnp.asarray(cents), 16)
    KP = kp.operand_width(d)
    assert KP == max(16, 1 << (4 * d - 1).bit_length())
    assert pop.shape == (B, n, KP) and cop.shape == (B, 16, KP)
    assert feat.shape == (B, n, kp.feature_width(d, 4, 2))
    assert not np.asarray(pop[..., 4 * d:]).any()
    assert not np.asarray(cop[:, k:]).any() and not np.asarray(csq[:, k:]).any()
    assert not np.asarray(feat[..., 4 * d + 2:]).any()
    pc = np.einsum("bnq,bkq->bnk", np.asarray(pop).astype(np.float64),
                   np.asarray(cop).astype(np.float64))[:, :, :k]
    want = np.einsum("bnd,bkd->bnk", pts.astype(np.int64),
                     cents.astype(np.int64))
    np.testing.assert_array_equal(pc, want)
    np.testing.assert_array_equal(
        np.asarray(csq[:, :k]), (cents.astype(np.int64) ** 2).sum(-1))


def test_padded_centroids_never_win():
    """k=5 pads to kp=16 zero centroids; points at the origin would pick
    a padded centroid if the mask were missing."""
    rng = np.random.default_rng(9)
    pts = [np.concatenate([np.zeros((40, 3), np.int64),
                           rng.integers(100, 256, (160, 3))])]
    prepped = km._prep_host_batch(pts, 5, None)
    for packed in (True, False):
        new_p, sums_p, mv_p = _kernel_step(prepped, 5, packed=packed)
        assert int(np.asarray(new_p).max()) < 5
        _assert_lane_matches_iteration(prepped, 5, 0, new_p, sums_p, mv_p)


def test_frozen_lane_is_skipped_and_kept():
    """A lane whose stop rule fired (act == 0) leaves the active lane's
    results untouched, and the loop keeps the frozen lane's state."""
    rng = np.random.default_rng(4)
    pts, ws = _mk_batch(rng, 2, 300, 3, 8, 256, True)
    prepped = km._prep_host_batch(pts, 8, ws)
    new_p, sums_p, mv_p = _kernel_step(prepped, 8, act=[1, 0])
    _assert_lane_matches_iteration(prepped, 8, 0, new_p, sums_p, mv_p)

    (pts_f, pts_i, w, valid, cur, cents, ns, bs, vp, wp, pk, pw, split,
     wide, d2b) = prepped
    pop, feat = kp.point_operands(pts_i, w, vp, wp)
    n = jnp.asarray(ns.astype(np.int32))
    thresh = jnp.asarray(np.array([0, 10**6], np.int32))  # lane 1 frozen
    it, cur2, cents2, moved, _, _ = kp.kmeans_loop_pallas(
        pop, feat, pts_i, cur, cents, n, thresh, n + 1, n + 1,
        jnp.zeros(2, jnp.int32), jnp.int32(0), k=8, max_iters=2, bs=128,
        kt=16, sub=4, vp=vp, wp=wp, pk=8, interpret=True)
    assert int(it) == 2
    np.testing.assert_array_equal(np.asarray(cur2[1]), np.asarray(cur[1]))
    np.testing.assert_array_equal(np.asarray(cents2[1]), np.asarray(cents[1]))
    assert not np.array_equal(np.asarray(cents2[0]), np.asarray(cents[0]))


def test_centroid_tiling_matches_one_tile():
    """k=100 over four 32-wide tiles (carried key) == one 128-wide tile."""
    rng = np.random.default_rng(21)
    pts, ws = _mk_batch(rng, 2, 400, 3, 100, 256, True)
    prepped = km._prep_host_batch(pts, 100, ws)
    for packed in (True, False):
        one = _kernel_step(prepped, 100, kt=128, packed=packed)
        four = _kernel_step(prepped, 100, kt=32, packed=packed)
        for a, b in zip(one, four):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_kernel_gate(monkeypatch):
    """The kernel runs on the GPU backend only, unless forced; never past
    the f32-exact distance bound."""
    monkeypatch.delenv("CNIIC_PALLAS_KMEANS", raising=False)
    assert km._pallas_block(65536, 32, 3 * 255 ** 2) is None  # CPU backend
    monkeypatch.setenv("CNIIC_PALLAS_KMEANS", "1")
    assert km._pallas_block(65536, 32, 3 * 255 ** 2) == kp.pick_block(
        65536, 32, interpret=True)
    assert km._pallas_block(65536, 32, 1 << 24) is None  # wide: XLA body
    monkeypatch.setenv("CNIIC_PALLAS_KMEANS", "0")
    assert km._pallas_block(65536, 32, 3 * 255 ** 2) is None


def test_chip_probe_compares_kernel_with_xla_step(monkeypatch):
    """The step check chip_smoke.py runs on the card (via
    scripts/experiments/profile_kmeans.py), here at a tiny width in
    interpret mode: both batch builders, both reductions."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(__file__), os.pardir, "scripts",
                        "experiments", "profile_kmeans.py")
    spec = importlib.util.spec_from_file_location("profile_kmeans", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    rng = np.random.default_rng(8)
    imgs = [rng.integers(0, 256, (20, 28, 3)).astype(np.uint8)
            for _ in range(4)]
    lines = []
    for make, k in ((probe.voronoi_state, 16),
                    (probe.cluster_colors_state, 8)):
        state, d2b = make(imgs, k)
        probe.probe(f"k={k}", state, k, d2b,
                    [kp.pick_block(state[1].shape[1], k, interpret=True)],
                    lines.append)
    assert sum("exact=True" in line for line in lines) == 2
