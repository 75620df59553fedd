"""K-means semantics (ported from kmeans.rs:446-581, nonnegative domain)."""

import numpy as np
import pytest

from cniic_tpu.ops import kmeans


def _square_centered_at(p):
    return [(p[0] + i, p[1] + j) for i in range(-1, 2) for j in range(-1, 2)]


def test_all_clusters_k_equals_n():
    # kmeans.rs:492-500: every point its own cluster
    data = np.array([(0, 0), (1, 1)], np.int64)
    cents, assign, _ = kmeans.kmeans(data, 2)
    assert sorted(map(tuple, cents.tolist())) == [(0, 0), (1, 1)]
    assert np.unique(assign).size == 2


def test_square1():
    # kmeans.rs:516-523 (shifted to a nonnegative domain)
    data = np.array(_square_centered_at((10, 10)), np.int64)
    cents, assign, _ = kmeans.kmeans(data, 1)
    assert cents.tolist() == [[10, 10]]
    assert (assign == 0).all()


def test_squares2():
    # kmeans.rs:526-539: two well-separated squares
    data = np.array(
        _square_centered_at((10, 50)) + _square_centered_at((210, 50)), np.int64)
    cents, assign, _ = kmeans.kmeans(data, 2)
    assert sorted(map(tuple, cents.tolist())) == [(10, 50), (210, 50)]
    # each square ends up in one cluster
    assert np.unique(assign[:9]).size == 1
    assert np.unique(assign[9:]).size == 1


def test_init_layout():
    """Init splits k equal chunks from the TAIL and the initial centroid is
    the FIRST point of each chunk (kmeans.rs:61-108). The point set below
    discriminates both choices:

    * tail-chunking fixes the label layout — cluster0 = pts[7:10],
      cluster1 = pts[4:7], cluster2 = pts[0:4] (head chunks would permute
      the final labels);
    * first-point centroids decide where pts[3]=35 goes on iteration 1 —
      with c1 = pts[4] = 40 it moves to cluster 1 (|35-40| = 5 < 35) and
      stays there; with a mean (74) or last-point (92) init it would stay
      in cluster 2 for good.
    """
    vals = [0, 1, 2, 35, 40, 90, 92, 150, 151, 152]
    pts = np.array([[v, 0] for v in vals], np.int64)
    cents, assign, _ = kmeans.kmeans(pts, 3)
    assert assign.tolist() == [2, 2, 2, 1, 1, 1, 1, 0, 0, 0]
    # converged truncated means of {35,40,90,92}, {0,1,2}, {150,151,152}
    assert cents.tolist() == [[151, 0], [64, 0], [1, 0]]


def test_weighted_mean_no_int32_overflow():
    """Regression for ADVICE.md r1: the base-256 long division overflowed
    once a cluster's total weight crossed ~2^23, silently corrupting the
    palette (all-[255]^3 with 2e7 total weight returned [40,40,40])."""
    pts = np.tile(np.array([[255, 255, 255]], np.int64), (4, 1))
    w = np.full(4, 5_000_000, np.int64)  # total weight 2e7 > 2^23
    cents, _, _ = kmeans.kmeans(pts, 1, weights=w)
    assert cents.tolist() == [[255, 255, 255]]
    # mixed-value truncation at scale: (255*15M + 0*5M) // 20M = 191
    pts = np.array([[255, 255, 255], [255, 255, 255], [255, 255, 255],
                    [0, 0, 0]], np.int64)
    cents, _, _ = kmeans.kmeans(pts, 1, weights=w)
    assert cents.tolist() == [[191, 191, 191]]


def test_total_weight_guard():
    with pytest.raises(ValueError, match="2\\^27"):
        kmeans.kmeans(np.zeros((2, 3), np.int64), 1,
                      weights=np.full(2, 2**26, np.int64))


def test_weighted_integer_mean():
    """ColorCount mean: sum(color*count)//sum(count) (clusterc.rs:92-113)."""
    colors = np.array([[0, 0, 0], [2, 2, 2]], np.int64)
    weights = np.array([1, 1], np.int64)
    cents, _, _ = kmeans.kmeans(colors, 1, weights=weights)
    assert cents.tolist() == [[1, 1, 1]]
    # weighted: (0*3 + 2*1) // 4 = 0
    weights = np.array([3, 1], np.int64)
    cents, _, _ = kmeans.kmeans(colors, 1, weights=weights)
    assert cents.tolist() == [[0, 0, 0]]


def test_truncated_division():
    pts = np.array([[0, 0], [0, 0], [1, 1]], np.int64)
    cents, _, _ = kmeans.kmeans(pts, 1)
    assert cents.tolist() == [[0, 0]]  # 1//3 = 0 truncation


def test_needs_enough_points():
    with pytest.raises(ValueError):
        kmeans.kmeans(np.zeros((2, 2), np.int64), 3)


def test_stay_on_tie():
    """A point equidistant to its own and another centroid must stay."""
    # two points at the same location, k=2: both centroids identical;
    # assignments must not oscillate
    pts = np.array([[5, 5], [5, 5]], np.int64)
    cents, assign, iters = kmeans.kmeans(pts, 2)
    assert iters <= 3


def test_packed_argmin_matches_plain():
    """The packed min-reduce (d2*pk + idx) must reproduce plain argmin's
    assignments and centroids exactly, including first-index tie breaking."""
    import cniic_tpu.ops.kmeans as km

    rng = np.random.default_rng(11)
    pts = np.column_stack([
        rng.integers(0, 512, 4096),
        rng.integers(0, 512, 4096),
        rng.integers(0, 256, 4096),
    ]).astype(np.int64)
    # duplicate many points so distance ties between centroids are common
    pts[2048:] = pts[:2048]

    c1, a1, i1 = km.kmeans(pts, 16)

    orig = km._kmeans_loop
    # force the plain-argmin fallback by rebinding pk=0 at the loop call.
    # pk must arrive as a keyword (kmeans.py passes pk=pk); if a refactor
    # ever makes it positional, fail loudly instead of silently zeroing
    # the wrong argument and comparing packed-vs-packed (review r4)
    def no_pack(*args, **kwargs):
        assert "pk" in kwargs, "pk is no longer a kwarg: update this test"
        kwargs["pk"] = 0
        return orig(*args, **kwargs)
    km._kmeans_loop = no_pack
    try:
        c2, a2, i2 = km.kmeans(pts, 16)
    finally:
        km._kmeans_loop = orig

    assert i1 == i2
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(c1, c2)


def test_kmeans_batch_lanes_match_single():
    """Lockstep lanes (different sizes, weighted + unweighted mix) must be
    bit-identical to running each point set alone: a lane is frozen the
    instant its own stop rule fires, regardless of its neighbours."""
    rng = np.random.default_rng(7)
    sets = [
        (rng.integers(0, 256, (500, 3)).astype(np.int64),
         rng.integers(1, 50, 500).astype(np.int64)),
        (rng.integers(0, 256, (1200, 3)).astype(np.int64), None),
        (rng.integers(0, 256, (37, 3)).astype(np.int64),
         np.ones(37, np.int64)),
    ]
    batched = kmeans.kmeans_batch([p for p, _ in sets], 8,
                                  weights_list=[w for _, w in sets])
    for (p, w), (bc, ba, _) in zip(sets, batched):
        sc, sa, _ = kmeans.kmeans(p, 8, weights=w)
        np.testing.assert_array_equal(bc, sc)
        np.testing.assert_array_equal(ba, sa)


def test_batch_mixed_dimensionality_raises(rng):
    """Mixed-d batches are a caller bug and must surface even in collect
    mode (ADVICE.md r2: the CrossLaneBoundError fallback used to swallow
    this and silently retry per-lane)."""
    p2 = rng.integers(0, 256, (64, 2)).astype(np.int64)
    p3 = rng.integers(0, 256, (64, 3)).astype(np.int64)
    with pytest.raises(ValueError, match="share dimensionality"):
        kmeans.kmeans_batch([p2, p3], 4, on_error="collect")


def test_batch_cross_lane_bound_falls_back_per_lane(rng):
    """The one legal per-lane retry: a global max_val*max_w overflow from
    mixing a high-value lane with a high-weight lane, each valid alone."""
    hi_val = rng.integers(0, 2048, (64, 3)).astype(np.int64)
    hi_val[0, 0] = 2100  # max_val 2100 * max_w 2^20 > 2^31 combined only
    hi_w = rng.integers(0, 256, (64, 3)).astype(np.int64)
    w_small = np.ones(64, np.int64)
    w_big = np.full(64, 2**20, np.int64)  # total weight 2^26 < 2^27 bound
    res = kmeans.kmeans_batch([hi_val, hi_w], 4,
                              weights_list=[w_small, w_big],
                              on_error="collect")
    assert all(not isinstance(r, Exception) for r in res)
    # per-lane results match running each lane alone
    solo = [kmeans.kmeans_batch([hi_val], 4, weights_list=[w_small])[0],
            kmeans.kmeans_batch([hi_w], 4, weights_list=[w_big])[0]]
    for r, s in zip(res, solo):
        np.testing.assert_array_equal(r[0], s[0])
        np.testing.assert_array_equal(r[1], s[1])


@pytest.mark.parametrize("n,k", [(64, 4), (64, 64), (17, 1), (100, 7), (9, 8)])
def test_device_init_matches_reference_formula(rng, n, k):
    """_widen_init's on-device init must equal an independent host replica
    of the reference's tail-chunk rule (kmeans.rs:61-78)."""
    import jax.numpy as jnp

    p = rng.integers(0, 256, (n, 3)).astype(np.int32)
    n_pad = -(-n // 8) * 8 + 8  # arbitrary padding
    pu = np.zeros((1, n_pad, 3), np.uint8)
    pu[0, :n] = p
    wu = np.zeros((1, n_pad), np.uint8)
    wu[0, :n] = 1
    _, _, _, valid, cur, cents = kmeans._widen_init(
        jnp.asarray(pu), jnp.asarray(wu),
        jnp.asarray(np.array([n], np.int32)), k)
    # host replica (straight from the reference's description)
    ppc = n // k
    tail = n - (k - 1) * ppc
    exp_cur = np.zeros(n_pad, np.int32)
    exp_cur[:tail] = k - 1
    for j in range(tail, n):
        exp_cur[j] = (n - 1 - j) // ppc
    exp_cents = np.array([p[n - (i + 1) * ppc] for i in range(k - 1)] + [p[0]])
    np.testing.assert_array_equal(np.asarray(valid)[0, :n], True)
    np.testing.assert_array_equal(np.asarray(valid)[0, n:], False)
    np.testing.assert_array_equal(np.asarray(cur)[0], exp_cur)
    np.testing.assert_array_equal(np.asarray(cents)[0], exp_cents)


# ---------------------------------------------------------------------------
# r4: lifted size caps (VERDICT r3 #2) — wide distances + adaptive planes
# ---------------------------------------------------------------------------

def test_wide_assignment_matches_f64_oracle():
    """Coordinates past the f32 integer-exact range (d2_bound >= 2^24, the
    4K-image regime) must still produce assignments identical to float64
    arithmetic: the wide path assembles d2 in int32 from exact sub-2^24
    matmul pieces."""
    import jax.numpy as jnp
    import cniic_tpu.ops.kmeans as km

    rng = np.random.default_rng(5)
    n, k = 2048, 16
    pts = np.column_stack([
        rng.integers(0, 4096, n),
        rng.integers(0, 2160, n),
        rng.integers(0, 256, n),
        rng.integers(0, 256, n),
        rng.integers(0, 256, n),
    ]).astype(np.int64)
    (pts_f, pts_i, w, valid, cur, cents, ns, bs, vp, wp, pk, pw, split,
     wide, d2b) = km._prep_host_batch([pts], k, None)
    assert wide and d2b >= 1 << 24, "test must exercise the wide path"

    new, _, _, _ = km._iteration(
        pts_f[0], pts_i[0], w[0], valid[0], cur[0],
        cents[0].astype(jnp.float32), k, jnp.int32(0), jnp.int32(n),
        bs, vp, wp, pk, pw, split, wide)

    p64 = pts.astype(np.float64)
    c64 = np.asarray(cents[0], np.float64)
    cur0 = np.asarray(cur[0][:n])
    d2 = ((p64[:, None, :] - c64[None]) ** 2).sum(-1)
    best = d2.argmin(1)
    cur_d2 = ((p64 - c64[cur0]) ** 2).sum(-1)
    expect = np.where(d2.min(1) < cur_d2, best, cur0)
    np.testing.assert_array_equal(np.asarray(new)[:n], expect)


def test_wide_e2e_centroids_exact():
    """Full k-means at 4K-scale coordinates: well-separated clusters give
    exactly their integer-truncated means."""
    far = [(100, 100), (4000, 4000), (100, 4000), (4000, 100)]
    pts = np.array(sum((_square_centered_at(p) for p in far), []), np.int64)
    cents, assign, _ = kmeans.kmeans(pts, 4)
    got = {tuple(c) for c in cents.tolist()}
    assert got == set(far)  # integer mean of each 3x3 square is its center
    # all 9 members of a square share one cluster
    for s in range(4):
        assert len(set(assign[s * 9:(s + 1) * 9].tolist())) == 1


def test_4bit_planes_match_8bit(monkeypatch):
    """Forcing the >=2^23-point plan (4-bit digit planes) on a small run
    must be bit-identical to the default 8-bit-plane plan."""
    import cniic_tpu.ops.kmeans as km

    rng = np.random.default_rng(13)
    pts = rng.integers(0, 256, (800, 3)).astype(np.int64)
    w = rng.integers(1, 300, 800).astype(np.int64)
    c1, a1, i1 = km.kmeans(pts, 8, weights=w)

    orig = km.plan_params
    def force_nibbles(max_val, max_w, d2_bound, k, n_max=0):
        return orig(max_val, max_w, d2_bound, k, n_max=1 << 23)
    monkeypatch.setattr(km, "plan_params", force_nibbles)
    c2, a2, i2 = km.kmeans(pts, 8, weights=w)
    assert i1 == i2
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(c1, c2)


def test_base64_split_matches_base32(monkeypatch):
    """Forcing the >8191-coordinate plan (base-64 hi/lo split + wide int32
    assembly) on small-coordinate data must be bit-identical: both paths
    claim exactness, so they must agree wherever both apply."""
    import cniic_tpu.ops.kmeans as km

    rng = np.random.default_rng(17)
    pts = np.column_stack([
        rng.integers(0, 2048, 3000),
        rng.integers(0, 1400, 3000),
        rng.integers(0, 256, 3000),
    ]).astype(np.int64)
    c1, a1, i1 = km.kmeans(pts, 12)

    orig = km.plan_params
    def force_wide(max_val, max_w, d2_bound, k, n_max=0):
        bs, vp, wp, pk, pw, split, wide = orig(
            max_val, max_w, d2_bound, k, n_max)
        return bs, vp, wp, pk, pw, 64, True
    monkeypatch.setattr(km, "plan_params", force_wide)
    c2, a2, i2 = km.kmeans(pts, 12)
    assert i1 == i2
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(c1, c2)


def test_size_caps():
    """The honest remaining caps: coordinates <= 16383, total weight (and
    point count) < 2^27. A 4K image's 8.3M points now validate."""
    import cniic_tpu.ops.kmeans as km

    km._validate_lane(np.zeros((10, 2), np.int64) + 16383, None, 2)
    with pytest.raises(ValueError, match="16383"):
        km._validate_lane(np.zeros((10, 2), np.int64) + 16384, None, 2)
    # 4K-image point count passes validation (the old cap was 4M)
    p = np.broadcast_to(np.int16(1), (3840 * 2160, 1))
    km._validate_lane(p, None, 2)
    with pytest.raises(ValueError, match="2\\^27"):
        km._validate_lane(np.broadcast_to(np.int16(1), (1 << 27, 1)), None, 2)


def test_voronoi_wide_image_path():
    """voronoi_centroids_batch on an image wider than the old 2048-coord
    exact range: the wide plan engages and centroids stay in range."""
    rng = np.random.default_rng(23)
    h, w = 6, 4100
    imgs = rng.integers(0, 256, (1, h, w, 3), np.uint8)
    bs, vp, wp, pk, pw, split, wide = kmeans.plan_params(
        max(w - 1, h - 1, 255), 1,
        (w - 1) ** 2 + (h - 1) ** 2 + 3 * 255 ** 2, 4, h * w)
    assert wide, "a 4100-wide image must take the wide path"
    (cents,) = kmeans.voronoi_centroids_batch(imgs, 4)
    assert cents.shape == (4, 5)
    assert cents[:, 0].max() < w and cents[:, 1].max() < h
    assert cents[:, 2:].max() <= 255

    # bit-parity with the host-built point formulation on the same data
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    pts = np.column_stack([xs.ravel(), ys.ravel(),
                           imgs[0].reshape(-1, 3)]).astype(np.int64)
    c2, _, _ = kmeans.kmeans(pts, 4)
    np.testing.assert_array_equal(cents, c2)


def test_kmeans_batch_lane_chunking_bit_identical():
    """Batches deeper than CNIIC_KMEANS_LANES run as consecutive chunks
    (deep lockstep batches add straggler iterations); centroids and assignments must be identical under any chunking — only
    the reported lockstep iteration count is grouping-dependent."""
    import os

    rng = np.random.default_rng(0)
    pts = [rng.integers(0, 256, (200 + 7 * i, 3)) for i in range(13)]
    a = kmeans.kmeans_batch(pts, 8)  # default chunk 8 -> [8, 5]
    os.environ["CNIIC_KMEANS_LANES"] = "4"
    try:
        b = kmeans.kmeans_batch(pts, 8)  # chunks [4, 4, 4, 1]
    finally:
        os.environ.pop("CNIIC_KMEANS_LANES", None)
    for (c1, a1, _), (c2, a2, _) in zip(a, b):
        np.testing.assert_array_equal(c1, c2)
        np.testing.assert_array_equal(a1, a2)


def test_chunk_prefetch_bit_identical(monkeypatch):
    """r5: the chunked path prefetches the next chunk's prep/upload on a
    worker thread while the current chunk drives (the stage is
    transfer-bound — phase probe). Results must be bit-identical with the
    overlap on and off, including collect-mode batches where a chunk
    carries an invalid lane (those chunks fall back to the serial path)."""
    rng = np.random.default_rng(3)
    pts = [rng.integers(0, 256, (150 + 11 * i, 3)) for i in range(10)]
    wts = [rng.integers(1, 300, (p.shape[0],)).astype(np.int64)
           for p in pts]
    pts[6] = pts[6][:4]  # < k: invalid lane in the second chunk
    wts[6] = wts[6][:4]
    monkeypatch.setenv("CNIIC_KMEANS_LANES", "4")
    monkeypatch.setenv("CNIIC_KMEANS_PREFETCH", "0")
    a = kmeans.kmeans_batch(pts, 8, weights_list=wts, on_error="collect")
    monkeypatch.setenv("CNIIC_KMEANS_PREFETCH", "1")
    b = kmeans.kmeans_batch(pts, 8, weights_list=wts, on_error="collect")
    assert isinstance(a[6], Exception) and isinstance(b[6], Exception)
    for i, (ra, rb) in enumerate(zip(a, b)):
        if i == 6:
            continue
        np.testing.assert_array_equal(ra[0], rb[0])
        np.testing.assert_array_equal(ra[1], rb[1])


def test_compile_keys_quantized_at_ns_statistics():
    """r5: the loop bodies' static jit args must be COARSE functions of
    the batch content. `burst` (from the exact max point count) and the
    fused kernel's `d2b` (from the exact per-dim maxima) were fine-grained
    — at ns1000 statistics nearly every 8-lane kmeans batch recompiled the
    ~18 s fused loop (measured 19.05 s vs 0.62 s warm for the same shapes;
    the whole NS cluster-colors leg read 0.48 MP/s compile-bound). Pin the
    quantization: real consecutive-chunk stats from that run must collapse
    to identical compile keys."""
    from cniic_tpu.ops.kmeans import (_burst, _pad_bucket, _pow2_ceil,
                                      plan_params)

    # max unique-color counts of consecutive ns1000 8-lane chunks: the
    # padded point count (a SHAPE, so a compile key) must collapse onto
    # the coarse ladder {1,2,3,4,6,8,12,16,...} x 65536 (<=33% padding),
    # and burst is a pure function of the padded size
    chunk_nmax = [456153, 454737, 434140, 429586, 461587, 375509]
    pads = {_pad_bucket(n, 65536) for n in chunk_nmax}
    assert pads <= {393216, 524288}
    for n in chunk_nmax:
        pad = _pad_bucket(n, 65536)
        assert n <= pad < n * 4 // 3 + 65536
    assert len({_burst(_pad_bucket(n, 65536), 8) for n in chunk_nmax}) == 1
    # per-dim maxima 255 vs 254/253: same canonical exactness bound
    assert len({_pow2_ceil(3 * m * m) for m in (255, 254, 253)}) == 1
    # plan_params outputs are coarse too: nearby max weights (same octave)
    # and the two d2 bounds above plan identically
    plans = {plan_params(255, mw, 3 * m * m, 32, n)
             for mw in (700, 900) for m in (254, 255) for n in chunk_nmax}
    assert len(plans) == 1


def test_burst_quantization_bit_identical():
    """Burst size only splits the same trajectory into device calls: the
    results must not depend on it (the pow2 quantization changed every
    burst value)."""
    rng = np.random.default_rng(7)
    pts = rng.integers(0, 256, (4096, 3))
    w = rng.integers(1, 1000, (4096,))
    base = kmeans.kmeans(pts, 16, weights=w)
    import cniic_tpu.ops.kmeans as km

    orig = km._burst
    km._burst = lambda n_max, B: 4
    try:
        forced = kmeans.kmeans(pts, 16, weights=w)
    finally:
        km._burst = orig
    np.testing.assert_array_equal(base[0], forced[0])
    np.testing.assert_array_equal(base[1], forced[1])


def test_w_bound_bit_identical():
    """r5: a structural weight bound only widens the digit-plane counts
    (vp/wp) — extra leading planes are zero, so centroids and assignments
    must be bit-identical to the measured-max_w plan."""
    rng = np.random.default_rng(11)
    pts = rng.integers(0, 256, (3000, 3))
    w = rng.integers(1, 700, (3000,))  # measured max_w ~700 (vp=3, wp=2)
    base = kmeans.kmeans(pts, 16, weights=w)
    bound = kmeans.kmeans(pts, 16, weights=w, w_bound=1 << 20)  # vp=4, wp=3
    np.testing.assert_array_equal(base[0], bound[0])
    np.testing.assert_array_equal(base[1], bound[1])
    assert base[2] == bound[2]


def test_w_bound_below_measured_raises():
    rng = np.random.default_rng(12)
    pts = rng.integers(0, 256, (500, 3))
    w = rng.integers(1, 1000, (500,))
    w[7] = 5000
    with pytest.raises(ValueError, match="w_bound"):
        kmeans.kmeans(pts, 8, weights=w, w_bound=4999)


def test_w_bound_collapses_weight_tier_keys():
    """The digit-plane counts are compile keys; under a shape-driven
    w_bound they must not depend on the weight content even when the
    measured max weight crosses bit-length tiers (the r5 follow-up
    fragmentation class; scripts/experiments/kmeans_key_census.py is the
    corpus-scale census)."""
    from cniic_tpu.ops.kmeans import static_compile_key

    tiers = [700, 70_000]  # measured (vp, wp) = (3, 2) vs (4, 3)
    measured = {tuple(static_compile_key(
        1 << 19, 255, mw, 3 * 255 * 255, 32, 8).items()) for mw in tiers}
    assert len(measured) == 2  # the fragmentation being fixed
    # same varying measured weights, but WITH the structural bound — the
    # full production key must collapse (both tiers are >=256 so even the
    # widening dtype agrees; a broken w_bound plumbing would split this
    # set exactly like `measured`)
    bounded = {tuple(static_compile_key(
        1 << 19, 255, mw, 3 * 255 * 255, 32, 8,
        w_bound=1 << 20).items()) for mw in tiers}
    assert len(bounded) == 1


def test_weight_upload_tiers_bit_identical(monkeypatch):
    """r5: weights >= 256 upload as u16 low halves + a padded sparse
    overflow scatter (_widen_init_ovf; the i32 weight plane is the largest
    upload of the stage). Results must be
    bit-identical to the reference int32 upload across tiers — including
    lanes whose weights cross 65535 (sparse high parts), a lane with
    >_OVF_MIN overflow entries (the pow2 pad ladder), and mixed batches."""
    import cniic_tpu.ops.kmeans as km

    rng = np.random.default_rng(13)
    sets = [
        (rng.integers(0, 256, (700, 3)).astype(np.int64),
         rng.integers(1, 200, 700).astype(np.int64)),       # u8 tier
        (rng.integers(0, 256, (900, 3)).astype(np.int64),
         rng.integers(1, 60_000, 900).astype(np.int64)),    # u16, no ovf
    ]
    w_big = rng.integers(1, 2_000, 1100).astype(np.int64)
    w_big[[3, 500, 1050]] = [70_000, 131_072, 1_000_000]    # sparse hi
    sets.append((rng.integers(0, 256, (1100, 3)).astype(np.int64), w_big))
    w_many = np.full(200, 70_000, np.int64)                 # 200 > _OVF_MIN
    sets.append((rng.integers(0, 256, (200, 3)).astype(np.int64), w_many))

    pts_l = [p for p, _ in sets]
    wts_l = [w for _, w in sets]
    batched = km.kmeans_batch(pts_l, 8, weights_list=wts_l)

    orig = km.static_compile_key

    def forced_i32(*a, **kw):
        plan = orig(*a, **kw)
        if plan["w_dtype"] != "u8":
            plan = dict(plan, w_dtype="i32")
        return plan

    monkeypatch.setattr(km, "static_compile_key", forced_i32)
    wide = km.kmeans_batch(pts_l, 8, weights_list=wts_l)
    for (bc, ba, bi), (wc, wa, wi) in zip(batched, wide):
        assert bi == wi
        np.testing.assert_array_equal(bc, wc)
        np.testing.assert_array_equal(ba, wa)


def test_pack_results_u8_matches_u16():
    """The u8-packed result fetch must carry the same assignments and
    centroids as the u16 packing whenever both apply (k <= 256, values
    <= 255)."""
    import jax.numpy as jnp

    import cniic_tpu.ops.kmeans as km

    rng = np.random.default_rng(5)
    cur = jnp.asarray(rng.integers(0, 32, (2, 64)).astype(np.int32))
    cents = jnp.asarray(rng.integers(0, 256, (2, 32, 3)).astype(np.int32))
    p8 = np.asarray(km._pack_results_u8(cur, cents, 32))
    p16 = np.asarray(km._pack_results_u16(cur, cents, 32))
    assert p8.dtype == np.uint8 and p16.dtype == np.uint16
    np.testing.assert_array_equal(p8.astype(np.uint16), p16)


def test_clusterc_lane_sort_bit_identical(monkeypatch):
    """r5: cluster-colors sorts lanes by unique count before the chunked
    batch run (homogeneous chunks avoid padding/straggler waste). With
    chunk size forced to 2 the grouping differs materially from input
    order; streams must still match per-image encode exactly."""
    from cniic_tpu.codecs import from_spec

    rng = np.random.default_rng(13)
    imgs = []
    for uniq_scale in (4, 200, 8, 180, 16):  # skewed unique counts
        im = (rng.integers(0, uniq_scale, (32, 32, 1)) * 3 +
              rng.integers(0, 2, (32, 32, 3))).astype(np.uint8)
        imgs.append(im)
    monkeypatch.setenv("CNIIC_KMEANS_LANES", "2")
    codec = from_spec("cluster-colors(8)")
    batched = codec.encode_batch(imgs)
    singles = [codec.encode(im) for im in imgs]
    assert batched == singles


def test_drive_bursts_match_static_compile_key(monkeypatch):
    """_drive derives its bursts from the padded shape via the same leaf
    functions static_compile_key composes — spy on the leaves during a
    real batch run and pin the values to the helper's entries (the census
    and any future key audit rely on this equality; r5 review)."""
    from cniic_tpu.ops import kmeans as km

    calls = {}
    orig = km._burst

    def spy(n_max, B):
        v = orig(n_max, B)
        calls["burst"] = (n_max, B, v)
        return v

    monkeypatch.setattr(km, "_burst", spy)
    rng = np.random.default_rng(21)
    pts = [rng.integers(0, 256, (3000, 3)) for _ in range(3)]
    ws = [rng.integers(1, 700, (3000,)) for _ in range(3)]
    km.kmeans_batch(pts, 8, ws, w_bound=1 << 20)

    max_val = max(int(p.max()) for p in pts)
    max_w = max(int(w.max()) for w in ws)
    d2b = max(int(np.sum(p.max(axis=0).astype(np.int64) ** 2)) for p in pts)
    plan = km.static_compile_key(3000, max_val, max_w, d2b, 8, 3,
                                 w_bound=1 << 20)
    n_pad, B, v = calls["burst"]
    assert n_pad == plan["n_pad"]  # burst sized from the PADDED count
    assert B == plan["B"]
    assert v == plan["burst"]


def test_pad_bucket_ladder_properties():
    """_pad_bucket must (a) never pad below the true count, (b) keep the
    padded block count within the ladder's worst-case step (<= 3b/2 + 1
    blocks — ~50% just past a pow2 rung, 33% past a 1.5x rung), (c) emit
    only ladder sizes (pow2 or 3*2^m blocks) so the number of distinct
    shapes over any corpus is O(log n), and (d) be monotone (a bigger
    batch never gets a smaller pad)."""
    from cniic_tpu.ops.kmeans import _pad_bucket

    bs = 65536
    prev = 0
    for n in list(range(1, 4 * bs, 997)) + [
            bs, bs + 1, 3 * bs, 2**20, 2**20 + 1, 2**22 - 1, 2**22]:
        p = _pad_bucket(n, bs)
        assert p >= n
        assert p % bs == 0
        blocks = p // bs
        # ladder membership: pow2 or 3 * pow2
        assert blocks & (blocks - 1) == 0 or (
            blocks % 3 == 0 and ((blocks // 3) & (blocks // 3 - 1)) == 0)
        true_blocks = -(-n // bs)
        assert blocks <= 3 * true_blocks // 2 + 1  # worst-case ladder step
    for n in range(1, 300_000, 1111):
        p = _pad_bucket(n, bs)
        assert p >= prev  # monotone: a bigger batch never pads smaller
        prev = p


def test_k_zero_rejected_everywhere(rng):
    """k == 0 must reject with ValueError at every entry point — before any
    n // k — and stay inside collect-mode's per-lane isolation (review r5)."""
    pts = rng.integers(0, 256, (50, 3)).astype(np.int64)
    with pytest.raises(ValueError):
        kmeans.kmeans(pts, 0)
    out = kmeans.kmeans_batch([pts, pts], 0, on_error="collect")
    assert all(isinstance(r, ValueError) for r in out)
    imgs = rng.integers(0, 256, (2, 6, 6, 3)).astype(np.uint8)
    out = kmeans.voronoi_centroids_batch(imgs, 0, on_error="collect")
    assert all(isinstance(r, ValueError) for r in out)
