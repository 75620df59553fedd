"""Huffman vectors (reference huf.rs tests) + device/host packer parity."""

import numpy as np
import pytest

from cniic_tpu import huffman, native, wire
from cniic_tpu.ops import bitpack


def test_code_lens_abc():
    # huf.rs:417-424: freqs a:2 b:1 c:1 -> lens 1,2,2
    book = huffman.build_codebook(np.array([2, 1, 1], np.uint64))
    assert book.lens.tolist() == [1, 2, 2]


def test_single_symbol_zero_length():
    # huf.rs:140-142: one symbol encodes with zero bits
    book = huffman.build_codebook(np.array([42], np.uint64))
    assert book.lens.tolist() == [0]
    payloads = np.array([[7, 7, 7, 7, 7, 7]], np.uint8)
    stream = huffman.encode_stream(np.zeros(5, np.int32), np.array([42], np.uint64), payloads)
    # tree = single leaf tag + 6-byte payload, no payload bits
    assert stream == bytes([0, 7, 7, 7, 7, 7, 7])
    got_payloads, ids = huffman.decode_stream(stream, 6, 5)
    assert ids.tolist() == [0] * 5


def test_kraft_equality(rng):
    freqs = rng.integers(1, 1000, 500).astype(np.uint64)
    book = huffman.build_codebook(freqs)
    assert abs(np.sum(2.0 ** -book.lens.astype(np.float64)) - 1.0) < 1e-9


def test_optimal_total_bits():
    # total payload bits must equal sum(freq * len) of ANY optimal code;
    # cross-check against a straightforward heapq huffman
    import heapq
    rng = np.random.default_rng(7)
    freqs = rng.integers(1, 100, 64).astype(np.int64)
    heap = [(int(f), i) for i, f in enumerate(freqs)]
    heapq.heapify(heap)
    total_ref = 0
    while len(heap) > 1:
        a = heapq.heappop(heap)
        b = heapq.heappop(heap)
        total_ref += a[0] + b[0]
        heapq.heappush(heap, (a[0] + b[0], -1))
    book = huffman.build_codebook(freqs.astype(np.uint64))
    total_ours = int((freqs * book.lens.astype(np.int64)).sum())
    assert total_ours == total_ref


def test_tree_serialization_roundtrip(rng):
    freqs = rng.integers(1, 500, 40).astype(np.uint64)
    book = huffman.build_codebook(freqs)
    payloads = rng.integers(0, 256, (40, 11)).astype(np.uint8)
    tree = huffman.serialize_tree(book, payloads)
    # 2u-1 tags + u*leaf
    assert len(tree) == (2 * 40 - 1) + 40 * 11
    left, right, symbol, got_payloads, consumed = huffman.parse_tree(tree, 11)
    assert consumed == len(tree)
    # every original payload appears exactly once
    assert sorted(map(bytes, got_payloads)) == sorted(map(bytes, payloads))


def test_encode_decode_roundtrip(rng):
    u = 200
    freqs = rng.integers(1, 5000, u).astype(np.uint64)
    payloads = rng.integers(0, 256, (u, 11)).astype(np.uint8)
    ids = rng.integers(0, u, 7000).astype(np.int32)
    stream = huffman.encode_stream(ids, freqs, payloads)
    got_payloads, got_ids = huffman.decode_stream(stream, 11, ids.size)
    assert np.array_equal(got_payloads[got_ids], payloads[ids])


def test_device_host_pack_parity(rng):
    u = 64
    freqs = rng.integers(1, 5000, u).astype(np.uint64)
    book = huffman.build_codebook(freqs)
    ids = rng.integers(0, u, 3000).astype(np.int32)
    dev = bitpack.pack_bits_device(ids, book.codes, book.lens)
    host = bitpack.pack_bits_numpy(book.codes[ids], book.lens[ids])
    assert dev == host


def test_pack_matches_bitwriter(rng):
    """The vectorized packer must equal the sequential MSB-first writer."""
    codes = np.array([0b010, 0b0110011, 0b1], np.uint64)
    lens = np.array([3, 7, 1], np.uint32)
    ids = np.array([0, 1, 2, 2, 1, 0], np.int32)
    bw = wire.BitWriter()
    for i in ids:
        bw.write_bits(int(codes[i]), int(lens[i]))
    bw.pad_and_flush()
    assert bitpack.pack_bits_numpy(codes[ids], lens[ids]) == bw.getvalue()
    assert bitpack.pack_bits_device(ids, codes, lens) == bw.getvalue()


def test_long_codes_pack():
    """Codes up to 63 bits span three 32-bit words in the device packer."""
    codes = np.array([(1 << 63) - 1, 0, 5], np.uint64)
    lens = np.array([63, 1, 3], np.uint32)
    ids = np.array([0, 1, 0, 2, 1, 0], np.int32)
    host = bitpack.pack_bits_numpy(codes[ids], lens[ids])
    dev = bitpack.pack_bits_device(ids, codes, lens)
    assert dev == host


def test_huf_decode_walker():
    # hand-built trie: root -> (leaf a | branch -> (leaf b | leaf c))
    left = np.array([1, -1, 3, -1, -1], np.int32)
    right = np.array([2, -1, 4, -1, -1], np.int32)
    symbol = np.array([-1, 0, -1, 1, 2], np.int32)
    # bits: a=0 b=10 c=11; stream "abcabc" = 0 10 11 0 10 11 -> 0101 1010 11(pad)
    payload = bytes([0b01011010, 0b11000000])
    out = native.huf_decode(payload, left, right, symbol, 0, 6)
    assert out.tolist() == [0, 1, 2, 0, 1, 2]


def test_hist_u32_edge_cases(rng):
    from cniic_tpu import native

    # all identical
    u, c, inv = native.hist_u32(np.full(100, 7, np.uint32))
    assert u.tolist() == [7] and c.tolist() == [100] and (inv == 0).all()
    # all distinct, descending input
    keys = np.arange(50, dtype=np.uint32)[::-1].copy()
    u, c, inv = native.hist_u32(keys)
    assert np.array_equal(u, np.arange(50)) and (c == 1).all()
    assert np.array_equal(u[inv], keys)
    # random parity vs np.unique
    keys = rng.integers(0, 1000, 10000).astype(np.uint32)
    u, c, inv = native.hist_u32(keys)
    u2, inv2, c2 = np.unique(keys, return_inverse=True, return_counts=True)
    assert np.array_equal(u, u2) and np.array_equal(c, c2) and np.array_equal(inv, inv2)
    # single element
    u, c, inv = native.hist_u32(np.array([123456], np.uint32))
    assert u.tolist() == [123456] and c.tolist() == [1]


def test_batch_encode_ragged(rng):
    """Different stream lengths and alphabets in one batch."""
    from cniic_tpu import huffman

    keys = [rng.integers(0, 50, n).astype(np.uint32) for n in (17, 5000, 1)]
    payload_fn = lambda u: np.repeat(u.astype(np.uint8)[:, None], 6, axis=1)
    streams = huffman.batch_encode(keys, payload_fn)
    for k, s in zip(keys, streams):
        payloads, ids = huffman.decode_stream(s, 6, k.size)
        decoded_keys = payloads[ids][:, 0].astype(np.uint32)
        assert np.array_equal(decoded_keys, k)


def test_fast_decode_matches_walker():
    """huf_decode_fast (10-bit prefix table) must decode the exact same ids
    as the bit-serial walker on arbitrary trees: skewed frequencies (deep
    codes past the table depth), uniform ones, tiny alphabets, and
    truncated payloads (EOF mid-code)."""
    import numpy as np

    from cniic_tpu import huffman, native

    rng = np.random.default_rng(9)
    cases = []
    # skewed: geometric frequencies -> code lengths far beyond 10 bits
    u = 40
    freqs = (2.0 ** np.arange(u)).astype(np.uint64)
    ids = rng.integers(0, u, 5000)
    cases.append((freqs, ids))
    # uniform small
    freqs = np.full(300, 7, np.uint64)
    cases.append((freqs, rng.integers(0, 300, 4096)))
    # two symbols (1-bit codes)
    cases.append((np.array([3, 9], np.uint64), rng.integers(0, 2, 999)))
    # large alphabet (north-star statistics): ~200k uniques push average
    # code length past the 16-bit root table, so nearly every symbol
    # resolves through a second-level subtable (r5 packed arena); the
    # Zipf tail mixes subtable depths (dm 1..cap) within one tree
    u = 200_000
    freqs = (1e7 / np.arange(1, u + 1)).astype(np.uint64) + 1
    cases.append((freqs, rng.integers(0, u, 30_000)))

    for freqs, ids in cases:
        book = huffman.build_codebook(freqs)
        leafs = np.zeros((freqs.size, 1), np.uint8)
        tree = huffman.serialize_tree(book, leafs)
        payload = huffman.encode_payload(ids.astype(np.int32), book, device=False)
        left, right, symbol, _, _ = huffman.parse_tree(
            np.frombuffer(tree, np.uint8), 1)
        slow = native.huf_decode(payload, left, right, symbol, 0, ids.size,
                                 fast=False)
        fast = native.huf_decode(payload, left, right, symbol, 0, ids.size,
                                 fast=True)
        np.testing.assert_array_equal(fast, slow)
        # truncated payload: same partial output
        if len(payload) > 4:
            cut = payload[: len(payload) // 2]
            slow = native.huf_decode(cut, left, right, symbol, 0, ids.size,
                                     fast=False)
            fast = native.huf_decode(cut, left, right, symbol, 0, ids.size,
                                     fast=True)
            np.testing.assert_array_equal(fast, slow)


def test_native_packer_matches_bitwriter(rng):
    """The C pack_bits must emit the exact BitWriter byte stream."""
    import numpy as np

    from cniic_tpu import huffman, native, wire

    for u, n in ((5, 333), (300, 5000), (2, 77)):
        freqs = rng.integers(1, 999, u).astype(np.uint64)
        book = huffman.build_codebook(freqs)
        ids = rng.integers(0, u, n).astype(np.int32)
        got = native.pack_bits(book.codes, book.lens, ids)
        bw = wire.BitWriter()
        for s in ids:
            bw.write_bits(int(book.codes[s]), int(book.lens[s]))
        bw.pad_and_flush()
        assert got == bw.getvalue()


def test_hist_rgb_matches_numpy_pack(rng):
    import numpy as np

    from cniic_tpu import native
    from cniic_tpu.ops import histogram

    px = rng.integers(0, 256, (5000, 3)).astype(np.uint8)
    uniq, counts, inverse = native.hist_rgb(px)
    uniq2, counts2, inverse2 = native.hist_u32(histogram.pack_colors(px))
    np.testing.assert_array_equal(uniq, uniq2)
    np.testing.assert_array_equal(counts, counts2)
    np.testing.assert_array_equal(inverse, inverse2)


def test_hist_rgb_u32_pair_tier_boundary(rng):
    """The n <= 2^20 u32-pair MSD path (r5) must agree bit-for-bit with the
    independent LSD u64 implementation on both sides of its size boundary,
    in the radix regime (high uniques defeat the hash tier)."""
    import numpy as np

    from cniic_tpu import native
    from cniic_tpu.ops import histogram

    for n in ((1 << 20) - 3, 1 << 20, (1 << 20) + 5):
        px = rng.integers(0, 256, (n, 3)).astype(np.uint8)
        uniq, counts, inverse = native.hist_rgb(px)
        uniq2, counts2, inverse2 = native.hist_u32(histogram.pack_colors(px))
        assert uniq.shape[0] > 26_000  # really the radix regime
        np.testing.assert_array_equal(uniq, uniq2)
        np.testing.assert_array_equal(counts, counts2)
        np.testing.assert_array_equal(inverse, inverse2)


def test_delta_keys_matches_reference_recurrence(rng):
    import numpy as np

    from cniic_tpu import native

    scan = rng.integers(0, 256, (4096, 3)).astype(np.uint8)
    got = native.delta_keys(scan)
    d = scan.astype(np.int32)
    d[1:] -= scan[:-1].astype(np.int32)  # implicit [0,0,0] predecessor
    d += 255
    want = (d[:, 0].astype(np.uint32) << 18) | \
        (d[:, 1].astype(np.uint32) << 9) | d[:, 2].astype(np.uint32)
    np.testing.assert_array_equal(got, want)


def test_hist_u32_hash_and_radix_paths_agree(rng):
    """The r4 hash front-end (low-unique streams) must be output-identical
    to the radix path across the dispatch boundary: uniques stay ascending
    and inverse ids identical, whichever engine ran."""
    from cniic_tpu import native

    n = 200_000
    # below / around / above the 16k hash unique cap, and key widths on
    # both sides of the radix pass thresholds (12/24-bit digits)
    for bits in (12, 24, 27, 32):
        for space in (17, 9_000, 16_000, 17_000, 120_000):
            hi = (1 << bits) - 1
            pool = rng.integers(0, hi + 1, space, dtype=np.uint64
                                ).astype(np.uint32)
            keys = pool[rng.integers(0, space, n)]
            u, c, inv = native.hist_u32(keys)
            u2, inv2, c2 = np.unique(keys, return_inverse=True,
                                     return_counts=True)
            assert np.array_equal(u, u2), (bits, space)
            assert np.array_equal(c, c2), (bits, space)
            assert np.array_equal(inv, inv2.astype(np.int32)), (bits, space)
    # structured keys: consecutive ints are the multiplicative-hash
    # clustering case (the low product bits are a permutation of
    # k mod table_size — 6.3 probes/elem before the high-bits fix)
    keys = (np.arange(n, dtype=np.uint32) % 9_000) + (1 << 20)
    u, c, inv = native.hist_u32(keys)
    u2, inv2, c2 = np.unique(keys, return_inverse=True, return_counts=True)
    assert np.array_equal(u, u2) and np.array_equal(c, c2)
    assert np.array_equal(inv, inv2.astype(np.int32))


def test_hist_u32_adaptive_tiers_agree(rng):
    """r5 adaptive table sizing: streams landing in each sample-ds tier
    (2^17 / 2^19 / 2^20), the radix regime, and the in-pass bail (a
    sample under-estimate) must all be output-identical to numpy."""
    from cniic_tpu import native

    n = 1 << 20
    # pool sizes whose realized unique counts land in the three hash tiers
    # and the radix regime (measured ds ≈ 15.5k at 47k uniques, ≈ 25k at
    # 250k, > 26k beyond ~320k)
    for space in (5_000, 47_000, 250_000, 420_000):
        pool = rng.integers(0, 1 << 24, space, dtype=np.uint64
                            ).astype(np.uint32)
        keys = pool[rng.integers(0, space, n)]
        u, c, inv = native.hist_u32(keys)
        u2, inv2, c2 = np.unique(keys, return_inverse=True,
                                 return_counts=True)
        assert np.array_equal(u, u2), space
        assert np.array_equal(c, c2), space
        assert np.array_equal(inv, inv2.astype(np.int32)), space

    # in-pass bail: a low-ds mixture (90% from a 1k pool) whose total
    # unique count exceeds the chosen tier's cap — the pass must abandon
    # the hash mid-stream and the radix result must come back identical
    pool_small = rng.integers(0, 1 << 24, 1_000, dtype=np.uint64
                              ).astype(np.uint32)
    keys = pool_small[rng.integers(0, 1_000, n)]
    distinct = rng.permutation((1 << 25) + np.arange(120_000)
                               ).astype(np.uint32)
    idx = rng.choice(n, 120_000, replace=False)
    keys[idx] = distinct
    u, c, inv = native.hist_u32(keys)
    u2, inv2, c2 = np.unique(keys, return_inverse=True, return_counts=True)
    assert u.shape[0] > 49_152  # really exceeded the 2^17 tier's cap
    assert np.array_equal(u, u2) and np.array_equal(c, c2)
    assert np.array_equal(inv, inv2.astype(np.int32))


def test_hist_u32_top_key_sentinel():
    """0xFFFFFFFF must not collide with the hash tables' empty sentinel
    (k+1 wrapped to 0 in a u32 slot before the r4 review fix)."""
    from cniic_tpu import native

    k = np.full(200_000, 0xFFFFFFFF, np.uint32)
    k[::7] = 5
    u, c, inv = native.hist_u32(k)
    u2, inv2, c2 = np.unique(k, return_inverse=True, return_counts=True)
    assert np.array_equal(u, u2) and np.array_equal(c, c2)
    assert np.array_equal(inv, inv2.astype(np.int32))


def test_tree_count_matches_parse(rng):
    """huf_tree_count (the table-sizing pass, review r5) must agree with
    huf_tree_parse on nodes/consumed for shallow, deep (geometric
    frequencies), and single-leaf trees — with a multi-MB payload appended,
    since parse receives the whole remaining stream."""
    import ctypes

    from cniic_tpu import native

    lib = native._load()
    cases = [
        rng.integers(1, 1000, 500).astype(np.uint64),     # bushy
        (2.0 ** np.arange(40)).astype(np.uint64),         # max-depth chain
        np.array([7], np.uint64),                         # single leaf
    ]
    for freqs in cases:
        book = huffman.build_codebook(freqs)
        payloads = rng.integers(0, 256, (freqs.size, 11)).astype(np.uint8)
        tree = huffman.serialize_tree(book, payloads)
        data = np.frombuffer(tree + bytes(2_000_000), np.uint8)
        consumed = ctypes.c_int64()
        n = lib.huf_tree_count(native._as_u8p(data), data.size, 11,
                               ctypes.byref(consumed))
        assert n == 2 * freqs.size - 1
        assert consumed.value == len(tree)
        left, right, symbol, got, consumed2 = huffman.parse_tree(data, 11)
        assert len(left) == n and consumed2 == len(tree)
        # preorder leaf order; every payload appears exactly once
        assert sorted(map(bytes, got)) == sorted(map(bytes, payloads))
    # malformed streams still reject via the counting pass
    with pytest.raises(ValueError):
        huffman.parse_tree(np.frombuffer(b"\x02", np.uint8), 11)
    with pytest.raises(ValueError):
        huffman.parse_tree(np.frombuffer(b"\x01\x00", np.uint8), 11)


def test_huf_lens_unsorted_matches_argsort_composition(rng):
    """The fused C sort+two-queue+unscatter (r5 encode-scratch series) must
    be bit-identical to the numpy formulation it replaced:
    lens[argsort(freqs, stable)] = huf_lengths(sorted freqs)."""
    cases = [
        rng.integers(1, 1_000_000, size=200_000).astype(np.uint64),
        np.ones(1_000, np.uint64),                            # all ties
        rng.integers(1, 5, size=50_000).astype(np.uint64),    # heavy ties
        np.array([7], np.uint64),                             # single symbol
        np.array([3, 3], np.uint64),
        rng.integers(1, 2**40, size=20_000).astype(np.uint64),  # >32-bit
        np.arange(1, 30_000, dtype=np.uint64)[::-1].copy(),   # descending
    ]
    for freqs in cases:
        order = np.argsort(freqs, kind="stable")
        want = np.empty(freqs.size, np.uint32)
        want[order] = native.huf_lengths(freqs[order])
        got = native.huf_lens_unsorted(freqs)
        assert np.array_equal(got, want)


def test_encode_scratch_reuse_is_stateless(rng):
    """The thread-local grow-once encode scratch (histogram pair arrays,
    hash tables, tree-build tables) must make repeated and interleaved
    calls bit-identical to fresh-process results: a big call followed by
    a small one must not leak state through the reused buffers."""
    big = rng.integers(0, 2**24, size=500_000).astype(np.uint32)   # radix
    small = rng.integers(0, 300, size=10_000).astype(np.uint32)    # hash
    first = [native.hist_u32(k) for k in (big, small, big)]
    second = [native.hist_u32(k) for k in (big, small, big)]
    for (u1, c1, i1), (u2, c2, i2) in zip(first, second):
        assert np.array_equal(u1, u2)
        assert np.array_equal(c1, c2)
        assert np.array_equal(i1, i2)
    # interleave codebook builds (distinct scratch slots) with histograms
    f_big = first[0][1].astype(np.uint64)
    f_small = first[1][1].astype(np.uint64)
    l1 = native.huf_lens_unsorted(f_big)
    native.hist_u32(small)
    l2 = native.huf_lens_unsorted(f_big)
    assert np.array_equal(l1, l2)
    assert np.array_equal(native.huf_lens_unsorted(f_small),
                          native.huf_lens_unsorted(f_small))


def test_hist_rgb_hash_bail_falls_to_msd_radix(rng):
    """A stream whose stride sample under-estimates the unique count must
    bail out of the hash tier mid-pass and produce identical output from
    the MSD rgb24 radix engine: low-unique colors planted at the sample's
    even-spread positions, near-all-distinct colors everywhere else."""
    n = 400_000
    px = np.empty((n, 3), np.uint8)
    ids = np.arange(n, dtype=np.uint32) * 7  # many distinct 24-bit keys
    px[:, 0] = (ids >> 16) & 0xFF
    px[:, 1] = (ids >> 8) & 0xFF
    px[:, 2] = ids & 0xFF
    stride_pos = (np.arange(32768, dtype=np.int64) * n) // 32768
    px[stride_pos] = [9, 9, 9]  # the sample sees ~1 unique -> tier 17
    uniq, counts, inverse = native.hist_rgb(px)
    keys = ((px[:, 0].astype(np.uint32) << 16)
            | (px[:, 1].astype(np.uint32) << 8) | px[:, 2])
    su = np.sort(np.unique(keys))
    assert uniq.size > 49152  # really did exceed the tier's unique cap
    assert np.array_equal(uniq, su)
    assert np.array_equal(su[inverse], keys)
    want_counts = np.zeros(su.size, np.int64)
    np.add.at(want_counts, inverse, 1)
    assert np.array_equal(counts, want_counts)
