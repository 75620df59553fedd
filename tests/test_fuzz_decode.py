"""Adversarial-input fuzzing of every decode path (VERDICT r3 #5).

The nine codec families parse untrusted bytes partly in hand-written C
(``cniic_native.c``) — one missed bound there is memory corruption, not an
exception. This harness feeds truncated, bit-flipped, random, and
structure-aware-corrupted streams into every family's decoder. The
contract: decode either succeeds (a mutation can be benign — e.g. a bit
flip inside pixel payload) or raises the ValueError family (WireError is a
subclass) — never a crash, hang, MemoryError-scale allocation, or silent
type confusion.

``make asan-fuzz`` reruns exactly this file against an
address-sanitized build of the C engines.

Reference decode surface: codec.rs:16 (decode returns Option — malformed
input is a recoverable failure, not UB), back.rs:648-706, huf.rs parse.
"""

from __future__ import annotations

import zlib

import numpy as np
import pytest

from cniic_tpu.codecs import from_spec

# one decode machine per entry: (spec, mutation budget scale)
FAMILIES = [
    ("hufman", 1.0),
    ("zip(dict)", 1.0),
    ("zip(back)", 1.0),
    ("hilbert(rle)", 1.0),
    ("hilbert(rle(2))", 1.0),
    ("hilbert(zip)", 1.0),
    ("delta", 1.0),
    ("cluster-colors(4)", 0.4),  # device-side tails: keep the budget lean
    ("voronoi(4)", 0.4),
]

ALLOWED = (ValueError,)  # WireError subclasses ValueError


def _test_image() -> np.ndarray:
    rng = np.random.default_rng(99)
    img = np.zeros((16, 24, 3), np.uint8)
    img[:, :, 0] = np.linspace(0, 255, 24, dtype=np.uint8)[None, :]
    img[4:9, 3:15] = [200, 40, 90]
    img[10:, 16:] = rng.integers(0, 256, (6, 8, 3))
    return img


def _check(codec, blob: bytes) -> str:
    """Decode one mutated stream; return 'ok' or 'raised'."""
    try:
        out = codec.decode(blob)
    except ALLOWED:
        return "raised"
    assert isinstance(out, np.ndarray) and out.dtype == np.uint8 \
        and out.ndim == 3 and out.shape[2] == 3, \
        f"decode returned a malformed image: {type(out)}"
    # a benign mutation must not smuggle out an image past the wire-layer
    # plausibility cap (2^27 pixels, wire.ByteReader.dims)
    assert out.size <= 3 << 27, f"implausible decode size {out.shape}"
    return "ok"


@pytest.mark.parametrize("spec,scale", FAMILIES, ids=[f for f, _ in FAMILIES])
def test_fuzz_decode(spec, scale):
    codec = from_spec(spec)
    stream = codec.encode(_test_image())
    data = np.frombuffer(stream, np.uint8).copy()
    n = data.size
    rng = np.random.default_rng(zlib.crc32(spec.encode()))
    outcomes = {"ok": 0, "raised": 0}

    def run(blob):
        outcomes[_check(codec, bytes(blob))] += 1

    # 1. truncations: every short prefix + a sweep of random cut points
    for cut in range(min(n, 40)):
        run(data[:cut])
    for cut in rng.integers(0, n, int(30 * scale)):
        run(data[:cut])

    # 2. single-bit flips at random positions
    for pos in rng.integers(0, n, int(120 * scale)):
        m = data.copy()
        m[pos] ^= 1 << int(rng.integers(0, 8))
        run(m)

    # 3. byte smashes: random position forced to adversarial values
    for pos in rng.integers(0, n, int(60 * scale)):
        for val in (0x00, 0xFF, 0x80):
            m = data.copy()
            m[pos] = val
            run(m)

    # 4. structure-aware: headers/length prefixes live in the first bytes —
    #    corrupt each of them to the classic traps (zero, max, off-by-one)
    for pos in range(min(n, 24)):
        for val in (0x00, 0xFF, (int(data[pos]) + 1) & 0xFF):
            m = data.copy()
            m[pos] = val
            run(m)

    # 5. random garbage streams (including empty)
    for ln in list(rng.integers(0, 400, int(25 * scale))) + [0, 1, 2, 3]:
        run(rng.integers(0, 256, int(ln)).astype(np.uint8))

    # 6. tail extension: valid stream + trailing junk
    for extra in (1, 7, 256):
        run(np.concatenate([data, rng.integers(0, 256, extra).astype(np.uint8)]))

    # sanity: the harness must have actually exercised both outcomes
    assert outcomes["raised"] > 0, "no mutation was ever rejected"
    assert _check(codec, bytes(data)) == "ok", "unmutated stream must decode"


def test_zip_bomb_streams_rejected_bounded():
    """LZ78/LZ77 expansion bombs must die at the output cap, not after
    multi-GB allocations (r4 fuzz audit). A doubling zip-dict pair chain
    and a doubling zip-back lookback chain are decoded with a small
    explicit cap to prove the bound binds early."""
    from cniic_tpu import native

    # zip-dict bomb: (97,97) makes symbol 0x100 = "aa"; every following
    # pair (s,s) doubles the newest symbol's expansion
    pairs = [(97, 97)] + [(0x100 + i, 0x100 + i) for i in range(30)]
    bomb = b"".join(a.to_bytes(2, "little") + b.to_bytes(2, "little")
                    for a, b in pairs)
    with pytest.raises(ValueError):
        native.zip_dict_decode(bomb, max_out=10_000)

    # zip-back bomb: 6 explicit bytes, then lookbacks that double the
    # output (len = back = current length)
    out = bytearray((6).to_bytes(2, "little") + b"abcdef")
    ln = 6
    for _ in range(20):
        cl = min(ln, 32767)
        out += (0x8000 | cl).to_bytes(2, "little") + cl.to_bytes(2, "little")
        ln += cl
    with pytest.raises(ValueError):
        native.zip_back_decode(bytes(out), max_out=10_000)

    # the codec-level default cap also rejects them (zipc path)
    from cniic_tpu import wire
    from cniic_tpu.codecs import from_spec

    big = b"".join(a.to_bytes(2, "little") + b.to_bytes(2, "little")
                   for a, b in [(97, 97)] + [(0x100 + i, 0x100 + i)
                                             for i in range(48)])
    with pytest.raises((ValueError, wire.WireError)):
        from_spec("zip(dict)").decode(big)


def test_hilbert_rle_huge_dims_rejected_fast():
    """A tiny RLE payload claiming huge-but-plausible dims must be
    rejected BEFORE curve generation (r4 fuzz campaign: the curve for a
    2^27-px claim costs ~1 GB of indices)."""
    import time

    from cniic_tpu import wire
    from cniic_tpu.codecs import from_spec

    blob = wire.pack_dims(16000, 8000) + b"\x05" + wire.pack_rgb(1, 2, 3)
    t0 = time.perf_counter()
    with pytest.raises(wire.WireError):
        from_spec("hilbert(rle)").decode(blob)
    assert time.perf_counter() - t0 < 0.5, "rejection generated the curve"
