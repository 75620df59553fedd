"""Vectorized Huffman bit packing (the env-gated device formulation).

The reference packs codes bit-by-bit through a stateful writer
(bit.rs:209-253). The device formulation: gather (code, len) per symbol, take an
exclusive prefix sum of the lengths to get each symbol's bit offset, and
scatter each code's bits into 32-bit output words. Because all symbols write
disjoint bit ranges, OR-combining equals ADD-combining, so the scatter is
three sorted segment-sums (a symbol of <= 63 bits spans at most three words).

Bit order matches the reference exactly: MSB-first within bytes, zero-padded
tail (bit.rs:243-253).

Status: the production pack path is the native C packer. This path stays
correct, parity-tested and selectable via CNIIC_DEVICE_BITPACK=1; its time
on the GPU against the C packer is not measured yet (ROADMAP.md).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def pack_bits_numpy(codes: np.ndarray, lens: np.ndarray) -> bytes:
    """Reference (host) implementation: codes u64, lens per symbol."""
    lens = lens.astype(np.int64)
    total = int(lens.sum())
    if total == 0:
        return b""
    sym_of_bit = np.repeat(np.arange(lens.size, dtype=np.int64), lens)
    offs = np.concatenate([[0], np.cumsum(lens)])
    pos_in_code = np.arange(total, dtype=np.int64) - offs[sym_of_bit]
    shift = (lens[sym_of_bit] - 1 - pos_in_code).astype(np.uint64)
    bits = ((codes[sym_of_bit] >> shift) & np.uint64(1)).astype(np.uint8)
    return np.packbits(bits).tobytes()


def _pack_core(sym_ids, hi, lo, lens, n_words: int):
    """Core jitted packer.

    sym_ids: int32[n] or uint16[n] — the caller uploads uint16 when the
    alphabet fits, halving the dominant host->device transfer (padded
    entries must map to a zero-length code)
    hi/lo:   uint32[u+pad] split 64-bit canonical codes
    lens:    int32[u+pad]
    Returns (words uint32[n_words], total_bits int32).
    """
    sym_ids = sym_ids.astype(jnp.int32)
    g_len = lens[sym_ids]
    g_hi = hi[sym_ids]
    g_lo = lo[sym_ids]

    ends = jnp.cumsum(g_len, dtype=jnp.int32)
    offs = ends - g_len
    total_bits = ends[-1] if ends.size else jnp.int32(0)

    base = offs >> 5
    s0 = offs & 31
    k = jnp.where(g_len > 0, 96 - s0 - g_len, 0).astype(jnp.uint32)
    q = (k >> 5).astype(jnp.int32)
    r = k & 31

    # (hi, lo) << r within 96 bits -> big-endian words (A, B, D)
    rr = (32 - r) & 31
    lo_hi_part = jnp.where(r == 0, jnp.uint32(0), g_lo >> rr)
    A = jnp.where(r == 0, jnp.uint32(0), g_hi >> rr)
    B = (g_hi << r) | lo_hi_part
    D = g_lo << r
    # shift left by q whole words
    w0 = jnp.where(q == 0, A, jnp.where(q == 1, B, D))
    w1 = jnp.where(q == 0, B, jnp.where(q == 1, D, jnp.uint32(0)))
    w2 = jnp.where(q == 0, D, jnp.uint32(0))

    valid = g_len > 0
    w0 = jnp.where(valid, w0, 0).astype(jnp.int32)
    w1 = jnp.where(valid, w1, 0).astype(jnp.int32)
    w2 = jnp.where(valid, w2, 0).astype(jnp.int32)
    base = jnp.where(valid, base, n_words)  # park padding out of range

    words = jnp.zeros((n_words,), jnp.int32)
    # disjoint bits: add == or; indices are sorted (offsets are monotone)
    words = words + jax.ops.segment_sum(w0, base, num_segments=n_words, indices_are_sorted=True)
    words = words + jax.ops.segment_sum(w1, base + 1, num_segments=n_words, indices_are_sorted=True)
    words = words + jax.ops.segment_sum(w2, base + 2, num_segments=n_words, indices_are_sorted=True)
    return words.view(jnp.uint32), total_bits


def _words_to_bytes(words: np.ndarray, total_bits: int) -> bytes:
    nbytes = (int(total_bits) + 7) // 8
    return words.astype(">u4").tobytes()[:nbytes]


def pack_bits_device(sym_ids: np.ndarray, codes: np.ndarray, lens: np.ndarray,
                     total_bits: int | None = None) -> bytes:
    """Pack symbol stream on the accelerator; returns the padded byte string.

    sym_ids indexes into the codebook (codes u64[u], lens u32[u]).
    total_bits: optional host-computed payload size (sum freq*len) — allows
    fetching only the occupied words in one bucketed slice instead of the
    whole padded buffer.
    """
    n = sym_ids.size
    if n == 0:
        return b""
    u = codes.size
    hi = (codes >> np.uint64(32)).astype(np.uint32)
    lo = codes.astype(np.uint32)
    # one extra zero-length entry as the padding target
    hi = np.append(hi, np.uint32(0))
    lo = np.append(lo, np.uint32(0))
    l32 = np.append(lens.astype(np.int32), np.int32(0))

    n_pad = _bucket(n)
    ids = np.full(n_pad, u, dtype=np.int32)
    ids[:n] = sym_ids
    # worst case 63 bits/symbol -> 2 words/symbol; keeps n_words a pure
    # function of the bucket so compilations are bounded by bucket count
    n_words = 2 * n_pad + 2
    words, bits_dev = _pack_device(jnp.asarray(ids), jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(l32), n_words)
    if total_bits is None:
        total_bits = int(bits_dev)
    wmax = min(_bucket(max((total_bits + 31) // 32, 1)), n_words)
    return _words_to_bytes(np.asarray(words[:wmax]), total_bits)


_pack_device = functools.partial(jax.jit, static_argnames=("n_words",))(_pack_core)

_pack_ids_batch = functools.partial(jax.jit, static_argnames=("n_words",))(
    jax.vmap(_pack_core, in_axes=(0, 0, 0, 0, None)))


def pack_bits_batch(ids: np.ndarray, codes: np.ndarray, lens: np.ndarray,
                    total_bits=None):
    """Pack B id streams against per-image codebooks in one device call.

    ids int32 or uint16 [B, n_pad] (padding entries must index a
    zero-length code),
    codes uint64[B, u_pad], lens uint32[B, u_pad].
    total_bits: optional per-stream payload bit counts the caller computed
    on host (sum freq*len); skips a device-to-host round trip.
    Returns the list of padded byte strings.
    """
    # the kernel's bit offsets are an int32 cumsum: streams at/over 2^31
    # payload bits would wrap and silently drop writes (review r4). The
    # worst case (max len x symbols) is conservative but cheap; callers
    # with exact totals stay far below it at the 2^27-pixel cap.
    worst = int(lens.max(initial=0)) * ids.shape[1]
    if worst >= 1 << 31 and (total_bits is None
                             or max(total_bits) * 2 >= 1 << 31):
        raise ValueError(
            f"device bitpack cannot address >= 2^31 payload bits "
            f"(worst case {worst}); use the host packer")
    hi = (codes >> np.uint64(32)).astype(np.uint32)
    lo = codes.astype(np.uint32)
    n_words = 2 * ids.shape[1] + 2
    words, bits = _pack_ids_batch(
        jnp.asarray(ids), jnp.asarray(hi), jnp.asarray(lo),
        jnp.asarray(lens.astype(np.int32)), n_words)
    if total_bits is None:
        total_bits = np.asarray(bits)
    # ONE rectangular fetch up to the longest stream instead of one
    # device-to-host round trip per image.
    # The slice width is bucketed so new batch shapes don't force a fresh
    # remote compile of the slice program.
    wmax = max((int(b) + 31) // 32 for b in total_bits) if len(total_bits) else 0
    wmax = min(_bucket(max(wmax, 1)), n_words)
    allw = np.asarray(words[:, :wmax])
    return [_words_to_bytes(allw[i], int(b)) for i, b in enumerate(total_bits)]


def _bucket(n: int) -> int:
    """Round sizes up to limit jit recompilations across image shapes."""
    if n <= 4096:
        return 4096
    b = 1 << (n - 1).bit_length()
    # quarter-power-of-two buckets: at most ~25% padding waste
    for frac in (b // 2 + b // 8, b // 2 + b // 4, b // 2 + 3 * b // 8, b):
        if n <= frac:
            return frac
    return b
