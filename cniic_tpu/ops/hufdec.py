"""On-chip Huffman decode: self-synchronizing chunked bit-walk (SURVEY §7.3
item 2; the two-pass scheme of the GPU-Huffman literature in PAPERS.md).

The payload is cut at byte boundaries into fixed chunks. A Huffman stream
has no per-chunk alignment, but the decoder state entering a chunk is fully
described by one small integer: the bit offset within the chunk where the
first fresh codeword starts (< the maximum code length). So:

* **pass 1 (speculative):** every (chunk, entry offset < E) pair is a lane;
  each lane bit-walks its chunk from its offset and reports the exit offset
  into the next chunk plus the number of symbols decoded. All lanes step in
  lockstep (one payload-byte gather + one flattened trie gather per bit).
* **compose (host, tiny):** exit[i] chains the true entry offset through
  the chunks; symbol counts at the true offsets prefix-sum into per-chunk
  output positions. If any true offset reaches E (a code longer than E
  bits crossed a boundary), the caller falls back to the host decoder.
* **pass 2 (true offsets):** one lane per chunk decodes at its known
  offset, recording a symbol per step into a (steps, chunks) buffer; a
  cumsum-rank scatter compacts them into the id array.

The trie rides a single flattened table: lr2[2*node + bit] is the child
node, or -(leaf_id)-1 when that child is a leaf — one gather per bit
instead of three (left/right/symbol).

EOF semantics match the host walker: a code cut by the end of the payload
decodes nothing and the stream yields however many symbols fit.

Economics: the algorithm is correct and fully parallel, but every bit-step
is two XLA gathers (payload byte, trie edge) — pass 1 alone needs
E x payload_bits of them — so it is gather-bound by nature. Its time on
the GPU against the host prefix-table decoder is not measured yet
(ROADMAP.md). The path stays opt-in (CNIIC_DEVICE_HUF_DECODE=1) and exact
(parity-tested against the walker).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_enable_x64", True)

CHUNK_BYTES = 512
E = 32                      # entry offsets covered; > max code bits in practice
_STEPS = CHUNK_BYTES * 8 + E
# bit positions ride int32 lanes on device: payloads of >= 2^31 bits
# (256 MB — reachable under the 2^27-pixel cap at >16 avg bits/symbol)
# must fall back to the host decoder instead of wrapping chunk offsets
_MAX_PAYLOAD_BYTES = 1 << 28


def _walk_body(payload, lr2, ends, total_bits):
    """One lockstep bit-step shared by both passes."""

    def body(st):
        node, bitpos, cnt = st
        frozen = jnp.logical_or(
            jnp.logical_and(node == 0, bitpos >= ends), bitpos >= total_bits)
        act = jnp.logical_not(frozen)
        idx = jnp.clip(bitpos >> 3, 0, payload.shape[0] - 1)
        byte = payload[idx].astype(jnp.int32)
        bit = (byte >> (7 - (bitpos & 7))) & 1
        v = lr2[2 * node + bit]
        leaf = v < 0
        sym = -v - 1
        node = jnp.where(act, jnp.where(leaf, 0, v), node)
        cnt = cnt + jnp.where(jnp.logical_and(leaf, act), 1, 0)
        bitpos = bitpos + act.astype(jnp.int32)
        return node, bitpos, cnt, jnp.where(jnp.logical_and(leaf, act), sym, -1)

    return body


@functools.partial(jax.jit, static_argnames=("n_steps",))
def _pass1(payload, lr2, starts, ends, total_bits, n_steps: int):
    step = _walk_body(payload, lr2, ends, total_bits)

    def body(i, st):
        node, bitpos, cnt = st
        node, bitpos, cnt, _ = step((node, bitpos, cnt))
        return node, bitpos, cnt

    node = jnp.zeros_like(starts)
    cnt = jnp.zeros_like(starts)
    node, bitpos, cnt = jax.lax.fori_loop(0, n_steps, body, (node, starts, cnt))
    frozen = jnp.logical_or(
        jnp.logical_and(node == 0, bitpos >= ends), bitpos >= total_bits)
    return bitpos - ends, cnt, jnp.all(frozen)


@functools.partial(jax.jit, static_argnames=("n_steps", "n_pad"))
def _pass2(payload, lr2, starts, ends, total_bits, out_start,
           n_steps: int, n_pad: int):
    step = _walk_body(payload, lr2, ends, total_bits)
    C = starts.shape[0]

    def body(i, st):
        node, bitpos, cnt, rec = st
        node, bitpos, cnt, sym = step((node, bitpos, cnt))
        rec = jax.lax.dynamic_update_slice(rec, sym[None, :], (i, 0))
        return node, bitpos, cnt, rec

    rec0 = jnp.full((n_steps, C), -1, jnp.int32)
    node = jnp.zeros_like(starts)
    cnt = jnp.zeros_like(starts)
    _, _, cnt, rec = jax.lax.fori_loop(
        0, n_steps, body, (node, starts, cnt, rec0))

    valid = rec >= 0
    rank = jnp.cumsum(valid, axis=0, dtype=jnp.int32)            # 1-based
    targets = jnp.where(valid, out_start[None, :] + rank - 1, n_pad)
    out = jnp.zeros((n_pad,), jnp.int32)
    out = out.at[targets.reshape(-1)].set(rec.reshape(-1), mode="drop")
    return out, cnt


def _lr2(left: np.ndarray, right: np.ndarray, symbol: np.ndarray) -> np.ndarray:
    n = left.size
    lr2 = np.zeros(2 * n, np.int32)
    for b, child in ((0, left), (1, right)):
        c = child.astype(np.int64)
        val = np.where(c >= 0, np.where(symbol[np.clip(c, 0, n - 1)] >= 0,
                                        -symbol[np.clip(c, 0, n - 1)] - 1, c), 0)
        lr2[b::2] = val
    return lr2


def decode_payload_device(payload, left, right, symbol,
                          n_symbols: int) -> np.ndarray | None:
    """Decode symbol ids on the accelerator; None = caller should fall back
    (degenerate tree, empty payload, or a code deeper than E crossed a
    chunk boundary)."""
    pay = np.frombuffer(bytes(payload), dtype=np.uint8)
    if (pay.size < CHUNK_BYTES or pay.size >= _MAX_PAYLOAD_BYTES
            or symbol[0] >= 0 or n_symbols == 0):
        return None
    total_bits = pay.size * 8
    C = -(-pay.size // CHUNK_BYTES)
    lr2 = jnp.asarray(_lr2(left, right, symbol))
    pay_dev = jnp.asarray(pay)

    chunk_ends = np.minimum(
        (np.arange(C, dtype=np.int64) + 1) * CHUNK_BYTES * 8, total_bits)
    chunk_starts = np.arange(C, dtype=np.int64) * CHUNK_BYTES * 8

    # pass 1: (C, E) speculative lanes, flattened
    starts1 = (chunk_starts[:, None] + np.arange(E)[None, :]).astype(np.int32)
    ends1 = np.broadcast_to(chunk_ends[:, None], (C, E)).astype(np.int32)
    exits, cnts, ok = _pass1(
        pay_dev, lr2, jnp.asarray(starts1.reshape(-1)),
        jnp.asarray(ends1.reshape(-1)), jnp.int32(total_bits), _STEPS)
    if not bool(ok):
        return None
    exits = np.asarray(exits).reshape(C, E)
    cnts = np.asarray(cnts).reshape(C, E)

    # compose the true entry offsets + output positions (host, O(C))
    e = 0
    offs = np.empty(C, np.int64)
    counts = np.empty(C, np.int64)
    for i in range(C):
        offs[i] = e
        counts[i] = cnts[i, e]
        e = int(exits[i, e])
        if e >= E or e < 0:
            if i + 1 < C:
                return None  # a code deeper than E crossed this boundary
            e = 0
    out_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    if int(counts.sum()) < n_symbols:
        # stream too short for the requested symbol count: the host path
        # raises a clean error; let it
        return None

    starts2 = (chunk_starts + offs).astype(np.int32)
    n_pad = int(n_symbols)
    out, _ = _pass2(
        pay_dev, lr2, jnp.asarray(starts2),
        jnp.asarray(chunk_ends.astype(np.int32)), jnp.int32(total_bits),
        jnp.asarray(out_start.astype(np.int32)), _STEPS, n_pad)
    return np.asarray(out)
