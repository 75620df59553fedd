"""Huffman coding pipeline (reference src/huf.rs rebuilt).

Split of responsibilities (entropy stages are scatter/gather-bound and
live on the host):

* **host (native C)**: LSD-radix histogramming, optimal code lengths via
  the two-queue method over sorted frequencies, canonical code assignment,
  preorder tree emission/parsing, the ~5 ns/symbol bit packer, and the
  16-bit prefix-table decoder (bit-serial walker kept as oracle). Any
  optimal code has the same total payload bits as the reference's
  heap-built code (sum freq*len is invariant across optimal prefix codes),
  so compressed sizes match to within final-byte padding; we pin a
  deterministic canonical tree instead of chasing Rust's BinaryHeap
  tie-breaking (see SURVEY.md §7.3 item 5).
* **device (XLA/Pallas, env-gated patterns)**: the prefix-sum +
  segment-scatter packer (ops/bitpack.py, CNIIC_DEVICE_BITPACK=1) and the
  chunked self-synchronizing decoder (ops/hufdec.py,
  CNIIC_DEVICE_HUF_DECODE=1), both parity-tested; neither is measured
  against the C paths on the GPU yet (ROADMAP.md).

Wire format is byte-identical to the reference: the decoder trie serialized
preorder (tag 0 = leaf + payload, 1 = branch; huf.rs:296-321) followed by the
MSB-first packed payload, zero-padded to a byte (bit.rs:243-253).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import native
from .ops import bitpack


@dataclass
class Codebook:
    """Canonical Huffman codebook over `u` symbols (caller's symbol order)."""

    codes: np.ndarray      # uint64[u], right-aligned code bits
    lens: np.ndarray       # uint32[u]
    tags: np.ndarray       # uint8[2u-1] preorder tags
    leaf_sym: np.ndarray   # int32[u]: symbol index of k-th preorder leaf

    @property
    def n_symbols(self) -> int:
        return self.codes.size


def build_codebook(freqs: np.ndarray) -> Codebook:
    """Build the canonical codebook for symbol frequencies (caller order).

    The sort + two-queue + unscatter run as one C call: the numpy
    stable argsort alone cost 13-16 ms at north-star alphabet sizes
    (~400k symbols), more than the entire C tree build (measured r5;
    bit-identity with the argsort formulation pinned by
    tests/test_oracle.py)."""
    freqs = np.asarray(freqs, dtype=np.uint64)
    lens = native.huf_lens_unsorted(freqs)
    codes, tags, leaf_sym = native.huf_canonical(lens)
    return Codebook(codes=codes, lens=lens, tags=tags, leaf_sym=leaf_sym)


def serialize_tree(book: Codebook, leaf_payloads: np.ndarray) -> bytes:
    """Preorder tree bytes; leaf_payloads is uint8[u, leaf_size].

    One C sweep (native.huf_tree_serialize): the numpy offset-scatter
    formulation this replaces cost 3.5 ms per DIV2K-scale tree — a tenth
    of the whole hufman encode (measured r4; bytes identical)."""
    return native.huf_tree_serialize(book.tags, book.leaf_sym,
                                     leaf_payloads)


def parse_tree(data, leaf_size: int):
    """Parse preorder tree bytes.

    Returns (left, right, symbol, payloads uint8[u, leaf_size], consumed).
    `symbol[i]` numbers leaves in preorder; payloads row k belongs to
    preorder leaf k. The payload bytes are copied out by the C parse
    sweep itself — the numpy offset-gather this replaces cost ~20 ms/MP
    at north-star tree sizes, half of parse_tree (measured r5).
    """
    left, right, symbol, payloads, n_nodes, consumed = native.huf_tree_parse(data, leaf_size)
    return left, right, symbol, payloads, consumed


def encode_payload(symbol_ids: np.ndarray, book: Codebook, device: bool = True,
                   total_bits: int | None = None) -> bytes:
    """Pack the symbol stream with the codebook.

    Default: the native C packer (~5 ns/symbol). The original XLA
    prefix-sum + segment-scatter packer remains behind
    CNIIC_DEVICE_BITPACK=1 (parity-pinned by tests).
    device=False keeps the vectorized-numpy oracle.
    """
    import os

    if symbol_ids.size == 0:
        return b""
    if not device:
        return bitpack.pack_bits_numpy(book.codes[symbol_ids], book.lens[symbol_ids])
    if os.environ.get("CNIIC_DEVICE_BITPACK", "") == "1":
        return bitpack.pack_bits_device(symbol_ids.astype(np.int32),
                                        book.codes, book.lens, total_bits)
    return native.pack_bits(book.codes, book.lens, symbol_ids)


def decode_payload(payload, left, right, symbol, n_symbols: int) -> np.ndarray:
    """Decode the payload into preorder-leaf ids.

    Default: the native 16-bit prefix-table decoder. With
    CNIIC_DEVICE_HUF_DECODE=1 the self-synchronizing chunked on-chip
    decoder (ops/hufdec.py) runs first and the host path is its fallback."""
    import os

    if os.environ.get("CNIIC_DEVICE_HUF_DECODE", "") == "1":
        from .ops import hufdec

        out = hufdec.decode_payload_device(payload, left, right, symbol,
                                           n_symbols)
        if out is not None:
            return out
    root = 0
    out = native.huf_decode(payload, left, right, symbol, root, n_symbols)
    if out.size != n_symbols:
        raise ValueError(f"Huffman payload exhausted: {out.size}/{n_symbols} symbols")
    return out


def encode_stream(symbol_ids: np.ndarray, freqs: np.ndarray,
                  leaf_payloads: np.ndarray, device: bool = True) -> bytes:
    """Full huf::encode_all analog (huf.rs:22-43): tree bytes + packed payload."""
    book = build_codebook(freqs)
    total_bits = int(np.asarray(freqs, np.uint64) @ book.lens)
    return serialize_tree(book, leaf_payloads) + encode_payload(
        symbol_ids, book, device=device, total_bits=total_bits)


def batch_encode_streams(ids_list, freqs_list, leafs_list) -> list[bytes]:
    """Batched encode_all for pre-resolved symbol streams.

    With CNIIC_DEVICE_BITPACK=1: per-stream tree bytes (host, tiny) +
    device-batched bit packing in one transfer. Host default: each stream
    encodes end-to-end (tree + C pack) before the next — stage-major
    re-reads every stream's multi-MB id array cold (measured r5).

    ids_list: per-stream int arrays of symbol ids (< the stream's alphabet).
    freqs_list: per-stream symbol frequencies (the codebook input).
    leafs_list: per-stream uint8[u, leaf_size] wire payloads per symbol.
    """
    import os

    from . import trace

    if not ids_list:
        return []
    B = len(ids_list)
    if os.environ.get("CNIIC_DEVICE_BITPACK", "") != "1":
        # host packer: one stream end-to-end at a time. The stage-major
        # layout below exists for the device path's batched transfer; on
        # the host it re-reads every stream's multi-MB id array long
        # after it went cold (32 corpus images hold ~130 MB live), which
        # measured 12.9 vs 5.0 ms/MP on the pack stage alone (r5).
        out = []
        with trace.span("huffman.encode"):
            for sym, freqs, leafs in zip(ids_list, freqs_list, leafs_list):
                book = build_codebook(freqs)
                out.append(serialize_tree(book, leafs) +
                           native.pack_bits(book.codes, book.lens,
                                            np.asarray(sym, np.int32)))
        return out
    books = []
    trees = []
    with trace.span("huffman.trees"):
        for sym, freqs, leafs in zip(ids_list, freqs_list, leafs_list):
            book = build_codebook(freqs)
            books.append(book)
            trees.append(serialize_tree(book, leafs))

    with trace.span("huffman.pack"):
        from .ops import bitpack
        from .ops.bitpack import _bucket

        n_pad = _bucket(max(i.size for i in ids_list))
        u_pad = max(_bucket(max(f.size for f in freqs_list)), 256) + 1
        # uint16 ids when every alphabet (incl. the per-image padding
        # id u) fits: halves the dominant host->device transfer
        id_dtype = np.uint16 if u_pad <= 0xFFFF else np.int32
        ids = np.zeros((B, n_pad), dtype=id_dtype)
        codes = np.zeros((B, u_pad), dtype=np.uint64)
        lens = np.zeros((B, u_pad), dtype=np.uint32)
        total_bits = []
        for i, (sym, freqs, book) in enumerate(
                zip(ids_list, freqs_list, books)):
            u = freqs.size
            codes[i, :u] = book.codes
            lens[i, :u] = book.lens
            ids[i, : sym.size] = sym
            ids[i, sym.size :] = u  # padding -> zero-length code
            # payload size is known before the device packs a single
            # bit (sum freq*len) — saves the bit-count fetch round trip
            total_bits.append(int(np.asarray(freqs, np.uint64) @ book.lens))
        payloads = bitpack.pack_bits_batch(ids, codes, lens, total_bits)
    return [t + p for t, p in zip(trees, payloads)]


def batch_encode(keys_list, uniq_to_payload) -> list[bytes]:
    """Device-resident batched Huffman encode (tree bytes + packed payload
    per stream).

    keys_list: per-stream uint32 symbol-key arrays (values < 2^31-1).
    uniq_to_payload: fn(uniq_keys uint32[u]) -> uint8[u, leaf_size] wire
    payloads for the tree leaves.

    The symbol statistics (sort + segment reductions) and the per-symbol hot
    loop (searchsorted id resolution + code gather + bit packing) all run on
    the device; only per-image uniques/counts and final payload bytes cross
    the host boundary. Host does the (tiny) tree builds.
    """
    from . import native, trace

    # per-stream stats on host (native LSD radix, ~an order of magnitude
    # faster than any sort this host's numpy can do), packing batched on
    # device; the id array is the only full-resolution transfer
    stats = []
    with trace.span("huffman.stats"):
        for k in keys_list:
            stats.append(native.hist_u32(k))
    return batch_encode_streams(
        [inv for (_, _, inv) in stats],
        [counts for (_, counts, _) in stats],
        [uniq_to_payload(uniq) for (uniq, _, _) in stats])


def decode_stream(data, leaf_size: int, n_symbols: int):
    """Full huf::decode_all analog: returns (payloads uint8[u, leaf_size],
    decoded leaf-ids int32[n_symbols])."""
    left, right, symbol, payloads, consumed = parse_tree(data, leaf_size)
    body = np.frombuffer(bytes(data), dtype=np.uint8)[consumed:]
    # every symbol costs >= 1 payload bit, so a symbol count beyond
    # 8*len(body) can never be satisfied: reject before allocating. The
    # one legal exception is the single-leaf tree (0-bit codes, empty
    # body), which the body.size test exempts; its allocation is bounded
    # by the dims plausibility cap (wire.ByteReader.dims).
    if body.size and n_symbols > 8 * body.size:
        raise ValueError(
            f"Huffman stream too short for {n_symbols} symbols")
    ids = decode_payload(body, left, right, symbol, n_symbols)
    return payloads, ids
