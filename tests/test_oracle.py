"""Differential oracle vs the reference implementation (VERDICT r1 #2).

No Rust toolchain exists in this container (no rustc/cargo, no network),
so the reference binary cannot be
built and run directly. What CAN be checked without it:

1. **Huffman stream sizes are provably equal to the reference's.** The
   reference builds its tree by popping a ``BinaryHeap`` seeded from a Rust
   ``HashMap`` iteration (huf.rs:30, utils.rs:4-16) — an order that is
   RANDOMIZED per process, so the reference's own tree shape (and exact
   bitstream) varies run to run. The stable quantities are the sizes:
   every greedy Huffman execution yields the optimal total payload bits
   Σ freq·len, and the serialized tree is always 2u-1 tag bytes + the same
   leaf payloads. We replay the reference's exact build (faithful
   BinaryHeap model, rust_heap_model.py) under many simulated HashMap
   orders and assert our canonical codebook produces byte-identical
   *compressed sizes* every time.

2. **Wire formats** are pinned by the ported reference unit vectors
   (test_wire.py, test_zip.py, test_huffman.py, test_rle.py) — the ~83
   inline #[cfg(test)] cases are the cheapest parity oracle (SURVEY §4).
"""

import numpy as np
import pytest

from cniic_tpu import huffman
from rust_heap_model import RustBinaryHeap, reference_huffman_lengths


def _canonical_total_bits(freqs):
    book = huffman.build_codebook(np.asarray(freqs, np.uint64))
    return int(np.sum(np.asarray(freqs, np.uint64) * book.lens.astype(np.uint64)))


def _reference_total_bits(freqs, rng):
    items = list(enumerate(freqs))
    rng.shuffle(items)  # simulate Rust HashMap iteration order
    lengths = reference_huffman_lengths(items)
    return sum(f * lengths[s] for s, f in enumerate(freqs))


@pytest.mark.parametrize("seed", range(5))
def test_payload_bits_match_reference_build(seed):
    rng = np.random.default_rng(seed)
    for trial in range(20):
        u = int(rng.integers(1, 60))
        freqs = rng.integers(1, 1000, u).tolist()
        ours = _canonical_total_bits(freqs)
        for order in range(4):  # several HashMap orders per freq set
            ref = _reference_total_bits(freqs, rng)
            assert ref == ours, (freqs, ref, ours)


def test_payload_bits_tie_heavy():
    """All-equal and power-of-two-heavy frequency sets maximize heap ties —
    the exact case where tree shapes diverge but total bits must not."""
    rng = np.random.default_rng(99)
    for freqs in ([1] * 17, [5] * 32, [1, 1, 2, 2, 4, 4, 8, 8] * 3,
                  [1, 1, 1, 2, 3, 5, 8, 13, 21, 34, 55, 89]):
        ours = _canonical_total_bits(freqs)
        for _ in range(10):
            assert _reference_total_bits(list(freqs), rng) == ours


def test_single_symbol_zero_length():
    """huf.rs:140-142: a 1-symbol alphabet gets code length 0 both sides."""
    assert reference_huffman_lengths([("x", 7)]) == {"x": 0}
    book = huffman.build_codebook(np.array([7], np.uint64))
    assert book.lens.tolist() == [0]


def test_tree_serialization_size_is_shape_invariant():
    """Any full binary tree over u leaves serializes to exactly
    (2u-1) tag bytes + u leaf payloads (huf.rs:296-321), so tree bytes —
    and with #1 the whole stream size — match the reference exactly."""
    rng = np.random.default_rng(3)
    for u in (1, 2, 7, 100):
        freqs = rng.integers(1, 50, u)
        book = huffman.build_codebook(freqs.astype(np.uint64))
        payloads = rng.integers(0, 256, (u, 11)).astype(np.uint8)
        tree = huffman.serialize_tree(book, payloads)
        assert len(tree) == (2 * u - 1) + u * 11


def test_heap_model_is_a_max_heap():
    """Sanity: the BinaryHeap model pops a valid descending sequence under
    its comparator for random interleaved push/pop workloads."""
    rng = np.random.default_rng(17)
    gt = lambda a, b: a > b
    for _ in range(20):
        heap = RustBinaryHeap(rng.integers(0, 50, 30).tolist(), gt)
        for v in rng.integers(0, 50, 30).tolist():
            heap.push(v)
        out = [heap.pop() for _ in range(len(heap))]
        assert out == sorted(out, reverse=True)
