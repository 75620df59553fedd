"""The `delta` codec (reference src/codec/hilbertc.rs:397-582).

Hilbert-order traversal, per-channel differences of consecutive pixels with
an implicit [0,0,0] predecessor, Huffman coding of the difference triplets.
Leaf wire format: 3 x i16 LE = 6 bytes, no length prefix (ser.rs:188-195).

Implementation: traversal gather + diff run in one native pass; the diff
alphabet fits in 27-bit packed keys for the unique pass; encode bit packing
is the native C packer (or the XLA device packer behind
CNIIC_DEVICE_BITPACK=1); decode is Huffman walk + prefix-sum + inverse
gather.
"""

from __future__ import annotations

import numpy as np

from .. import hilbert, huffman, native, wire
from ..ops import histogram
from .base import Codec


LEAF_SIZE = 6  # 3 x i16 LE


def _keys_to_leafs(uniq_keys: np.ndarray) -> np.ndarray:
    """Packed 9-bit-per-channel diff keys -> 6-byte i16x3 leaf payloads.

    Load-bearing wire-format arithmetic (the inverse of delta_keys'
    (d+255) packing) shared by both encode paths so they cannot drift."""
    uniq_diffs = np.empty((uniq_keys.size, 3), dtype=np.int16)
    uniq_diffs[:, 0] = ((uniq_keys >> 18) & 0x1FF).astype(np.int16) - 255
    uniq_diffs[:, 1] = ((uniq_keys >> 9) & 0x1FF).astype(np.int16) - 255
    uniq_diffs[:, 2] = (uniq_keys & 0x1FF).astype(np.int16) - 255
    return wire.i16_triplets_to_wire(uniq_diffs).reshape(-1, LEAF_SIZE)


def _scan_stats(img: np.ndarray):
    """(uniq keys, counts, inverse) of the Hilbert-scan diff keys; fused C
    gather+diff+pack+histogram when the image is plain uint8 RGB (one pass
    over the image — neither the 3n-byte scan nor the 4n-byte key array is
    materialized in the hash regime)."""
    h, w = img.shape[:2]
    flat = img.reshape(h * w, -1)
    if flat.dtype == np.uint8 and flat.shape[1] == 3 and flat.flags.c_contiguous:
        return native.delta_hist_gather(flat, hilbert.scan_indices(w, h))
    return histogram.key_histogram(native.delta_keys(hilbert.linearize(img)))


class Delta(Codec):
    def encode(self, img: np.ndarray) -> bytes:
        h, w = img.shape[:2]
        uniq, counts, inverse = _scan_stats(img)
        leaf_payloads = _keys_to_leafs(uniq)

        stream = huffman.encode_stream(inverse, counts, leaf_payloads)
        return wire.pack_dims(w, h) + stream

    def decode(self, data) -> np.ndarray:
        r = wire.ByteReader(data)
        w, h = r.dims()
        n = w * h
        payloads, ids = huffman.decode_stream(r.rest(), LEAF_SIZE, n)
        # fused C pass (VERDICT r3 #3a): leaf gather + 3-channel running
        # sum + u8 range check + inverse-curve scatter in one sweep —
        # replaces the numpy gather/per-channel-cumsum/min-max/scatter
        # chain that floored decode at 28.6 MP/s
        try:
            img = native.delta_unpack(np.asarray(payloads), ids,
                                      hilbert.scan_indices(w, h))
        except ValueError as e:
            raise wire.WireError(str(e))
        return img.reshape(h, w, 3)

    def encode_batch(self, imgs) -> list[bytes]:
        """Batched device pipeline: fused C stats on host, pack batched on
        device (huffman.batch_encode_streams). Host-packer runs take the
        per-image lifecycle instead — the stage-major layout holds every
        image's stats live at once and re-reads them cold (measured r5,
        see Hufman.encode_batch)."""
        import os

        if len(imgs) < 2 or os.environ.get("CNIIC_DEVICE_BITPACK", "") != "1":
            return [self.encode(img) for img in imgs]

        stats = [_scan_stats(img) for img in imgs]
        streams = huffman.batch_encode_streams(
            [inv for (_, _, inv) in stats],
            [counts for (_, counts, _) in stats],
            [_keys_to_leafs(uniq) for (uniq, _, _) in stats])
        return [
            wire.pack_dims(img.shape[1], img.shape[0]) + s
            for img, s in zip(imgs, streams)
        ]

    @property
    def name(self) -> str:
        return "delta"

    @property
    def is_lossless(self) -> bool:
        return True


def parse(spec: str) -> Delta:
    from .. import specs

    specs.expect_name(spec, "delta")
    return Delta()
