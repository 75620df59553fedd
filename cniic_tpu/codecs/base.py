"""Codec interface (reference src/codec.rs:14-19 `trait Codec`).

Images are numpy ``uint8[H, W, 3]`` arrays; alpha is dropped at load time
(the reference calls ``.to_rgb()`` everywhere). ``encode`` returns the
compressed byte string; ``decode`` accepts anything ByteReader accepts and
returns the reconstructed image or raises :class:`cniic_tpu.wire.WireError`.
"""

from __future__ import annotations

import abc

import numpy as np


class Codec(abc.ABC):
    @abc.abstractmethod
    def encode(self, img: np.ndarray) -> bytes: ...

    @abc.abstractmethod
    def decode(self, data) -> np.ndarray: ...

    @property
    @abc.abstractmethod
    def name(self) -> str: ...

    @property
    @abc.abstractmethod
    def is_lossless(self) -> bool: ...

    def encode_batch(self, imgs) -> list[bytes]:
        """Encode a batch of images.

        Default: sequential loop. Codecs with batch-parallel device paths
        (the k-means families) override this to amortize dispatch and fill
        the device. A batched codec may return an
        Exception instance in place of a stream for an image that failed
        (e.g. the k-means active-cluster floor) so the rest of the batch
        survives; the runner records it as that image's failure.
        """
        return [self.encode(img) for img in imgs]

    def decode_batch(self, blobs) -> list[np.ndarray]:
        """Decode a batch of streams (default: sequential loop; device
        decoders override to amortize dispatch round trips)."""
        return [self.decode(b) for b in blobs]

    @property
    def pipeline_profitable(self) -> bool:
        """Whether the runner's software pipeline (encode group N+1 in a
        worker thread while group N verifies) helps this codec. True only
        for codecs with long device stages whose waits the host thread can
        hide in; pure-host codecs lost to the thread handoff on a one-core
        host. Not re-measured on the GPU host. CNIIC_PIPELINE=1/0
        overrides."""
        return False

    def __repr__(self) -> str:  # pragma: no cover
        return f"<codec {self.name}>"


def pixels_row_major(img: np.ndarray) -> np.ndarray:
    """(H*W, 3) view in the reference's pixels() order (row-major, x fastest)."""
    h, w = img.shape[:2]
    return np.ascontiguousarray(img.reshape(h * w, 3))
