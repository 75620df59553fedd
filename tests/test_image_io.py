"""The standard-library PNG reader and writer (cniic_tpu.image_io).

The decoder is cross-checked against committed fixtures: small PNGs of
every 8-bit color type and of each scanline filter type, with the pixels
an independent decoder produced for them (scripts/make_png_fixtures.py).
"""

import os
import struct
import zlib

import numpy as np
import pytest

from cniic_tpu import image_io

_FIX = os.path.join(os.path.dirname(__file__), "fixtures", "png")


def _fixture(name):
    with open(os.path.join(_FIX, name), "rb") as fh:
        data = fh.read()
    with np.load(os.path.join(_FIX, "expected.npz")) as exp:
        return data, exp[name]


@pytest.mark.parametrize("name", ["gray", "gray_alpha", "rgb", "rgba",
                                  "palette"])
def test_decodes_every_color_type(name):
    data, want = _fixture(f"type_{name}.png")
    got = image_io.decode_png(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["none", "sub", "up", "average", "paeth",
                                  "mixed_gray_alpha"])
def test_decodes_every_filter_type(name):
    data, want = _fixture(f"filter_{name}.png")
    np.testing.assert_array_equal(image_io.decode_png(data), want)


@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (64, 3), (300, 451)])
def test_round_trip(shape):
    rng = np.random.default_rng(shape[0])
    img = rng.integers(0, 256, (*shape, 3)).astype(np.uint8)
    np.testing.assert_array_equal(
        image_io.decode_png(image_io.encode_png(img)), img)


def test_encoded_png_is_well_formed():
    """IHDR says 8-bit RGB, non-interlaced; every chunk's CRC checks."""
    img = np.zeros((5, 9, 3), np.uint8)
    data = image_io.encode_png(img)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, kinds = 8, []
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(body, zlib.crc32(kind))
        if kind == b"IHDR":
            assert struct.unpack(">IIBBBBB", body) == (9, 5, 8, 2, 0, 0, 0)
        kinds.append(kind)
        pos += 12 + n
    assert kinds == [b"IHDR", b"IDAT", b"IEND"]


def test_save_and_load_files(tmp_path):
    img = np.arange(4 * 6 * 3, dtype=np.uint8).reshape(4, 6, 3)
    p = tmp_path / "x.png"
    image_io.save_png(img, p)
    np.testing.assert_array_equal(image_io.load_image(p), img)


def _with_ihdr(data, **fields):
    """Rewrite the IHDR of a PNG (with a valid CRC)."""
    names = ("w", "h", "depth", "ctype", "comp", "filt", "interlace")
    vals = dict(zip(names, struct.unpack(">IIBBBBB", data[16:29])))
    vals.update(fields)
    body = struct.pack(">IIBBBBB", *(vals[k] for k in names))
    crc = struct.pack(">I", zlib.crc32(body, zlib.crc32(b"IHDR")))
    return data[:16] + body + crc + data[33:]


@pytest.mark.parametrize("fields,match", [
    ({"depth": 16}, "bit depth 16"),
    ({"interlace": 1}, "interlaced"),
    ({"ctype": 5}, "color type 5"),
])
def test_rejects_unsupported_headers(fields, match):
    data = image_io.encode_png(np.zeros((3, 4, 3), np.uint8))
    with pytest.raises(ValueError, match=match):
        image_io.decode_png(_with_ihdr(data, **fields))


def test_rejects_bad_signature_and_filter_byte():
    with pytest.raises(ValueError, match="signature"):
        image_io.decode_png(b"GIF89a" + bytes(40))
    # a scanline whose filter byte is 5
    data, _ = _fixture("filter_none.png")
    h, w = 7, 13
    raw = bytearray(zlib.decompress(data[41:41 + struct.unpack(
        ">I", data[33:37])[0]]))
    raw[0] = 5
    idat = zlib.compress(bytes(raw))
    chunk = (struct.pack(">I", len(idat)) + b"IDAT" + idat +
             struct.pack(">I", zlib.crc32(idat, zlib.crc32(b"IDAT"))))
    bad = data[:33] + chunk + data[-12:]
    assert raw and h * (3 * w + 1) == len(raw)
    with pytest.raises(ValueError, match="filter type"):
        image_io.decode_png(bad)
