"""Regenerate the PNG decoder fixtures in tests/fixtures/png/.

Writes small PNGs of every 8-bit color type (saved by Pillow) and RGB and
grayscale+alpha files whose scanlines use each of the five filter types
(filtered here by an explicit forward filter), plus `expected.npz`: each
file's pixels as Pillow decodes them, converted to RGB. Needs Pillow, which
the package itself does not use; the tests read only the committed files.

    python scripts/make_png_fixtures.py
"""

import io
import os
import struct
import zlib

import numpy as np
from PIL import Image

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "tests", "fixtures", "png")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _filter_rows(px, ctype, filters):
    """Forward-filter uint8[h, w, ch] with filters[y] for row y."""
    h, w, ch = px.shape
    raw = px.reshape(h, w * ch).astype(np.int64)
    out = bytearray()
    for y in range(h):
        ft = filters[y % len(filters)]
        out.append(ft)
        for x in range(w * ch):
            a = raw[y, x - ch] if x >= ch else 0
            b = raw[y - 1, x] if y else 0
            c = raw[y - 1, x - ch] if (y and x >= ch) else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[ft]
            out.append((raw[y, x] - pred) & 0xFF)
    return bytes(out)


def _png(px, ctype, filters):
    h, w, _ = px.shape

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body +
                struct.pack(">I", zlib.crc32(body, zlib.crc32(kind))))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(_filter_rows(px, ctype, filters)))
            + chunk(b"IEND", b""))


def main():
    os.makedirs(OUT, exist_ok=True)
    rng = np.random.default_rng(2026)
    base = rng.integers(0, 256, (7, 13, 4)).astype(np.uint8)
    base[:, :5] = base[:1, :5]  # flat columns: runs for the filters
    files = {}
    for name, mode in (("gray", "L"), ("gray_alpha", "LA"), ("rgb", "RGB"),
                       ("rgba", "RGBA"), ("palette", "P")):
        buf = io.BytesIO()
        Image.fromarray(base, "RGBA").convert(mode).save(buf, "PNG")
        files[f"type_{name}.png"] = buf.getvalue()
    for ft, name in enumerate(("none", "sub", "up", "average", "paeth")):
        files[f"filter_{name}.png"] = _png(base[:, :, :3], 2, [ft])
    files["filter_mixed_gray_alpha.png"] = _png(base[:, :, :2], 4,
                                                [4, 3, 2, 1, 0])
    expected = {}
    for fname, data in files.items():
        with open(os.path.join(OUT, fname), "wb") as fh:
            fh.write(data)
        expected[fname] = np.asarray(
            Image.open(io.BytesIO(data)).convert("RGB"))
    np.savez_compressed(os.path.join(OUT, "expected.npz"), **expected)
    print(f"wrote {len(files)} fixtures to {OUT}")


if __name__ == "__main__":
    main()
