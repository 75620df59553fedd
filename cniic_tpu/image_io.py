"""Image IO: PNG <-> uint8[H, W, 3], with the standard library's zlib.

The reference uses the `image` crate's DynamicImage and drops alpha via
`.to_rgb()` everywhere (e.g. hufc.rs:15); `load_image` converts at the
door the same way. Supported on load: 8-bit grayscale, grayscale+alpha,
RGB, RGBA and palette images, non-interlaced, with any of the five
scanline filter types (unfiltered in the native library). Anything else
raises ValueError naming what it found.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from . import native

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> samples per pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_COLOR_NAMES = {0: "grayscale", 2: "RGB", 3: "palette", 4: "grayscale+alpha",
                6: "RGBA"}


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG stream ends without an IEND chunk")


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8[H, W, 3] (alpha dropped, gray and palette
    expanded to RGB)."""
    if not data.startswith(_SIGNATURE):
        raise ValueError("not a PNG file (bad signature)")
    header = None
    palette = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"unsupported PNG color type {ctype}")
    if depth != 8:
        raise ValueError(f"unsupported PNG bit depth {depth} "
                         f"({_COLOR_NAMES[ctype]}); only 8-bit is read")
    if interlace:
        raise ValueError("interlaced PNGs are not supported")
    ch = _CHANNELS[ctype]
    rows = native.png_unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch)
    px = rows.reshape(h, w, ch)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG has no PLTE chunk")
        if int(px.max(initial=0)) >= palette.shape[0]:
            raise ValueError("PNG palette index out of range")
        return palette[px[:, :, 0]]
    if ctype in (0, 4):
        return np.repeat(px[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(px[:, :, :3])


def encode_png(img: np.ndarray) -> bytes:
    """uint8[H, W, 3] -> PNG bytes (8-bit RGB, every scanline filter 0)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {img.shape}")
    h, w, _ = img.shape
    rows = np.zeros((h, 1 + 3 * w), np.uint8)  # filter byte 0 per line
    rows[:, 1:] = img.reshape(h, 3 * w)

    def chunk(kind: bytes, body: bytes) -> bytes:
        crc = zlib.crc32(body, zlib.crc32(kind)) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + kind + body + \
            struct.pack(">I", crc)

    return (_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def load_image(path) -> np.ndarray:
    with open(path, "rb") as fh:
        return decode_png(fh.read())


def save_png(img: np.ndarray, path) -> None:
    with open(path, "wb") as fh:
        fh.write(encode_png(img))
