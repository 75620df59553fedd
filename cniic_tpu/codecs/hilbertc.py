"""The `Hilbert` codec family (reference src/codec/hilbertc.rs:12-395).

Variants (spec grammar hilbertc.rs:337-395):
    hilbert(rle)      exact RLE along the scan, lossless
    hilbert(rle(d))   approximate RLE: a run accepts a pixel while the
                      Euclidean distance between the run's running average
                      (f64) and the pixel is <= d; the emitted color is the
                      rounded average (hilbertc.rs:200-285)
    hilbert(zip)      zip-dict over the 11-byte-framed scan stream

Record format for both RLE variants: (u8 count, 11-byte Rgb) = 12 bytes
(hilbertc.rs:35-45 + the ser.rs:210-222 quirk); runs cap at count = 255
(hilbertc.rs:127-143).

Implementation: the traversal, exact RLE (including the 255-cap splitting)
and the approximate RLE recurrence (non-associative, exact f64) run in the
native C engine; decode of both is one fused C expand + inverse-curve
scatter.
"""

from __future__ import annotations

import numpy as np

from .. import hilbert, native, wire
from .base import Codec


def _records_to_bytes(counts: np.ndarray, colors: np.ndarray) -> bytes:
    """(R,) u8 counts + (R, 3) u8 colors -> R x 12-byte records.

    One C sweep (native.rle_records_frame): the column-wise numpy assembly
    cost 8.2 ms at DIV2K-scale record counts — a third of the whole
    approx-RLE encode (measured r4)."""
    return native.rle_records_frame(counts, colors)


class Hilbert(Codec):
    def __init__(self, mode: str, allow: float = 0.0) -> None:
        assert mode in ("rle", "zip")
        self.mode = mode
        self.allow = float(allow)

    def encode(self, img: np.ndarray) -> bytes:
        h, w = img.shape[:2]
        header = wire.pack_dims(w, h)
        if self.mode == "rle" and self.allow == 0.0:
            # one fused C pass over the raw image: curve gather + RLE +
            # record framing + header placement (identical bytes to
            # rle_frame(gather_rgb(...)), test-pinned) — skips the 3n-byte
            # scan materialization and the payload concat copy
            if img.dtype == np.uint8 and img.shape[2] == 3:
                return native.rle_frame_gather(
                    img.reshape(h * w, 3), hilbert.scan_indices(w, h),
                    prefix=header)
            return header + native.rle_frame(hilbert.linearize(img))
        scan = hilbert.linearize(img)
        if self.mode == "zip":
            framed = wire.rgb_stream_to_wire(scan)
            return header + native.zip_dict_encode(framed)
        counts, colors = native.approx_rle_encode(scan, self.allow)
        return header + _records_to_bytes(counts, colors)

    def decode(self, data) -> np.ndarray:
        r = wire.ByteReader(data)
        w, h = r.dims()
        n = w * h
        if self.mode == "zip":
            # dims are in the outer header here, so the decoded size is
            # known exactly: 11 wire bytes per pixel (LZ78-bomb guard)
            framed = np.frombuffer(
                native.zip_dict_decode(r.rest(), max_out=11 * n),
                dtype=np.uint8)
            scan = wire.wire_to_rgb_stream(framed, count=n)
        else:
            # fused C pass (VERDICT r3 #3b): record validation + run
            # expansion + inverse-curve scatter in one sweep (replaces
            # np.repeat + separate scatter, the 38 MP/s decode floor)
            buf = np.frombuffer(bytes(r.rest()), dtype=np.uint8)
            # coverage pre-check BEFORE generating the curve: a corrupted
            # header claiming huge-but-plausible dims otherwise forces
            # O(W*H) curve generation (up to ~1 GB of indices at the
            # 2^27-px cap) for a stream whose records can never cover it
            # (r4 fuzz campaign; the analog of decode_stream's
            # 1-bit/symbol floor on the delta path). Each 12-byte record
            # covers at most 255 pixels.
            if buf.size % 12 or (buf.size // 12) * 255 < n:
                raise wire.WireError(
                    f"RLE records cannot cover {w}x{h} pixels")
            try:
                img = native.rle_unframe_scatter(
                    buf, hilbert.scan_indices(w, h))
            except ValueError as e:
                raise wire.WireError(str(e))
            return img.reshape(h, w, 3)
        return hilbert.scatter(scan, w, h)

    @property
    def name(self) -> str:
        if self.mode == "zip":
            return "hilbert-zip"
        if self.allow == 0.0:
            return "hilbert-rle"
        return f"hilbert-rle-approx_{_fmt_allow(self.allow)}"

    @property
    def is_lossless(self) -> bool:
        return self.mode == "zip" or self.allow == 0.0


def _fmt_allow(d: float) -> str:
    """Rust Display for f64 prints integral values without '.0'."""
    return str(int(d)) if float(d).is_integer() else repr(d)


def parse(spec: str):
    """hilbert(rle) | hilbert(rle(<d>)) | hilbert(zip) (hilbertc.rs:337-395)."""
    from .. import specs

    call = specs.fun_call(spec)
    if call is None:
        raise specs.OtherParseError(f"Can't parse {spec!r} as a function")
    name, args = call
    specs.expect_name(name, "[Hh]ilbert")
    if len(args) != 1:
        raise specs.WrongNumberOfArguments(expected=1, found=len(args))
    arg = args[0]

    def parse_rle(s: str):
        if specs.matches_fully(s, "rle") is not None:
            return Hilbert("rle", 0.0)
        inner = specs.fun_call(s)
        if inner is None:
            raise specs.OtherParseError(f"Can't parse {s!r} as a function")
        rle_name, rle_args = inner
        specs.expect_name(rle_name, "rle")
        if len(rle_args) != 1:
            raise specs.WrongNumberOfArguments(expected=1, found=len(rle_args))
        try:
            d = float(rle_args[0])
        except ValueError as e:
            raise specs.OtherParseError(str(e))
        return Hilbert("rle", d)

    def parse_zip(s: str):
        if specs.matches_fully(s, "zip") is not None:
            return Hilbert("zip")
        raise specs.WrongName(expected="zip", found=s)

    return specs.Alternatives(arg).then_try("rle", parse_rle).then_try("zip", parse_zip).end()
