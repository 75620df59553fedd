#!/usr/bin/env python
"""Long-running encode-side differential campaign over all nine families.

The decode-path analog is fuzz_campaign.py (mutated streams); this driver
attacks the ENCODE side with randomized inputs: random shapes (including
1-pixel-thin strips), random content classes, and mixed-shape batches,
asserting the contracts the unit suite pins at fixed seeds:

1. ``encode`` either succeeds or rejects with the ValueError family (the
   k-means active-cluster floor, size caps); anything else is a finding.
2. ``encode_batch`` lanes are BIT-IDENTICAL to per-image ``encode`` —
   lane grouping/padding/burst composition must never leak into streams —
   and a lane fails iff the per-image call fails (Exception lanes line up,
   reference blast-radius contract: bench.rs:78).
3. Lossless codecs round-trip bit-exact; lossy decodes return the right
   shape/dtype, and a voronoi(k) stream is exactly 16+19k bytes by
   construction (clusterc.rs:143-297).
4. ``decode_batch`` lanes equal per-image ``decode``, and
   ``decode_mse_batch`` (when present) agrees with decode + compute_error.
5. Re-encoding the same batch is deterministic (byte-identical).

Any violation dumps a reproduction JSON (seed, shapes, spec) next to this
script and the campaign exits nonzero at the end.

Usage: python scripts/experiments/roundtrip_campaign.py [seconds] [seed0]
"""

from __future__ import annotations

import json
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")  # host-only campaign

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
from cniic_tpu.codecs import from_spec  # noqa: E402
from cniic_tpu.runner import compute_error  # noqa: E402

SPECS = ["hufman", "delta", "hilbert(rle)", "hilbert(rle(3))",
         "hilbert(zip)", "zip(dict)", "zip(back)",
         "cluster-colors(4)", "cluster-colors(16)",
         "voronoi(4)", "voronoi(32)"]
# the legitimate per-lane rejection family: infeasibility ValueErrors plus
# the k-means active-cluster floor, which raises AssertionError in raise
# mode and stores it in collect-mode lanes (kmeans.py _check_active)
ALLOWED = (ValueError, AssertionError)


def _rand_shape(rng) -> tuple[int, int]:
    cls = rng.integers(0, 4)
    if cls == 0:  # thin strips (curve/framing edge cases)
        a = int(rng.integers(1, 4))
        b = int(rng.integers(1, 200))
        return (a, b) if rng.integers(0, 2) else (b, a)
    if cls == 1:  # tiny
        return int(rng.integers(1, 12)), int(rng.integers(1, 12))
    if cls == 2:  # small odd
        return int(rng.integers(5, 64)), int(rng.integers(5, 64))
    return int(rng.integers(32, 180)), int(rng.integers(32, 180))


def _rand_image(rng) -> np.ndarray:
    h, w = _rand_shape(rng)
    cls = rng.integers(0, 7)
    if cls == 0:  # solid
        return np.full((h, w, 3), rng.integers(0, 256, 3), np.uint8)
    if cls == 1:  # pure noise
        return rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    if cls == 2:  # limited palette (2..300 colors)
        p = int(rng.integers(2, 300))
        pal = rng.integers(0, 256, (p, 3)).astype(np.uint8)
        return pal[rng.integers(0, p, (h, w))]
    if cls == 3:  # horizontal gradient + channel offsets
        g = np.linspace(0, 255, w, dtype=np.float32)
        img = np.stack([(g + o) % 256 for o in rng.integers(0, 256, 3)],
                       axis=-1)
        return np.broadcast_to(img.astype(np.uint8), (h, w, 3)).copy()
    if cls == 4:  # vertical stripes of random period
        period = int(rng.integers(1, max(2, w // 2 + 1)))
        pal = rng.integers(0, 256, (period, 3)).astype(np.uint8)
        return pal[(np.arange(w) % period)][None].repeat(h, axis=0)
    if cls == 5:  # blocks (RLE/LZ-friendly)
        bh, bw = int(rng.integers(1, 9)), int(rng.integers(1, 9))
        gh, gw = -(-h // bh), -(-w // bw)
        pal = rng.integers(0, 256, (gh, gw, 3)).astype(np.uint8)
        return pal.repeat(bh, axis=0).repeat(bw, axis=1)[:h, :w]
    # smooth noise: low-res noise upsampled (delta-friendly)
    sh, sw = max(1, h // 8), max(1, w // 8)
    base = rng.integers(0, 256, (sh, sw, 3)).astype(np.uint8)
    return base.repeat(-(-h // sh), axis=0).repeat(-(-w // sw), axis=1)[:h, :w]


def _fail(tag, spec, seed, imgs, detail):
    repro = {"tag": tag, "spec": spec, "seed": int(seed),
             "shapes": [list(im.shape) for im in imgs], "detail": detail}
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f"roundtrip_finding_{tag}_{seed}.json")
    with open(path, "w") as fh:
        json.dump(repro, fh, indent=1)
    print(f"FINDING [{tag}] {spec} seed={seed}: {detail} -> {path}",
          flush=True)


def main() -> int:
    budget = float(sys.argv[1]) if len(sys.argv) > 1 else 600.0
    seed0 = int(sys.argv[2]) if len(sys.argv) > 2 else 0
    codecs = [(s, from_spec(s)) for s in SPECS]
    t_end = time.time() + budget
    trials = {s: 0 for s in SPECS}
    rejects = {s: 0 for s in SPECS}
    findings = 0
    seed = seed0
    while time.time() < t_end:
        seed += 1
        rng = np.random.default_rng(seed)
        imgs = [_rand_image(rng) for _ in range(int(rng.integers(1, 6)))]
        for spec, codec in codecs:
            trials[spec] += 1
            # per-image encodes (the contract's reference side)
            singles = []
            for im in imgs:
                try:
                    singles.append(codec.encode(im))
                except ALLOWED:
                    singles.append(None)
                    rejects[spec] += 1
                except Exception as e:  # noqa: BLE001
                    findings += 1
                    _fail("encode_raise", spec, seed, imgs, repr(e))
                    singles.append(None)
            # batch must match lane-for-lane
            try:
                blobs = codec.encode_batch(imgs)
            except ALLOWED:
                blobs = None
                if any(s is not None for s in singles):
                    findings += 1
                    _fail("batch_reject_single_ok", spec, seed, imgs,
                          "encode_batch rejected a batch with encodable lanes")
            except Exception as e:  # noqa: BLE001
                blobs = None
                findings += 1
                _fail("batch_raise", spec, seed, imgs, repr(e))
            if blobs is not None:
                for i, (s, b) in enumerate(zip(singles, blobs)):
                    if isinstance(b, Exception):
                        if not isinstance(b, ALLOWED):
                            findings += 1
                            _fail("lane_exc_type", spec, seed, imgs,
                                  f"lane {i}: {b!r}")
                        elif s is not None:
                            findings += 1
                            _fail("lane_exc_single_ok", spec, seed, imgs,
                                  f"lane {i} failed but encode() succeeded")
                    elif s is None:
                        findings += 1
                        _fail("lane_ok_single_rej", spec, seed, imgs,
                              f"lane {i} succeeded but encode() rejected")
                    elif s != b:
                        findings += 1
                        _fail("lane_bytes", spec, seed, imgs,
                              f"lane {i}: batch != single "
                              f"({len(b)} vs {len(s)} B)")
            # round-trip every successful stream
            for i, (im, s) in enumerate(zip(imgs, singles)):
                if s is None:
                    continue
                if spec.startswith("voronoi("):
                    k = int(spec[8:-1])
                    if len(s) != 16 + 19 * k:
                        findings += 1
                        _fail("voronoi_size", spec, seed, imgs,
                              f"lane {i}: {len(s)} != {16 + 19 * k} B")
                try:
                    dec = codec.decode(s)
                except Exception as e:  # noqa: BLE001
                    findings += 1
                    _fail("decode_raise", spec, seed, imgs,
                          f"lane {i}: {e!r}")
                    continue
                if dec.shape != im.shape or dec.dtype != np.uint8:
                    findings += 1
                    _fail("decode_shape", spec, seed, imgs,
                          f"lane {i}: {dec.shape} {dec.dtype}")
                elif codec.is_lossless and not np.array_equal(dec, im):
                    findings += 1
                    _fail("roundtrip", spec, seed, imgs,
                          f"lane {i}: lossless mismatch")
                elif not np.isfinite(compute_error(im, dec)):
                    findings += 1
                    _fail("mse_nan", spec, seed, imgs, f"lane {i}")
            # fused decode+MSE agreement + encode determinism (sampled)
            if blobs is not None and seed % 7 == 0:
                ok = [i for i, b in enumerate(blobs)
                      if not isinstance(b, Exception)]
                # decode_batch lanes must equal per-image decode (the
                # runner's non-fused batch path rides this)
                if ok:
                    decs = codec.decode_batch([blobs[i] for i in ok])
                    for j, i in enumerate(ok):
                        if not np.array_equal(decs[j], codec.decode(blobs[i])):
                            findings += 1
                            _fail("decode_batch_lane", spec, seed, imgs,
                                  f"lane {i}: batch decode != single decode")
                fused = getattr(codec, "decode_mse_batch", None)
                if fused is not None and ok:
                    errs, _ = fused([blobs[i] for i in ok],
                                    [imgs[i] for i in ok])
                    for j, i in enumerate(ok):
                        ref = compute_error(imgs[i], codec.decode(blobs[i]))
                        if abs(float(errs[j]) - ref) > 1e-6 * max(ref, 1.0):
                            findings += 1
                            _fail("fused_mse", spec, seed, imgs,
                                  f"lane {i}: {float(errs[j])} vs {ref}")
                blobs2 = codec.encode_batch(imgs)
                for i in ok:
                    if isinstance(blobs2[i], Exception) or \
                            blobs2[i] != blobs[i]:
                        findings += 1
                        _fail("nondeterminism", spec, seed, imgs,
                              f"lane {i}: re-encode differs")
        if seed % 25 == 0:
            done = sum(trials.values())
            print(f"seed {seed}: {done} trials, "
                  f"{sum(rejects.values())} rejects, {findings} finding(s)",
                  flush=True)
    print("campaign done:", json.dumps({"trials": trials, "rejects": rejects,
                                        "findings": findings}), flush=True)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
