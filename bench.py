#!/usr/bin/env python
"""Headline benchmark: encode throughput across all nine codec families.

Runs each codec over a deterministic synthetic corpus with natural-image-like
statistics (spatially-correlated texture + gradients + flat regions), checks
the round trip, and reports the **geometric mean encode throughput in
megapixels/sec** across the nine configs of the reference Makefile sweep.
Each codec is timed over five passes after a warmup; the headline value is
the geomean of per-codec medians, with a best-trial geomean reported
alongside. The device it ran on is printed on stderr; a codec that fails
makes the run exit non-zero.

Baseline: the Rust reference cannot be built in-container;
``vs_baseline`` is the geometric-mean per-codec speedup over a **measured**
single-core host-CPU run of the same algorithms (BASELINE_HOST.json, written
by scripts/measure_baseline.py on this host — identical streams, same C hot
loops the reference's algorithms use, so it if anything over-states the
Rust's speed). If the file is missing, vs_baseline falls back to the
absolute geomean against a nominal 1.0 MP/s single-core rate.

Prints exactly one JSON line:
    {"metric": "...", "value": N, "unit": "MP/s", "vs_baseline": N, ...}
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

import numpy as np

from cniic_tpu.codecs import from_spec
from cniic_tpu.runner import compute_error


def synth_image(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Natural-ish content: low-frequency fields + flat patches + mild noise."""
    yy = np.linspace(0, 4 * np.pi, h)[:, None]
    xx = np.linspace(0, 4 * np.pi, w)[None, :]
    base = (
        110
        + 70 * np.sin(xx * 0.7 + 1.3) * np.cos(yy * 0.5)
        + 45 * np.sin(0.23 * (xx * 3 + yy * 2))
    )
    img = np.stack([base, base * 0.8 + 30, 255 - base * 0.6], axis=-1)
    # a few flat rectangles (RLE/palette-friendly structure)
    for _ in range(6):
        y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
        hh, ww = rng.integers(h // 8, h // 3), rng.integers(w // 8, w // 3)
        img[y0 : y0 + hh, x0 : x0 + ww] = rng.integers(0, 256, 3)
    img = img + rng.normal(0, 2.0, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


# (spec, image side, images) — uniform 1024^2 x 8 across all nine configs
SUITE = [
    ("hufman", 1024, 8),
    ("delta", 1024, 8),
    ("hilbert(rle)", 1024, 8),
    ("hilbert(rle(4))", 1024, 8),
    ("cluster-colors(32)", 1024, 8),
    ("voronoi(128)", 1024, 8),
    ("hilbert(zip)", 1024, 8),
    ("zip(dict)", 1024, 8),
    ("zip(back)", 1024, 8),
]

TRIALS = 5


def _load_host_baseline() -> dict:
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "BASELINE_HOST.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)["per_codec"]
    return {}


def _geomean(vals) -> float:
    vals = list(vals)
    return math.exp(sum(math.log(v) for v in vals) / len(vals)) if vals else 0.0


def main() -> int:
    import jax

    devs = jax.devices()
    print(f"device: {devs[0].platform} / {devs[0].device_kind} x "
          f"{len(devs)}", file=sys.stderr)
    rng = np.random.default_rng(2024)
    baseline = _load_host_baseline()
    enc_mps, enc_best_mps, dec_mps, speedups = {}, {}, {}, {}
    failures = {}
    details = []
    for spec, side, n_imgs in SUITE:
        codec = from_spec(spec)
        imgs = [synth_image(rng, side, side) for _ in range(n_imgs)]
        mp = sum(im.shape[0] * im.shape[1] for im in imgs) / 1e6
        try:
            # warmup (jit compiles, native lib build) at the exact batch
            # shape so the timed runs hit warm caches
            codec.encode_batch(imgs)

            # fused device decode+MSE (voronoi): the decoded images are
            # produced and verified in device memory; only error scalars
            # reach the host on the timed path
            fused = getattr(codec, "decode_mse_batch", None)
            enc_trials, dec_trials = [], []
            for _ in range(TRIALS):
                t0 = time.perf_counter()
                blobs = codec.encode_batch(imgs)
                enc_trials.append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                if fused is not None:
                    errs, _ = fused(blobs, imgs)
                else:
                    decs = codec.decode_batch(blobs)
                dec_trials.append(time.perf_counter() - t0)
        except Exception as e:
            failures[codec.name] = repr(e)[:200]
            print(f"{codec.name}: failed: {e!r}", file=sys.stderr)
            details.append(f"{codec.name}: FAILED {failures[codec.name]}")
            continue
        enc_s = float(np.median(enc_trials))
        enc_best = float(np.min(enc_trials))
        dec_s = float(np.median(dec_trials))

        # round-trip check on every image of the last pass (the fused
        # path already produced exact per-image MSEs)
        if fused is None:
            errs = [compute_error(im, de) for im, de in zip(imgs, decs)]
        if codec.is_lossless and any(e != 0.0 for e in errs):
            print(f"FATAL: {codec.name} lossless round-trip failed "
                  f"(MSE={errs})", file=sys.stderr)
            return 1
        enc_mps[codec.name] = mp / enc_s
        enc_best_mps[codec.name] = mp / enc_best
        dec_mps[codec.name] = mp / dec_s
        base = baseline.get(codec.name, {}).get("encode_mps")
        if base:
            speedups[codec.name] = enc_mps[codec.name] / base
        ratio = len(blobs[0]) / (side * side * 24) * 100
        details.append(
            f"{codec.name}: enc {mp/enc_s:.2f} MP/s (trials "
            f"{'/'.join(f'{mp/t:.2f}' for t in enc_trials)}), dec "
            f"{mp/dec_s:.2f} MP/s, ratio {ratio:.3f}%, MSE {errs[0]:.1f}"
            + (f", {speedups[codec.name]:.1f}x host" if base else ""))

    for line in details:
        print(line, file=sys.stderr)

    if not enc_mps:
        print(json.dumps({"metric": "encode_throughput_geomean_9codecs",
                          "value": 0.0, "unit": "MP/s", "vs_baseline": 0.0,
                          "failures": failures}))
        return 1
    value = _geomean(enc_mps.values())
    vs = _geomean(speedups.values()) if len(speedups) == len(enc_mps) \
        else value / 1.0  # fallback: nominal 1 MP/s single-core reference
    out = {
        "metric": "encode_throughput_geomean_9codecs",
        "value": round(value, 3),
        "unit": "MP/s",
        "vs_baseline": round(vs, 3),
        "vs_baseline_kind": ("measured_host_single_core" if len(speedups) == len(enc_mps)
                             else "nominal_1mps"),
        # medians are the honest per-run statistic; the best-trial geomean
        # tracks machine capability through the bench host's documented
        # contention swings (r1 notes: whole runs move ~2x)
        "geomean_best_trials": round(_geomean(enc_best_mps.values()), 3),
        "decode_geomean_mps": round(_geomean(dec_mps.values()), 3),
        "per_codec_mps": {k: round(v, 3) for k, v in enc_mps.items()},
        "per_codec_decode_mps": {k: round(v, 3) for k, v in dec_mps.items()},
        # self-describing suite (VERDICT r3 #6): future comparisons can
        # see the shapes a run measured instead of reconstructing them
        # from round notes
        "suite": [{"spec": spec, "side": side, "images": n, "trials": TRIALS}
                  for spec, side, n in SUITE],
    }
    if speedups:
        out["per_codec_vs_host"] = {k: round(v, 2) for k, v in speedups.items()}
    if failures:
        out["failures"] = failures
    print(json.dumps(out))
    # a codec that fails fails the benchmark
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
