#!/usr/bin/env python
"""Extended randomized fuzz campaign over the nine decode paths.

tests/test_fuzz_decode.py runs a fixed-seed ~600-mutation budget per
family in CI; this driver is the long-running variant: many seeds, many
source images (different shapes/content change header layouts and symbol
tables), multi-byte corruption bursts, and splice mutations. Same
contract: decode either succeeds with a plausible uint8 image or raises
the ValueError family — anything else is a finding, and the offending
blob is written next to this script for reproduction.

Usage: python scripts/experiments/fuzz_campaign.py [seconds_per_family]
"""

from __future__ import annotations

import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")  # host-only campaign

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
from cniic_tpu.codecs import from_spec  # noqa: E402

FAMILIES = ["hufman", "zip(dict)", "zip(back)", "hilbert(rle)",
            "hilbert(rle(2))", "hilbert(zip)", "delta",
            "cluster-colors(4)", "voronoi(4)"]
ALLOWED = (ValueError,)


def source_images(rng):
    shapes = [(16, 24), (1, 40), (33, 7), (64, 64), (5, 129)]
    for h, w in shapes:
        img = np.zeros((h, w, 3), np.uint8)
        img[:, : w // 2] = rng.integers(0, 256, 3)
        img[h // 2:, :] = rng.integers(0, 256, (h - h // 2, w, 3))
        yield img


def mutate(rng, data: np.ndarray) -> bytes:
    n = data.size
    kind = rng.integers(0, 6)
    if kind == 0 and n:  # truncate
        return bytes(data[: rng.integers(0, n)])
    if kind == 1 and n:  # burst corruption (1-16 bytes)
        m = data.copy()
        pos = int(rng.integers(0, n))
        ln = int(rng.integers(1, 17))
        m[pos : pos + ln] = rng.integers(0, 256, min(ln, n - pos))
        return bytes(m)
    if kind == 2 and n:  # bit flips (1-4)
        m = data.copy()
        for _ in range(int(rng.integers(1, 5))):
            m[rng.integers(0, n)] ^= 1 << int(rng.integers(0, 8))
        return bytes(m)
    if kind == 3 and n > 8:  # splice two halves at a random joint
        a, b = int(rng.integers(0, n)), int(rng.integers(0, n))
        return bytes(np.concatenate([data[:a], data[b:]]))
    if kind == 4:  # random garbage
        return bytes(rng.integers(0, 256, int(rng.integers(0, 600)))
                     .astype(np.uint8))
    m = data.copy()  # header-focused byte smash
    if n:
        m[rng.integers(0, min(n, 32))] = rng.integers(0, 256)
    return bytes(m)


def main() -> int:
    budget = float(sys.argv[1]) if len(sys.argv) > 1 else 60.0
    rng = np.random.default_rng()  # OS-entropy seed: a new campaign per run
    findings = 0
    for spec in FAMILIES:
        codec = from_spec(spec)
        streams = []
        for img in source_images(rng):
            try:
                streams.append(np.frombuffer(codec.encode(img), np.uint8))
            except ValueError:
                pass  # e.g. k-means floor on tiny images — fine
        if not streams:
            print(f"{spec}: no encodable sources, skipping", flush=True)
            continue
        t0 = time.time()
        trials = 0
        family_findings0 = findings
        while time.time() - t0 < budget:
            data = streams[rng.integers(0, len(streams))]
            blob = mutate(rng, data)
            trials += 1
            try:
                out = codec.decode(blob)
            except ALLOWED:
                continue
            except Exception as e:  # noqa: BLE001 — the finding class
                path = os.path.join(os.path.dirname(__file__),
                                    f"fuzz_finding_{spec.replace('(', '_').replace(')', '')}.bin")
                with open(path, "wb") as fh:
                    fh.write(blob)
                print(f"FINDING {spec}: {e!r} (blob -> {path})", flush=True)
                findings += 1
                continue
            ok = (isinstance(out, np.ndarray) and out.dtype == np.uint8
                  and out.ndim == 3 and out.shape[2] == 3
                  and out.size <= 3 << 27)
            if not ok:
                print(f"FINDING {spec}: malformed decode output "
                      f"{type(out)}", flush=True)
                findings += 1
        fam = findings - family_findings0
        print(f"{spec}: {trials} mutated streams, "
              f"{'CLEAN' if not fam else f'{fam} finding(s)'}",
              flush=True)
    print(f"campaign done: {findings} finding(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
