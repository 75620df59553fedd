#!/usr/bin/env python
"""Sweep driver with device/host overlap (VERDICT r3 #7).

The Makefile matrix runs its 22 configs strictly serially; during the
k-means configs (cluster-colors, voronoi) the host thread mostly sits in
device-wait windows (transfers, device convergence bursts), and during
the host-C configs (zip, hufman, hilbert) the device sits idle. This
driver is the sweep-scope analog of the reference's rayon fan-out
(bench.rs:22-27): two queues on two threads —

  device queue: cluster-colors(16..256), voronoi(64..2048)
  host queue:   hufman, delta, hilbert-*, zip-*, approx(1..16)

The host-C engines release the GIL inside ctypes calls and the device
queue releases it while it waits on the device, so the host queue
executes inside the device queue's wait windows. Each config
still runs through the stock `runner.measure_all` and writes its own CSV
— streams and CSV contents are byte-identical to serial runs by
construction (the queues share no codec state, and the device is touched
only by the device queue).

Usage:
  python scripts/run_sweep.py [--batch=4] [--serial] [--out=output]
                              [--configs=a,b,...] <pngs...>

--serial runs the same set on one thread (the A/B baseline). Prints
per-queue and total wall-clock.
"""

from __future__ import annotations

import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cniic_tpu.codecs import from_spec  # noqa: E402
from cniic_tpu import runner  # noqa: E402

DEVICE_CONFIGS = [
    "cluster-colors(16)", "cluster-colors(32)", "cluster-colors(64)",
    "cluster-colors(128)", "cluster-colors(256)",
    "voronoi(64)", "voronoi(128)", "voronoi(256)", "voronoi(512)",
    "voronoi(1024)", "voronoi(2048)",
]
HOST_CONFIGS = [
    "hufman", "delta", "hilbert(rle)", "hilbert(zip)",
    "zip(dict)", "zip(back)",
    "hilbert(rle(1))", "hilbert(rle(2))", "hilbert(rle(4))",
    "hilbert(rle(8))", "hilbert(rle(16))",
]


def split_configs(configs=None):
    """Route configs to the (device, host) queues: the k-means codecs own
    the device; everything else is host-C. The single routing authority —
    tests assert on this function, not a copy."""
    if configs is None:
        return DEVICE_CONFIGS, HOST_CONFIGS
    dev = [c for c in configs
           if c.startswith(("cluster-colors", "voronoi", "ccol", "c-col"))]
    return dev, [c for c in configs if c not in dev]


def run_queue(name, specs, paths, out_dir, batch, results, errors):
    t0 = time.perf_counter()
    for spec in specs:
        t1 = time.perf_counter()
        try:
            res = runner.measure_all(from_spec(spec), paths,
                                     output_dir=out_dir,
                                     verbose=False, batch=batch)
        except Exception as e:  # a dead queue must fail the sweep, not
            errors.append(f"{name}/{spec}: {e!r}")  # silently return 0
            print(f"[{name}] {spec}: FAILED {e!r}", flush=True)
            continue
        ok = len(res.rows)
        fail = len(res.failures)
        if fail:
            errors.append(f"{name}/{spec}: {fail} image(s) failed")
        print(f"[{name}] {spec}: {ok} ok/{fail} failed "
              f"{time.perf_counter() - t1:.1f}s", flush=True)
    results[name] = time.perf_counter() - t0


def main():
    batch, serial, out_dir = 4, False, "output"
    configs = None
    paths = []
    for a in sys.argv[1:]:
        if a.startswith("--batch="):
            batch = int(a[len("--batch="):])
        elif a == "--serial":
            serial = True
        elif a.startswith("--out="):
            out_dir = a[len("--out="):]
        elif a.startswith("--configs="):
            configs = a[len("--configs="):].split(",")
        else:
            # expand globs ourselves so a quoted 'data/x/*.png' (or a
            # caller that skips the shell) works the same as unquoted
            import glob as globlib

            paths.extend(sorted(globlib.glob(a)) or [a])
    if not paths:
        print(__doc__, file=sys.stderr)
        return 1

    dev, host = split_configs(configs)

    results: dict = {}
    errors: list = []
    t0 = time.perf_counter()
    if serial:
        run_queue("serial", dev + host, paths, out_dir, batch, results, errors)
    else:
        # the overlap rationale requires the host queue to stay off the
        # device; the opt-in device entropy paths would break that (and
        # the per-queue timings) if left exported
        for flag in ("CNIIC_DEVICE_BITPACK", "CNIIC_DEVICE_HUF_DECODE"):
            if os.environ.pop(flag, None) is not None:
                print(f"note: {flag} disabled for the overlapped sweep",
                      flush=True)
        th = threading.Thread(
            target=run_queue,
            args=("host", host, paths, out_dir, batch, results, errors))
        th.start()
        run_queue("device", dev, paths, out_dir, batch, results, errors)
        th.join()
    total = time.perf_counter() - t0
    for k, v in results.items():
        print(f"{k} queue: {v:.1f}s")
    print(f"total wall-clock: {total:.1f}s "
          f"({'serial' if serial else 'overlapped'})")
    if errors:
        print(f"{len(errors)} failure(s):")
        for e in errors:
            print(f"  {e}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
