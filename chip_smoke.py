#!/usr/bin/env python
"""End-to-end smoke run of cniic-tpu on one GPU (or, with --four, the
batch-mesh path on four).

    python chip_smoke.py          # one card; the phases below
    python chip_smoke.py --four   # exactly four cards; the mesh path only

Phases (each raises on failure; nothing is caught):

  (a) the main path: all nine codecs of bench.py's SUITE through the CLI
      entry point `cli.main(["--batch=8", "--codec=<spec>", *pngs])` over
      8 DIV2K-shaped 2040x1356 images generated from seed 7 (the
      `make div2k-shaped-corpus` generator). Every call must return 0
      (every lossless MSE 0, every CSV row written). Run twice: the first
      pass compiles, the second is reported.
  (b) the fused k-means kernel against the XLA body at the widths of (a):
      one iteration of each compiled kernel variant (voronoi(128),
      voronoi(2048), cluster-colors(32)) compared with zero tolerance
      (assignments, int32 statistics, move counts), then the full
      cluster-colors(32) and voronoi(128) encodes both ways — byte-identical
      streams, per-burst device time and end-to-end encode MP/s of each
      path.
  (c) the golden 4K streams (tests/test_golden_4k.py) encoded on the card.
  (d) the env-gated XLA device paths (CNIIC_DEVICE_BITPACK=1,
      CNIIC_DEVICE_HUF_DECODE=1) once each, with their parity checks.

Prints the card's name and power limit on an early line, and as its last
line one JSON object: {"ok": true, "device": {"platform", "kind",
"count"}}. Exits non-zero, printing no result, when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SUITE = ["hufman", "delta", "hilbert(rle)", "hilbert(rle(4))",
         "cluster-colors(32)", "voronoi(128)", "hilbert(zip)", "zip(dict)",
         "zip(back)"]
KMEANS_SPECS = ["cluster-colors(32)", "voronoi(128)"]
N_IMAGES, H, W, SEED = 8, 1356, 2040, 7


def _gpu_count() -> int:
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                             text=True).stdout
    except FileNotFoundError:
        return 0
    return sum(1 for line in out.splitlines() if line.startswith("GPU "))


def _load_module(name: str, rel: str):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, rel))
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def _corpus(synth):
    rng = np.random.default_rng(SEED)
    return [synth(rng, H, W) for _ in range(N_IMAGES)]


def _mps(imgs, seconds: float) -> float:
    return sum(im.shape[0] * im.shape[1] for im in imgs) / 1e6 / seconds


def phase_main_path(imgs, out):
    from cniic_tpu import cli, image_io, runner

    data_dir = os.path.join(ROOT, "data", "smoke")
    os.makedirs(data_dir, exist_ok=True)
    paths = []
    for i, im in enumerate(imgs):
        p = os.path.join(data_dir, f"nat_{i:04d}.png")
        image_io.save_png(im, p)
        paths.append(p)

    results = {}
    measure_all = runner.measure_all

    def spy(codec, *a, **kw):
        results[codec.name] = res = measure_all(codec, *a, **kw)
        return res

    runner.measure_all = spy
    try:
        for pass_no in (0, 1):
            for spec in SUITE:
                t0 = time.perf_counter()
                rc = cli.main(["--batch=8", f"--codec={spec}", *paths])
                wall = time.perf_counter() - t0
                if rc != 0:
                    raise RuntimeError(f"cli.main({spec}) returned {rc}")
                (name, res), = [(k, v) for k, v in results.items()]
                results.clear()
                if len(res.rows) != N_IMAGES or res.failures:
                    raise RuntimeError(f"{spec}: {len(res.rows)} rows, "
                                       f"failures {res.failures}")
                if pass_no == 1:
                    out(f"(a) {spec}: encode {res.encode_mps:.3f} MP/s, "
                        f"decode {res.megapixels / res.decode_s:.3f} MP/s, "
                        f"ratio {res.mean_ratio:.3f}%, MSE "
                        f"{res.mean_error:.3f}, wall {wall:.1f} s")
                else:
                    out(f"(a) {spec}: first pass {wall:.1f} s (compiles)")
    finally:
        runner.measure_all = measure_all


def phase_kernel_ab(imgs, out):
    import jax

    from cniic_tpu.codecs import from_spec
    from cniic_tpu.ops import kmeans as km
    from cniic_tpu.ops import kmeans_pallas as kp

    pk_probe = _load_module("profile_kmeans", os.path.join(
        "scripts", "experiments", "profile_kmeans.py"))

    # one step of each kernel variant the codecs compile, at real widths,
    # against the XLA step with zero tolerance (assignments, int32
    # statistics, move counts): voronoi(128) — the packed key over four
    # centroid tiles; voronoi(2048) — the two-reduce key over 64 tiles (any
    # voronoi k >= 256 at this size); cluster-colors(32) — one tile over the
    # 8 images' weighted unique colors
    for name, make, k in (("voronoi(128)", pk_probe.voronoi_state, 128),
                          ("voronoi(2048)", pk_probe.voronoi_state, 2048),
                          ("cluster-colors(32)",
                           pk_probe.cluster_colors_state, 32)):
        state, d2b = make(imgs, k)
        blocks = km._pallas_block(state[1].shape[1], k, d2b)
        if blocks is None:
            raise RuntimeError(f"{name}: the kernel is not selected")
        pk_probe.probe(f"(b) {name}", state, k, d2b, [blocks], out)

    # per-burst device time: the host blocks on every burst's result;
    # (seconds, iterations) per burst, from the loop's it0 argument
    bursts = []

    def timed(fn, it0_index):
        def run(*a, **kw):
            t0 = time.perf_counter()
            res = jax.block_until_ready(fn(*a, **kw))
            bursts.append((time.perf_counter() - t0,
                           int(res[0]) - int(a[it0_index])))
            return res
        return run

    loops = {"kernel": (kp, "kmeans_loop_pallas", 10),
             "xla": (km, "_kmeans_loop", 11)}
    for spec in KMEANS_SPECS:
        codec = from_spec(spec)
        streams, rates = {}, {}
        for path in ("kernel", "xla", "kernel", "xla"):
            os.environ["CNIIC_PALLAS_KMEANS"] = "1" if path == "kernel" \
                else "0"
            mod, attr, it0_index = loops[path]
            orig = getattr(mod, attr)
            setattr(mod, attr, timed(orig, it0_index))
            bursts.clear()
            try:
                t0 = time.perf_counter()
                got = codec.encode_batch(imgs)
                wall = time.perf_counter() - t0
            finally:
                setattr(mod, attr, orig)
                os.environ.pop("CNIIC_PALLAS_KMEANS", None)
            if path in streams and streams[path] != got:
                raise RuntimeError(f"{spec} {path}: streams differ per run")
            streams[path] = got
            busy = sum(t for t, _ in bursts)
            iters = sum(i for _, i in bursts)
            rates.setdefault(path, []).append(
                (_mps(imgs, wall), len(bursts), busy * 1e3 / len(bursts),
                 iters, busy * 1e3 / max(iters, 1)))
        if streams["kernel"] != streams["xla"]:
            raise RuntimeError(f"{spec}: kernel and XLA streams differ")
        for path in ("kernel", "xla"):
            mps, nb, burst_ms, iters, iter_ms = rates[path][1]
            out(f"(b) {spec} {path}: encode {mps:.3f} MP/s (warm; first "
                f"call {rates[path][0][0]:.3f}), {nb} bursts of "
                f"{burst_ms:.3f} ms, {iters} lane-chunk iterations at "
                f"{iter_ms:.3f} ms")
        out(f"(b) {spec}: kernel and XLA streams byte-identical")


def phase_golden_4k(synth, out):
    from cniic_tpu.codecs import from_spec

    g = _load_module("test_golden_4k", os.path.join("tests",
                                                    "test_golden_4k.py"))
    img = synth(np.random.default_rng(42), 2160, 3840)
    if hashlib.sha256(img.tobytes()).hexdigest() != g._IMG_SHA:
        raise RuntimeError("4K image generator drifted")
    t0 = time.perf_counter()
    vor = from_spec("voronoi(128)").encode(img)
    t_vor = time.perf_counter() - t0
    if hashlib.sha256(vor).hexdigest() != g._STREAM_SHA:
        raise RuntimeError("voronoi(128) 4K stream differs from the fixture")
    t0 = time.perf_counter()
    cc = from_spec("cluster-colors(32)").encode(img)
    t_cc = time.perf_counter() - t0
    if len(cc) != g._CC_SIZE or \
            hashlib.sha256(cc).hexdigest() != g._CC_STREAM_SHA:
        raise RuntimeError("cluster-colors(32) 4K stream differs")
    out(f"(c) 4K voronoi(128) and cluster-colors(32) streams match the "
        f"fixtures (encode {t_vor:.1f} s and {t_cc:.1f} s, cold)")


def phase_device_paths(imgs, out):
    from cniic_tpu.codecs import from_spec

    pair = imgs[:2]
    for spec in ("hufman", "delta"):
        codec = from_spec(spec)
        host = codec.encode_batch(pair)
        os.environ["CNIIC_DEVICE_BITPACK"] = "1"
        try:
            dev = codec.encode_batch(pair)
        finally:
            os.environ.pop("CNIIC_DEVICE_BITPACK")
        if dev != host:
            raise RuntimeError(f"{spec}: device bit packer stream differs")
        os.environ["CNIIC_DEVICE_HUF_DECODE"] = "1"
        try:
            for im, blob in zip(pair, host):
                if not np.array_equal(codec.decode(blob), im):
                    raise RuntimeError(f"{spec}: device decode differs")
        finally:
            os.environ.pop("CNIIC_DEVICE_HUF_DECODE")
        out(f"(d) {spec}: CNIIC_DEVICE_BITPACK=1 stream and "
            f"CNIIC_DEVICE_HUF_DECODE=1 decode match the host paths")


def phase_four(imgs, out):
    from cniic_tpu.codecs import from_spec
    from cniic_tpu.ops import kmeans as km
    from cniic_tpu.parallel import mesh as pmesh

    for spec in KMEANS_SPECS:
        codec = from_spec(spec)
        t0 = time.perf_counter()
        meshed = codec.encode_batch(imgs)
        t_mesh = time.perf_counter() - t0
        os.environ["CNIIC_MESH"] = "0"
        try:
            t0 = time.perf_counter()
            single = codec.encode_batch(imgs)
            t_single = time.perf_counter() - t0
        finally:
            os.environ.pop("CNIIC_MESH")
        if meshed != single:
            raise RuntimeError(f"{spec}: mesh streams differ from one card")
        out(f"(4) {spec}: 8 images on the 4-card mesh == one card "
            f"(encode {t_mesh:.1f} s vs {t_single:.1f} s, first calls)")

    img = imgs[0]
    yy, xx = np.mgrid[0:H, 0:W]
    pts = np.concatenate([xx.reshape(-1, 1), yy.reshape(-1, 1),
                          img.reshape(-1, 3)], axis=1).astype(np.int64)
    c1, a1, i1 = km.kmeans(pts, 128)
    c2, a2, i2 = pmesh.sharded_kmeans(pmesh.make_mesh(4), pts, 128)
    if not (i1 == i2 and np.array_equal(a1, a2) and np.array_equal(c1, c2)):
        raise RuntimeError("sharded_kmeans differs from kmeans")
    out(f"(4) sharded_kmeans over 4 cards == kmeans on one "
        f"({pts.shape[0]} 5-D points, k=128, {i1} iterations)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card batch-mesh path")
    args = ap.parse_args()

    want = 4 if args.four else 1
    visible = _gpu_count()
    if args.four and visible != 4:
        raise SystemExit(f"--four needs exactly 4 GPUs, {visible} visible")
    notes = []
    if not args.four and visible > 1:
        # before JAX starts: this run uses the first card only
        os.environ["CUDA_VISIBLE_DEVICES"] = "0"
        notes.append(f"{visible} GPUs visible; using the first only")

    sys.path.insert(0, ROOT)
    import jax

    import cniic_tpu  # noqa: F401  (compile cache placement)

    dev = jax.devices()
    if dev[0].platform != "gpu" or len(dev) != want:
        raise SystemExit(f"needs {want} GPU(s); JAX sees "
                         f"{dev[0].platform} x {len(dev)}")

    def out(line):
        print(line, flush=True)

    for note in notes:
        out(note)
    out(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    out(f"jax {jax.__version__}: {dev[0].platform} / {dev[0].device_kind} "
        f"x {len(dev)}")

    synth = _load_module("make_synth_corpus", os.path.join(
        "scripts", "make_synth_corpus.py")).synth_natural
    t0 = time.perf_counter()
    imgs = _corpus(synth)
    out(f"corpus: {N_IMAGES} x {W}x{H} from seed {SEED} "
        f"({time.perf_counter() - t0:.1f} s)")

    if args.four:
        phase_four(imgs, out)
    else:
        for phase in (lambda: phase_main_path(imgs, out),
                      lambda: phase_kernel_ab(imgs, out),
                      lambda: phase_golden_4k(synth, out),
                      lambda: phase_device_paths(imgs, out)):
            t0 = time.perf_counter()
            phase()
            out(f"  phase time {time.perf_counter() - t0:.1f} s")

    print(json.dumps({"ok": True, "device": {
        "platform": dev[0].platform, "kind": dev[0].device_kind,
        "count": len(dev)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
