"""cniic-tpu: an image-codec laboratory in JAX.

A from-scratch rebuild of the capabilities of hkapp/cniic (a Rust CLI of
"naive ideas for image compression"):

* the k-means stages of the lossy codecs (cluster-colors, voronoi) and the
  voronoi decode run as batched JAX programs over whole images resident in
  device memory, the k-means iteration as a fused Pallas kernel on the GPU;
* the sequential entropy-coding and scan stages (histograms, Huffman,
  LZ dictionary growth, lookback match emission, RLE) run in a small
  native C library driven through ctypes;
* wire formats are byte-compatible with the reference implementation
  (see `cniic_tpu.wire`), so compressed streams are directly comparable.

Public API:
    from cniic_tpu import codecs
    codec = codecs.from_spec("hilbert(rle(4))")
    payload = codec.encode(img)          # img: uint8[H, W, 3]
    restored = codec.decode(iter_or_bytes)
"""

__version__ = "0.1.0"

import os as _os

# the persistent compile cache's home when JAX_COMPILATION_CACHE_DIR is not
# set: one fixed path inside the checkout (listed in .gitignore)
DEFAULT_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")


def _enable_compilation_cache() -> None:
    """Persist XLA compilations across processes.

    JAX reads JAX_COMPILATION_CACHE_DIR itself; when it is set, no other
    directory is set here. Otherwise the cache lives at DEFAULT_CACHE_DIR:
    the path is part of what a later process must find, so it never moves.
    """
    import jax

    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        _os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


_enable_compilation_cache()
