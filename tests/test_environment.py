"""Where the program keeps what it builds, and how it refuses to run
without a GPU: the compile-cache placement, the native library's build
key, and chip_smoke.py on a CPU-only process."""

import os
import shutil
import subprocess
import sys

import pytest

from cniic_tpu import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dir_in_fresh_process(env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    out = subprocess.run(
        [sys.executable, "-c",
         "import cniic_tpu, jax; print(jax.config.jax_compilation_cache_dir)"],
        cwd=ROOT, env=env, capture_output=True, text=True, check=True)
    return out.stdout.strip()


def test_compile_cache_defaults_to_one_path_in_the_checkout():
    assert _cache_dir_in_fresh_process(None) == os.path.join(ROOT,
                                                             ".jax_cache")


def test_compile_cache_honours_jax_compilation_cache_dir(tmp_path):
    assert _cache_dir_in_fresh_process(str(tmp_path)) == str(tmp_path)


def test_native_build_key_covers_source_flags_compiler_and_cpu():
    base = ("src", "cc", ["-O3", "-march=native"], "x86_64 flags=avx2")
    key = native.build_key(base[0].encode(), *base[1:])
    assert key == native.build_key(base[0].encode(), *base[1:])
    variants = [(b"src2", "cc", base[2], base[3]),
                (b"src", "clang", base[2], base[3]),
                (b"src", "cc", ["-O3"], base[3]),
                (b"src", "cc", base[2], "x86_64 flags=avx512f")]
    assert len({native.build_key(*v) for v in variants} | {key}) == 5


def test_native_library_is_built_in_the_checkout_for_this_host():
    """The loaded library lives in the gitignored build directory under the
    key of the current source and this host's CPU; a library built for any
    other host or source has another name and is never loaded."""
    path = native.library_path()
    assert os.path.dirname(path) == os.path.join(ROOT, "cniic_tpu", "native",
                                                 "build")
    with open(os.path.join(ROOT, "cniic_tpu", "native", "cniic_native.c"),
              "rb") as fh:
        key = native.build_key(fh.read(), os.environ.get("CC", "cc"),
                               native._FLAGS, native._cpu_id())
    assert os.path.basename(path) == f"libcniic_native-{key}.so"
    if not os.environ.get("CNIIC_NATIVE_LIB"):
        assert native._load()._name == path
    with open(os.path.join(ROOT, ".gitignore")) as fh:
        assert "cniic_tpu/native/build/" in fh.read().split()


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_gpu(tmp_path, alone):
    """No GPU (or no package beside the script): non-zero exit and no
    result line."""
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    res = _run_smoke(cwd, script)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
