"""Hardware-free CUDA lowering guards.

A Pallas kernel can fail to lower for the Triton route (an unsupported
primitive, a 64-bit value under jax_enable_x64) even when interpret-mode
tests pass, and a plain XLA program can trip a GPU-only lowering rule. AOT
cross-lowering for the CUDA platform from the CPU backend catches those
classes of regression without a GPU. What the GPU compiler itself refuses
(registers, shared memory) shows only on the card: chip_smoke.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest


def _lower_cuda(jitted, *args):
    return jitted.trace(*args).lower(lowering_platforms=("cuda",))


def test_bitpack_lowers_for_cuda():
    jax.config.update("jax_enable_x64", True)
    from cniic_tpu.ops import bitpack

    ids = jnp.asarray(np.zeros(4096, np.int32))
    hi = jnp.asarray(np.zeros(65, np.uint32))
    lo = jnp.asarray(np.zeros(65, np.uint32))
    lens = jnp.asarray(np.zeros(65, np.int32))
    f = jax.jit(functools.partial(bitpack._pack_device.__wrapped__, n_words=8194))
    _lower_cuda(f, ids, hi, lo, lens)


def _loop_args(B, n_pad, d, k):
    pts_f = jnp.asarray(np.zeros((B, n_pad, d), np.float32))
    pts_i = jnp.asarray(np.zeros((B, n_pad, d), np.int32))
    w = jnp.asarray(np.ones((B, n_pad), np.int32))
    valid = jnp.asarray(np.ones((B, n_pad), bool))
    cur = jnp.asarray(np.zeros((B, n_pad), np.int32))
    cents = jnp.asarray(np.zeros((B, k, d), np.int32))
    n = jnp.asarray(np.full(B, n_pad, np.int32))
    thresh = jnp.asarray(np.zeros(B, np.int32))
    moved0 = jnp.asarray(np.full(B, n_pad, np.int32))
    return (pts_f, pts_i, w, valid, cur, cents, n, thresh, moved0, moved0,
            jnp.zeros_like(moved0), jnp.int32(0))


@pytest.mark.parametrize("wide", [False, True])
def test_kmeans_loop_lowers_for_cuda(wide):
    """The XLA body: the narrow f32 assembly and the wide int32 one (4K)."""
    jax.config.update("jax_enable_x64", True)
    from cniic_tpu.ops import kmeans as km

    f = jax.jit(functools.partial(
        km._kmeans_loop.__wrapped__, k=4, max_iters=10, wide=wide,
        split=64 if wide else 32))
    _lower_cuda(f, *_loop_args(2, km._BLOCK, 5 if wide else 3, 4))


@pytest.mark.parametrize("k,packed", [(128, True), (512, False)])
def test_kmeans_kernel_lowers_for_cuda(k, packed):
    """The fused Triton kernel inside its loop: one centroid tile with the
    packed key, and many tiles with the two-reduce key."""
    jax.config.update("jax_enable_x64", True)
    from cniic_tpu.ops import kmeans_pallas as kp

    B, d, n_pad = 2, 5, 4096
    pts_i = jnp.asarray(np.zeros((B, n_pad, d), np.int32))
    pop, feat = kp.point_operands(pts_i, jnp.ones((B, n_pad), jnp.int32), 2, 1)
    cur = jnp.asarray(np.zeros((B, n_pad), np.int32))
    cents = jnp.asarray(np.zeros((B, k, d), np.int32))
    n = jnp.asarray(np.full(B, n_pad, np.int32))
    bs, kt, sub = kp.pick_block(n_pad, k)
    f = jax.jit(functools.partial(
        kp.kmeans_loop_pallas.__wrapped__, k=k, max_iters=8, bs=bs, kt=kt,
        sub=sub, vp=2, wp=1, pk=k, packed=packed, stall_lim=64,
        interpret=False))
    text = _lower_cuda(f, pop, feat, pts_i, cur, cents, n, n, n, n,
                       jnp.zeros_like(n), jnp.int32(0)).as_text()
    assert "triton" in text.lower()


def test_voronoi_reconstruct_mse_lowers_for_cuda():
    from cniic_tpu.ops import voronoi

    B, k, w, h = 2, 16, 40, 30
    args = (jnp.zeros((B, k), jnp.uint32), jnp.zeros((B, k), jnp.uint32),
            jnp.zeros((B, k, 3), jnp.uint8), jnp.ones((B, k), bool),
            jnp.zeros((B, w * h, 3), jnp.uint8))
    voronoi._reconstruct_mse_vmapped.trace(*args, w, h).lower(
        lowering_platforms=("cuda",))


def test_sharded_mse_lowers_for_cuda():
    jax.config.update("jax_enable_x64", True)
    from cniic_tpu.parallel import mesh as pmesh

    step = pmesh.sharded_mse(pmesh.make_mesh(2))
    x = jnp.zeros((4, 8, 8, 3), jnp.uint8)
    _lower_cuda(step, x, x)
