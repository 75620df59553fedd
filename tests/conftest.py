"""Test harness config: run JAX on a virtual 8-device CPU mesh.

The config keys must be set before the backend initializes, which makes
this conftest the first jax-touching import of the session. Tests run
hardware-free, with Pallas kernels in interpret mode; the GPU path is
exercised by `python chip_smoke.py` on a machine with a GPU.
"""

import jax

jax.config.update("jax_platforms", "cpu")
try:
    jax.config.update("jax_num_cpu_devices", 8)
except Exception:  # backend already initialized (e.g. pytest-xdist worker)
    pass

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def test_image(rng):
    """Structured image: gradients, flat patches, a noisy corner."""
    h, w = 40, 67
    img = np.zeros((h, w, 3), np.uint8)
    img[:, :, 0] = np.linspace(0, 255, w, dtype=np.uint8)[None, :]
    img[:, :, 1] = np.linspace(0, 255, h, dtype=np.uint8)[:, None]
    img[8:25, 10:38] = [200, 30, 60]
    img[30:, 50:] = rng.integers(0, 256, (h - 30, w - 50, 3))
    return img
