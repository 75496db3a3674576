"""Test configuration. The suite runs on whatever JAX platform the
environment selects: on the CPU (``JAX_PLATFORMS=cpu``) with 8 virtual
devices so the multi-device sharding tests run anywhere, or on the GPU for
the ``gpu``-marked tests (``python -m pytest tests -m gpu``). Mirrors the
reference's strategy of seeded-random round-trip testing (SURVEY.md §4),
with the addition of a NumPy oracle for byte-exact archive assertions."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from dietgpu_fork_tpu.core.constants import FloatType  # noqa: E402


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip ``gpu``-marked tests unless JAX's default backend is the GPU.
    Decided here, at run time, so every worker collects the same tests."""
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run `python -m pytest tests -m gpu` on the card")


@pytest.fixture
def rng():
    return np.random.default_rng(0xD1E7)


def make_float_words(rng, float_type, n, scale=1.0):
    """N(0, scale) data as raw words of the given float type."""
    x = rng.normal(0, scale, n)
    ft = FloatType(float_type)
    if ft == FloatType.FLOAT16:
        return x.astype(np.float16).view(np.uint16)
    if ft == FloatType.BFLOAT16:
        return (x.astype(np.float32).view(np.uint32) >> 16).astype(np.uint16)
    if ft == FloatType.FLOAT32:
        return x.astype(np.float32).view(np.uint32)
    if ft == FloatType.FLOAT64:
        return x.astype(np.float64).view(np.uint64)
    raise ValueError(float_type)


def make_exponential_bytes(rng, n, lam):
    """Exponential-sharpness byte data, as in the reference ANSTest.cu."""
    return np.minimum(rng.exponential(scale=256.0 / lam, size=n), 255).astype(
        np.uint8
    )
