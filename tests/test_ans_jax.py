"""JAX ANS codec vs the NumPy oracle: byte-exact archives and round-trips.

This is the strongest form of the reference's ans_test coverage
(ans/ANSTest.cu:243-282): instead of only asserting round-trip equality, the
device codec's archives must match the oracle byte-for-byte.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dietgpu_fork_tpu.core import reference as R
from dietgpu_fork_tpu.models import ans as A
from tests.conftest import make_exponential_bytes

enc = jax.jit(A.ans_encode_padded, static_argnames=("prob_bits", "use_checksum"))
dec = jax.jit(A.ans_decode_padded, static_argnames=("out_capacity", "prob_bits"))


def run_batch(rng, batch_sizes, S, lam=10.0, pb=10, cks=True):
    B = len(batch_sizes)
    x = np.zeros((B, S), np.uint8)
    datas = []
    for i, n in enumerate(batch_sizes):
        d = make_exponential_bytes(rng, n, lam)
        x[i, :n] = d
        datas.append(d)
    sizes = np.array(batch_sizes, np.int32)
    comp, comp_bytes = enc(
        jnp.array(x), jnp.array(sizes), prob_bits=pb, use_checksum=cks
    )
    comp = np.asarray(comp)
    comp_bytes = np.asarray(comp_bytes)

    for i, d in enumerate(datas):
        arc = R.ans_encode(d, prob_bits=pb, use_checksum=cks)
        assert comp_bytes[i] == arc.size
        assert np.array_equal(comp[i, : arc.size], arc), f"member {i}"

    out, success, sizes_out, _ = dec(
        jnp.array(comp), out_capacity=S, prob_bits=pb
    )
    out = np.asarray(out)
    assert np.all(np.asarray(success))
    for i, d in enumerate(datas):
        assert np.asarray(sizes_out)[i] == d.size
        assert np.array_equal(out[i, : d.size], d)


@pytest.mark.parametrize("pb", [9, 10, 11])
@pytest.mark.parametrize("lam", [1.0, 100.0])
def test_byte_exact_sharpness(rng, pb, lam):
    run_batch(rng, [5000, 20000], 20000, lam=lam, pb=pb)


def test_byte_exact_block_edges(rng):
    run_batch(rng, [4095, 4096, 4097, 1, 8192], 8192)


def test_byte_exact_empty_member(rng):
    run_batch(rng, [0, 5000, 12288], 12288, pb=9)


def test_byte_exact_random_batch(rng):
    run_batch(rng, list(rng.integers(1, 20000, 8)), 20000)


def test_capacity_failure_reports_required_size(rng):
    x = rng.integers(0, 256, (1, 8192), np.uint8)
    comp, _ = enc(
        jnp.array(x), jnp.array([8192], np.int32), prob_bits=10,
        use_checksum=False,
    )
    out, success, sizes_out, _ = dec(
        jnp.array(comp), out_capacity=4096, prob_bits=10
    )
    assert not bool(success[0])
    assert int(sizes_out[0]) == 8192
    assert not np.any(np.asarray(out))  # failed members produce zeros


def test_incompressible_data_fits_bound(rng):
    # uniform random bytes: worst-case expansion must stay within
    # max_compressed_size (mirrors the encoder's internal assert,
    # GpuANSEncode.cuh:356-361)
    from dietgpu_fork_tpu.core.constants import max_compressed_size

    x = rng.integers(0, 256, (1, 65536), np.uint8)
    comp, comp_bytes = enc(
        jnp.array(x), jnp.array([65536], np.int32), prob_bits=10,
        use_checksum=False,
    )
    assert int(comp_bytes[0]) <= max_compressed_size(65536)
    out, success, _, _ = dec(jnp.array(comp), out_capacity=65536, prob_bits=10)
    assert bool(success[0])
    assert np.array_equal(np.asarray(out), x)


def test_info(rng):
    x = rng.integers(0, 256, (2, 4096), np.uint8)
    comp, _ = enc(
        jnp.array(x), jnp.array([4096, 100], np.int32), prob_bits=10,
        use_checksum=True,
    )
    sizes, csums = A.ans_get_compressed_info(comp)
    assert int(sizes[0]) == 4096 and int(sizes[1]) == 100
    assert int(csums[0]) == R.checksum(x[0])
    assert int(csums[1]) == R.checksum(x[1, :100])
