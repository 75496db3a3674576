"""JAX ANS codec in the ROW-STREAM layout (magic 0xDB0D) vs the
NumPy oracle (core/reference.py:ans_encode_native / ans_decode_native): the
device codec's native archives must match the oracle byte-for-byte and
round-trip exactly, mirroring tests/test_ans_jax.py for the classic layout.

Coverage: partial rows (NB % 4 != 0), partial final blocks, prob_bits 9-11
including the degenerate pdf=2^pb single-symbol table, mixed-size
incompressible batches, and classic<->native magic dispatch.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dietgpu_fork_tpu.core import reference as R
from dietgpu_fork_tpu.models import ans as A
from tests.conftest import make_exponential_bytes

enc = jax.jit(
    A.ans_encode_padded,
    static_argnames=("prob_bits", "use_checksum", "native"),
)
dec = jax.jit(
    A.ans_decode_padded,
    static_argnames=("out_capacity", "prob_bits", "native"),
)


def run_batch(rng, batch_sizes, S, lam=10.0, pb=10, cks=True, data=None):
    B = len(batch_sizes)
    x = np.zeros((B, S), np.uint8)
    datas = []
    for i, n in enumerate(batch_sizes):
        d = data[i] if data is not None else make_exponential_bytes(rng, n, lam)
        x[i, :n] = d
        datas.append(d)
    sizes = np.array(batch_sizes, np.int32)
    comp, comp_bytes = enc(
        jnp.array(x), jnp.array(sizes), prob_bits=pb, use_checksum=cks,
        native=True,
    )
    comp = np.asarray(comp)
    comp_bytes = np.asarray(comp_bytes)

    for i, d in enumerate(datas):
        arc = R.ans_encode_native(d, prob_bits=pb, use_checksum=cks)
        assert comp_bytes[i] == arc.size, f"member {i} size"
        assert np.array_equal(comp[i, : arc.size], arc), f"member {i}"

    out, success, sizes_out, _ = dec(
        jnp.array(comp), out_capacity=S, prob_bits=pb, native=True
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


def test_byte_exact_partial_rows_and_blocks(rng):
    # NB in {1, 2, 3, 4, 5}: covers rows of 1..4 blocks plus a partial
    # second row, with partial final blocks throughout
    run_batch(rng, [4095, 4097, 12289, 16384, 16389, 1], 20000)


def test_byte_exact_empty_member(rng):
    run_batch(rng, [0, 5000, 12288], 12288, pb=9)


def test_byte_exact_random_batch(rng):
    run_batch(rng, list(rng.integers(1, 20000, 8)), 20000)


@pytest.mark.parametrize("pb", [9, 10, 11])
def test_degenerate_single_symbol_table(rng, pb):
    # all-identical bytes quantize to pdf[sym] = 2^prob_bits, the shift
    # edge case the advisor called out (normalize_probs_batched packs the
    # full-probability row specially)
    n = 9000
    run_batch(rng, [n], n, pb=pb, data=[np.full(n, 170, np.uint8)])


def test_incompressible_mixed_batch_fits_bound(rng):
    from dietgpu_fork_tpu.core.constants import max_compressed_size

    sizes = [65536, 4096, 12289]
    datas = [rng.integers(0, 256, n).astype(np.uint8) for n in sizes]
    run_batch(rng, sizes, 65536, data=datas)
    x = np.zeros((3, 65536), np.uint8)
    for i, d in enumerate(datas):
        x[i, : d.size] = d
    _, comp_bytes = enc(
        jnp.array(x), jnp.array(sizes, np.int32), prob_bits=10,
        use_checksum=False, native=True,
    )
    for i, n in enumerate(sizes):
        assert int(comp_bytes[i]) <= max_compressed_size(n)


def test_native_never_larger_than_classic(rng):
    # per-row 16B alignment wastes no more than per-block alignment
    x = make_exponential_bytes(rng, 50000, 10.0)[None, :]
    sizes = jnp.array([50000], np.int32)
    _, cb_classic = enc(jnp.array(x), sizes, prob_bits=10, use_checksum=False)
    _, cb_native = enc(
        jnp.array(x), sizes, prob_bits=10, use_checksum=False, native=True
    )
    assert int(cb_native[0]) <= int(cb_classic[0])


def test_magic_dispatch_rejects_wrong_layout(rng):
    """A native archive decoded as classic (and vice versa) must fold into
    per-member success=False — never trap, never return garbage as
    success=True (the validation contract of _ans_parse_and_stage)."""
    x = rng.integers(0, 64, (1, 8192), np.uint8)
    sizes = jnp.array([8192], np.int32)
    comp_nat, _ = enc(
        jnp.array(x), sizes, prob_bits=10, use_checksum=False, native=True
    )
    comp_cls, _ = enc(
        jnp.array(x), sizes, prob_bits=10, use_checksum=False, native=False
    )
    out, success, sizes_out, _ = dec(
        comp_nat, out_capacity=8192, prob_bits=10, native=False
    )
    assert not bool(success[0]) and int(sizes_out[0]) == 0
    assert not np.any(np.asarray(out))
    out, success, sizes_out, _ = dec(
        comp_cls, out_capacity=8192, prob_bits=10, native=True
    )
    assert not bool(success[0]) and int(sizes_out[0]) == 0
    assert not np.any(np.asarray(out))


def test_oracle_decodes_jax_native_archive(rng):
    """Self-describing dispatch: the oracle's ans_decode (no layout hint)
    must route a JAX-produced native archive through ans_decode_native."""
    d = make_exponential_bytes(rng, 13000, 10.0)
    comp, comp_bytes = enc(
        jnp.array(d[None, :]), jnp.array([13000], np.int32), prob_bits=10,
        use_checksum=True, native=True,
    )
    arc = np.asarray(comp)[0, : int(comp_bytes[0])]
    out, hdr = R.ans_decode(arc)
    assert hdr.native and np.array_equal(out, d)


def test_info_reads_native_headers(rng):
    x = rng.integers(0, 256, (2, 4096), np.uint8)
    comp, _ = enc(
        jnp.array(x), jnp.array([4096, 100], np.int32), prob_bits=10,
        use_checksum=True, native=True,
    )
    sizes, csums = A.ans_get_compressed_info(comp)
    assert int(sizes[0]) == 4096 and int(sizes[1]) == 100
    assert int(csums[0]) == R.checksum(x[0])
    assert int(csums[1]) == R.checksum(x[1, :100])


def test_corrupt_native_block_words_fail_safely(rng):
    """Archive-supplied per-block word counts beyond the format maximum
    (MAX_BLOCK_WORDS per block) must not drive the staging merge out of
    range: the member folds into success=False (earlier finding on
    models/ans.py staging offsets)."""
    d = make_exponential_bytes(rng, 16389, 10.0)
    comp, comp_bytes = enc(
        jnp.array(d[None, :]), jnp.array([d.size], np.int32), prob_bits=10,
        use_checksum=False, native=True,
    )
    arc = np.asarray(comp).copy()
    # blockWords pairs sit at words META + 32*nb; poison block 0's counts
    # with the max 16-bit comp-word claim while keeping the header intact
    nb = R.num_blocks(d.size)
    bw_off = 136 + 32 * nb
    arc32 = arc.view(np.uint32)
    arc32[0, bw_off] = (4096 << 16) | 0xFFFF
    out, success, sizes_out, _ = dec(
        jnp.asarray(arc), out_capacity=d.size, prob_bits=10, native=True
    )
    assert not bool(success[0])
    assert not np.any(np.asarray(out))
