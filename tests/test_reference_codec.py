"""Round-trip and format tests for the NumPy oracle codec.

Coverage mirrors the reference test matrix (ans/ANSTest.cu:243-282,
float/FloatTest.cu:287-341): probBits sweeps, exponential sharpness sweeps,
block-edge sizes (0/1/4095/4096/4097), all four float types, and sparse data.
"""

import numpy as np
import pytest

from dietgpu_fork_tpu.core import reference as R
from dietgpu_fork_tpu.core.constants import (
    FloatType,
    max_compressed_size,
    max_float_compressed_size,
    max_sparse_float_compressed_size,
)
from tests.conftest import make_exponential_bytes, make_float_words

EDGE_SIZES = [1, 2, 31, 32, 33, 4095, 4096, 4097, 12345]


@pytest.mark.parametrize("prob_bits", [9, 10, 11])
@pytest.mark.parametrize("lam", [1.0, 10.0, 100.0, 1000.0])
def test_ans_roundtrip_sharpness(rng, prob_bits, lam):
    data = make_exponential_bytes(rng, 20000, lam)
    arc = R.ans_encode(data, prob_bits=prob_bits, use_checksum=True)
    dec, hdr = R.ans_decode(arc, expected_prob_bits=prob_bits)
    assert np.array_equal(dec, data)
    assert arc.size % 16 == 0
    assert arc.size <= max_compressed_size(data.size)
    assert hdr.checksum == R.checksum(data)


@pytest.mark.parametrize("n", EDGE_SIZES)
def test_ans_roundtrip_edges(rng, n):
    data = rng.integers(0, 256, n, dtype=np.uint8)
    arc = R.ans_encode(data, prob_bits=10)
    dec, _ = R.ans_decode(arc)
    assert np.array_equal(dec, data)


def test_ans_empty():
    arc = R.ans_encode(np.zeros(0, np.uint8))
    assert arc.size == 544  # header + pdf table only
    dec, hdr = R.ans_decode(arc)
    assert dec.size == 0
    assert hdr.total_uncompressed_words == 0


def test_ans_single_symbol(rng):
    # all-same-byte input: pdf mass on one symbol
    data = np.full(10000, 7, np.uint8)
    arc = R.ans_encode(data, prob_bits=10)
    dec, _ = R.ans_decode(arc)
    assert np.array_equal(dec, data)


def test_normalization_invariants(rng):
    # mirrors ANSStatisticsTest.cu:169-207
    for lam in (1.0, 100.0):
        data = make_exponential_bytes(rng, 100000, lam)
        hist = R.histogram(data)
        for pb in (9, 10, 11):
            pdf, cdf, magic, shift = R.normalize_probs(hist, data.size, pb)
            assert pdf.sum() == 1 << pb
            assert np.all(pdf[hist > 0] >= 1)
            assert cdf[0] == 0
            assert np.all(np.diff(cdf.astype(np.int64)) == pdf[:-1].astype(np.int64))


def test_magic_division_exactness(rng):
    # the magic multiply/shift must compute exact unsigned division for all
    # states in range (encodeOneWarp, GpuANSEncode.cuh:79-86)
    hist = rng.integers(1, 1000, 256).astype(np.uint32)
    pdf, cdf, magic, shift = R.normalize_probs(hist, int(hist.sum()), 11)
    states = rng.integers(1 << 15, 1 << 31, 4096, dtype=np.uint64).astype(
        np.uint32
    )
    for s in rng.integers(0, 256, 32):
        p = int(pdf[s])
        if p == 0:
            continue
        t = ((states.astype(np.uint64) * int(magic[s])) >> 32).astype(np.uint32)
        div = (t + states) >> np.uint32(shift[s])
        assert np.array_equal(div, states // np.uint32(p))


@pytest.mark.parametrize(
    "ft",
    [FloatType.FLOAT16, FloatType.BFLOAT16, FloatType.FLOAT32, FloatType.FLOAT64],
)
@pytest.mark.parametrize("n", [1, 7, 4095, 4096, 10000])
def test_float_roundtrip(rng, ft, n):
    w = make_float_words(rng, ft, n)
    for pb in (9, 10):
        arc = R.float_compress(w, ft, prob_bits=pb, use_checksum=True)
        dec, hdr = R.float_decompress(arc)
        assert np.array_equal(dec, w)
        assert hdr.float_type == ft and hdr.size == n
        assert arc.size <= max_float_compressed_size(ft, n)


def test_float_split_join_exhaustive16(rng):
    # every 16-bit pattern must survive split/join for fp16 and bf16
    w = np.arange(1 << 16, dtype=np.uint16)
    for ft in (FloatType.FLOAT16, FloatType.BFLOAT16):
        comp, nc = R.float_split(w, ft)
        back = R.float_join(comp, nc, ft)
        assert np.array_equal(back, w)


def test_float_split_is_exponent_extraction(rng):
    # bf16: comp byte should be sign-rotated exponent (8 exponent bits)
    w = make_float_words(rng, FloatType.BFLOAT16, 1000)
    comp, _ = R.float_split(w, FloatType.BFLOAT16)
    exp = ((w >> 7) & np.uint16(0xFF)).astype(np.uint8)
    assert np.array_equal(comp[0], exp)
    # fp32: comp byte is the 8-bit exponent
    w = make_float_words(rng, FloatType.FLOAT32, 1000)
    comp, _ = R.float_split(w, FloatType.FLOAT32)
    exp = ((w >> 23) & np.uint32(0xFF)).astype(np.uint8)
    assert np.array_equal(comp[0], exp)


def test_float_checksum_mismatch_detected(rng):
    w = make_float_words(rng, FloatType.FLOAT32, 1000)
    arc = R.float_compress(w, FloatType.FLOAT32, use_checksum=True)
    arc = arc.copy()
    arc[40] ^= 0xFF  # corrupt a raw payload byte
    with pytest.raises(ValueError, match="checksum"):
        R.float_decompress(arc)


@pytest.mark.parametrize(
    "ft",
    [FloatType.FLOAT16, FloatType.BFLOAT16, FloatType.FLOAT32, FloatType.FLOAT64],
)
@pytest.mark.parametrize("sparsity", [0.0, 0.5, 0.95, 1.0])
def test_sparse_roundtrip(rng, ft, sparsity):
    n = 10000
    w = make_float_words(rng, ft, n)
    w = np.where(rng.random(n) < sparsity, np.zeros_like(w), w)
    arc = R.sparse_float_compress(w, ft, 9)
    dec, hdr = R.sparse_float_decompress(arc)
    assert np.array_equal(dec, w)
    assert arc.size <= max_sparse_float_compressed_size(ft, n)


def test_sparse_edge_last_elements(rng):
    # exercises the tail cases the reference mishandles
    # (GpuSparseFloatCompress.cuh:170-184)
    for tail in ([0, 0], [0, 1], [1, 0], [1, 1]):
        w = make_float_words(rng, FloatType.FLOAT32, 130)
        w[-2:] = np.where(np.array(tail) == 0, 0, w[-2:])
        w[w == 0] = 0
        arc = R.sparse_float_compress(w, FloatType.FLOAT32)
        dec, _ = R.sparse_float_decompress(arc)
        assert np.array_equal(dec, w)


def test_bitmap_pack_msb_first():
    nz = np.array([1, 0, 0, 0, 0, 0, 0, 1, 1], dtype=bool)
    packed = R.pack_bitmap(nz)
    assert packed[0] == 0b10000001
    assert packed[1] == 0b10000000
    assert np.array_equal(R.unpack_bitmap(packed, 9), nz)


class TestNativeRowStreamLayout:
    """The row-stream archive layout (magic 0xDB0D): oracle round trip,
    section equality with the classic layout, and size accounting."""

    def _roundtrip(self, data, pb=10):
        from dietgpu_fork_tpu.core import reference as R

        arch = R.ans_encode_native(data, prob_bits=pb)
        out, hdr = R.ans_decode_native(arch, expected_prob_bits=pb)
        assert hdr.native
        assert np.array_equal(out, data)
        return arch

    def test_roundtrip_sizes_and_lambdas(self, rng):
        from dietgpu_fork_tpu.core import reference as R

        for n in (0, 1, 31, 4095, 4096, 4097, 5 * 4096 + 7, 65536):
            for lam in (1.0, 40.0):
                d = np.minimum(
                    rng.exponential(lam, n), 255
                ).astype(np.uint8)
                arch = self._roundtrip(d)
                classic = R.ans_encode(d)
                # native saves alignment waste: never larger
                assert arch.size <= classic.size
                if n:
                    # header fields (minus magic), probs, states and
                    # blockWords.x match the classic archive exactly
                    nb = R.num_blocks(n)
                    so = R.ANSHeader.states_offset()
                    bo = R.ANSHeader.block_words_offset(nb)
                    assert np.array_equal(
                        arch[4:12], classic[4:12]
                    )  # nb, total uncompressed
                    assert np.array_equal(
                        arch[16 : so + 128 * nb],
                        classic[16 : so + 128 * nb],
                    )  # options..checksum, probs, states
                    bw_n = arch[bo : bo + 8 * nb].view(np.uint32).reshape(-1, 2)
                    bw_c = classic[bo : bo + 8 * nb].view(np.uint32).reshape(-1, 2)
                    assert np.array_equal(bw_n[:, 0], bw_c[:, 0])

    def test_self_describing_dispatch(self, rng):
        from dietgpu_fork_tpu.core import reference as R

        d = rng.integers(0, 256, 10000).astype(np.uint8)
        arch = R.ans_encode_native(d)
        out, hdr = R.ans_decode(arch)  # classic entry dispatches on magic
        assert hdr.native and np.array_equal(out, d)

    def test_row_segments_are_16b_aligned_and_packed(self, rng):
        from dietgpu_fork_tpu.core import reference as R

        d = rng.integers(0, 256, 9 * 4096 + 123).astype(np.uint8)
        arch = R.ans_encode_native(d)
        hdr = R.ANSHeader.unpack(arch[:32].view(np.uint32))
        nb = hdr.num_blocks
        bo = R.ANSHeader.block_words_offset(nb)
        bw = arch[bo : bo + 8 * nb].view(np.uint32).reshape(nb, 2)
        starts = bw[:, 1]
        # duplicated within each row, 8-u16 (16 B) aligned, non-decreasing
        rows = -(-nb // 4)
        for r in range(rows):
            blks = starts[4 * r : 4 * r + 4]
            assert (blks == blks[0]).all()
            assert blks[0] % 8 == 0
        cw = (bw[:, 0] & 0xFFFF).astype(np.int64)
        rw = np.zeros(rows, np.int64)
        for b in range(nb):
            rw[b // 4] += cw[b]
        aligned = ((rw + 7) // 8) * 8
        pref = np.concatenate([[0], np.cumsum(aligned)[:-1]])
        assert np.array_equal(starts[0::4].astype(np.int64), pref)
        assert hdr.total_compressed_words == int(aligned.sum())
