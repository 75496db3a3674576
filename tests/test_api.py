"""API-level tests, mirroring the reference's Python suites
(dietgpu/ans_test.py, dietgpu/float_test.py)."""

import numpy as np
import pytest

from dietgpu_fork_tpu.api import codec as C
from dietgpu_fork_tpu.core import reference as R
from dietgpu_fork_tpu.core.constants import FloatType
from tests.conftest import make_float_words


def normal(rng, n, dtype):
    if dtype == "bfloat16":
        import ml_dtypes

        return rng.normal(0, 1, n).astype(np.float32).astype(ml_dtypes.bfloat16)
    return rng.normal(0, 1, n).astype(dtype)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16", "float32", "float64"])
def test_float_compress_roundtrip(rng, dtype):
    ts = [normal(rng, n, dtype) for n in (1000, 100, 4097)]
    comp, sizes, temp = C.compress_data(True, ts, checksum=True)
    assert temp > 0
    rows, cols = C.max_float_compressed_output_size(ts)
    assert comp.shape == (rows, cols)

    outs, out_sizes, success, status, _ = C.decompress_data(
        True, comp, [t.size for t in ts], dtype=ts[0].dtype, checksum=True
    )
    assert status.ok and np.all(success)
    for t, o in zip(ts, outs):
        assert o.dtype == t.dtype
        assert np.array_equal(o.view(np.uint8), t.view(np.uint8))


def test_raw_ans_roundtrip(rng):
    ts = [rng.integers(0, 256, n, dtype=np.uint8) for n in (100, 65536)]
    comp, sizes, _ = C.compress_data(False, ts, checksum=True)
    outs, _, success, status, _ = C.decompress_data(
        False, comp, [t.size for t in ts], checksum=True
    )
    assert status.ok and np.all(success)
    for t, o in zip(ts, outs):
        assert np.array_equal(o, t)


def test_compressed_archives_match_oracle(rng):
    ts = [normal(rng, 3000, "float32")]
    arcs = C.compress_data_simple(True, ts, checksum=False, native=False)
    expect = R.float_compress(ts[0].view(np.uint32), FloatType.FLOAT32)
    assert np.array_equal(arcs[0], expect)


def test_native_archives_match_oracle_and_autodetect(rng):
    """Float archives with embedded ROW-STREAM (0xDB0D) ANS segments:
    byte-exact vs the oracle, and decompress auto-detects the layout from
    the embedded ANS magic (no native= hint)."""
    ts = [normal(rng, 3000, "float32"), normal(rng, 17000, "float32")]
    arcs = C.compress_data_simple(True, ts, checksum=True, native=True)
    for t, a in zip(ts, arcs):
        expect = R.float_compress(
            t.view(np.uint32), FloatType.FLOAT32, use_checksum=True,
            native=True,
        )
        assert np.array_equal(a, expect)
    outs, _, success, status, _ = C.decompress_data(
        True, arcs, [t.size for t in ts], dtype=np.float32, checksum=True
    )
    assert status.ok and np.all(success)
    for t, o in zip(ts, outs):
        assert np.array_equal(o, t)
    # raw-ANS auto-detect, and the layout mix guard
    bs = [t.view(np.uint8) for t in ts]
    comp_n, _, _ = C.compress_data(False, bs, native=True)
    outs, _, success, _, _ = C.decompress_data(
        False, comp_n, [b.size for b in bs]
    )
    assert np.all(success)
    for b, o in zip(bs, outs):
        assert np.array_equal(o, b)
    comp_c, _, _ = C.compress_data(False, bs, native=False)
    mixed = np.vstack(
        [np.asarray(comp_n)[:1], np.asarray(comp_c)[1:]]
    )
    with pytest.raises(ValueError, match="mixes"):
        C.decompress_data(False, mixed, [b.size for b in bs])


def test_simple_roundtrip_and_shrinkage(rng):
    # compression actually shrinks on N(0,1) data (float_test.py:86-92)
    ts = [normal(rng, 1 << 16, "bfloat16")]
    arcs = C.compress_data_simple(True, ts)
    assert arcs[0].size < ts[0].size * 2
    outs = C.decompress_data_simple(True, arcs)
    assert np.array_equal(outs[0].view(np.uint8), ts[0].view(np.uint8))


def test_empty_tensor_header_only(rng):
    ts = [np.zeros(0, np.float16)]
    arcs = C.compress_data_simple(True, ts)
    outs = C.decompress_data_simple(True, arcs)
    assert outs[0].size == 0


def test_split_size_float(rng):
    splits = [1000, 777, 4096]
    x = normal(rng, sum(splits), "float32")
    comp, sizes, _ = C.compress_data_split_size(True, x, splits)
    out, out_sizes, success, status, _ = C.decompress_data_split_size(
        True, comp, splits, dtype=x.dtype
    )
    assert np.all(success)
    assert np.array_equal(out.view(np.uint8), x.view(np.uint8))


def test_split_size_native_autodetect(rng):
    """Split-size decode of a ROW-STREAM (native) archive with no native=
    pin: the auto-detected layout must thread through to the decoder (an
    earlier codec.py dropped the detected flag and every native split-size
    decode raised)."""
    splits = [1000, 777, 4096]
    x = normal(rng, sum(splits), "float32")
    comp, _, _ = C.compress_data_split_size(True, x, splits, native=True)
    out, _, success, _, _ = C.decompress_data_split_size(
        True, comp, splits, dtype=x.dtype
    )
    assert np.all(success)
    assert np.array_equal(np.asarray(out).view(np.uint8), x.view(np.uint8))
    # raw-ANS native split-size autodetect as well
    xb = rng.integers(0, 256, 10000, dtype=np.uint8)
    comp, _, _ = C.compress_data_split_size(False, xb, [400, 9600], native=True)
    out, _, success, _, _ = C.decompress_data_split_size(
        False, comp, [400, 9600]
    )
    assert np.all(success)
    assert np.array_equal(np.asarray(out), xb)


def test_split_size_decompress_stays_on_device(rng):
    """decompress_data_split_size returns ONE contiguous DEVICE array (the
    reference writes a single device tensor, DietGpu.cpp:685-825); odd
    16-bit splits exercise the mid-word seam runs of the device concat."""
    import jax

    for dtype, splits in [
        ("float16", [1001, 3, 777, 4096]),  # odd counts -> seam words
        ("bfloat16", [5, 1, 9000]),
        ("float32", [1000, 777, 4096]),
        ("float64", [513, 2048]),
    ]:
        x = normal(rng, sum(splits), dtype)
        comp, _, _ = C.compress_data_split_size(True, x, splits)
        out, _, success, _, _ = C.decompress_data_split_size(
            True, comp, splits, dtype=x.dtype
        )
        assert isinstance(out, jax.Array) and np.all(success), dtype
        if dtype == "bfloat16":
            assert out.dtype == jax.numpy.bfloat16
        # fp64 without jax x64 comes back as uint32 (lo, hi) pairs
        assert np.array_equal(
            np.asarray(out).reshape(-1).view(np.uint8),
            x.view(np.uint8),
        ), dtype
    # raw ANS: interior 4-aligned, arbitrary tail
    xb = rng.integers(0, 256, 10003, dtype=np.uint8)
    comp, _, _ = C.compress_data_split_size(False, xb, [400, 8192, 1411])
    out, _, success, _, _ = C.decompress_data_split_size(
        False, comp, [400, 8192, 1411]
    )
    assert isinstance(out, jax.Array) and np.all(success)
    assert np.array_equal(np.asarray(out), xb)
    # size-mismatch members must raise
    with pytest.raises(RuntimeError, match="decoded size"):
        C.decompress_data_split_size(False, comp, [400, 8192, 1412])


def test_split_size_fp64_both_x64_modes(rng):
    """fp64 split-size contract: uint32 (lo, hi) pairs without x64 (viewable
    via as_float64), a real float64 device array with x64 on."""
    import jax

    splits = [513, 2048]
    x = normal(rng, sum(splits), "float64")
    comp, _, _ = C.compress_data_split_size(True, x, splits)

    out, _, success, _, _ = C.decompress_data_split_size(
        True, comp, splits, dtype=x.dtype
    )
    assert np.all(success)
    assert out.dtype == jax.numpy.uint32 and out.shape == (sum(splits), 2)
    f64 = C.as_float64(out)
    assert f64.dtype == np.float64
    assert np.array_equal(f64.view(np.uint8), x.view(np.uint8))

    jax.config.update("jax_enable_x64", True)
    try:
        out64, _, success, _, _ = C.decompress_data_split_size(
            True, comp, splits, dtype=x.dtype
        )
        assert np.all(success)
        assert out64.dtype == jax.numpy.float64
        assert out64.shape == (sum(splits),)
        assert np.array_equal(
            np.asarray(out64).view(np.uint8), x.view(np.uint8)
        )
        # as_float64 passes a true float64 array through
        assert np.array_equal(C.as_float64(out64), np.asarray(out64))
    finally:
        jax.config.update("jax_enable_x64", False)


def test_split_size_raw_alignment_enforced(rng):
    x = rng.integers(0, 256, 1000, dtype=np.uint8)
    with pytest.raises(ValueError, match="4-byte aligned"):
        C.compress_data_split_size(False, x, [3, 997])
    comp, _, _ = C.compress_data_split_size(False, x, [400, 600])
    out, _, success, _, _ = C.decompress_data_split_size(False, comp, [400, 600])
    assert np.all(success)
    assert np.array_equal(out, x)


def test_truncated_to_reported_size_still_decodes(rng):
    # ans_test.py:21-26 truncates archives to the reported size before decode
    ts = [normal(rng, 5000, "float16")]
    arcs = C.compress_data_simple(True, ts, checksum=True)
    outs = C.decompress_data_simple(True, arcs, checksum=True)
    assert np.array_equal(outs[0].view(np.uint8), ts[0].view(np.uint8))


def test_checksum_mismatch_raises(rng):
    ts = [normal(rng, 2000, "float32")]
    arcs = C.compress_data_simple(True, ts, checksum=True)
    arcs[0][40] ^= 0xFF
    with pytest.raises(RuntimeError, match="checksum"):
        C.decompress_data(True, arcs, [2000], dtype=ts[0].dtype, checksum=True)


def test_sparse_api_roundtrip(rng):
    w = normal(rng, 10000, "float32")
    w[rng.random(10000) < 0.5] = 0
    arcs = C.compress_data_simple(True, [w], sparse=True)
    expect = R.sparse_float_compress(w.view(np.uint32), FloatType.FLOAT32)
    assert np.array_equal(arcs[0], expect)
    outs = C.decompress_data_simple(True, arcs, sparse=True)
    assert np.array_equal(outs[0].view(np.uint8), w.view(np.uint8))


def test_decompress_data_device_stays_on_device(rng):
    # the zero-sync variant: device rows + device sizes, no host loop
    import jax

    ts = [normal(rng, n, "float32") for n in (5000, 12345)]
    comp, sizes, _ = C.compress_data(True, ts)
    words, nsz, succ = C.decompress_data_device(
        True, comp, out_capacity=12345, dtype=np.float32
    )
    assert isinstance(words, jax.Array) and isinstance(nsz, jax.Array)
    assert np.array_equal(np.asarray(nsz), [5000, 12345])
    assert np.all(np.asarray(succ))
    host = np.asarray(words).view(np.uint8)
    for i, t in enumerate(ts):
        assert np.array_equal(
            host[i, : t.size * 4], t.view(np.uint8)
        )
        assert not host[i, t.size * 4 :].any()  # zero padding


def test_sparse_simple_mixed_sizes(rng):
    # heterogeneous member sizes: the dense-header offset (sparse header +
    # bitmap) differs per member, so decompress_data_simple must compute it
    # per member rather than from member 0 (DietGpu.cpp:827-917 semantics)
    ws = []
    for n in (10000, 257, 40000):
        w = normal(rng, n, "float32")
        w[rng.random(n) < 0.5] = 0
        ws.append(w)
    arcs = C.compress_data_simple(True, ws, sparse=True)
    outs = C.decompress_data_simple(True, arcs, sparse=True)
    for o, w in zip(outs, ws):
        assert np.array_equal(o.view(np.uint8), w.view(np.uint8))


def test_temp_memory_contract(rng):
    # the reference returns a temp-mem high-water mark from every op
    # (DietGpu.cpp:285); ours reports the equivalent estimate
    from dietgpu_fork_tpu.runtime import stack_memory as sm

    est = sm.StackMemoryEstimator()
    est.alloc(1000)   # -> 1024 (256B aligned)
    est.alloc(2000)   # -> 2048
    est.free()
    est.alloc(500)    # -> 512
    assert est.high == 3072 and est.cur == 1536
    assert sm.ans_encode_temp_size(128, 512 * 1024) > 0
    assert sm.float_compress_temp_size(1, 1 << 20, FloatType.FLOAT64) > 0


def test_caller_supplied_histogram_matches_default(rng):
    # GpuANSCodec.h:82-84: encode entries accept a precomputed histogram and
    # skip the statistics pass; supplying the true histogram must reproduce
    # the default archives bit-exactly
    ts = [rng.integers(0, 100, n, dtype=np.uint8) for n in (5000, 12000)]
    hist = np.zeros((2, 256), np.uint32)
    for i, t in enumerate(ts):
        hist[i] = np.bincount(t, minlength=256).astype(np.uint32)
    base, base_bytes, _ = C.compress_data(False, ts)
    given, given_bytes, _ = C.compress_data(False, ts, histogram=hist)
    assert np.array_equal(np.asarray(base_bytes), np.asarray(given_bytes))
    assert np.array_equal(np.asarray(base), np.asarray(given))

    with pytest.raises(ValueError):
        C.compress_data(True, [np.zeros(8, np.float32)], histogram=hist)
