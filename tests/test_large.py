"""Large-input correctness tests, mirroring the reference's big cases:
a 256 x 512Ki-float batch (FloatTest.cu:316-328 "LargeBatch") and a
123,456,789-element single tensor (dietgpu/float_test.py:66-76
"test_large"). The full-size variants need the card and are marked
``gpu``; a ~8M-element single-member case runs on the CPU so large-shape
block accounting (thousands of blocks per member) is exercised
everywhere."""

import numpy as np
import pytest

pytestmark = pytest.mark.slow

import dietgpu_fork_tpu.api.codec as C


@pytest.fixture
def rng():
    return np.random.default_rng(0x1A47E)


def _roundtrip(ts, dtype, checksum=True):
    comp, sizes, _ = C.compress_data(True, ts, checksum=checksum)
    outs, out_sizes, succ, _, _ = C.decompress_data(
        True, comp, [t.size for t in ts], dtype=dtype, checksum=checksum
    )
    assert all(bool(s) for s in np.asarray(succ))
    assert np.array_equal(np.asarray(out_sizes), [t.size for t in ts])
    for o, t in zip(outs, ts):
        o = np.asarray(o)
        assert o.dtype == t.dtype and o.shape == t.shape
        assert np.array_equal(o.view(np.uint8), t.view(np.uint8))
    return np.asarray(sizes)


def test_single_member_8m_cpu(rng):
    """~8M floats in one member: thousands of ANS blocks, compressed size
    well past any 32-bit-index edge of interest."""
    n = 8_000_001  # odd size: exercises the partial final block too
    t = rng.standard_normal(n).astype(np.float16)
    sizes = _roundtrip([t], np.float16)
    # N(0,1) fp16 compresses: the archive must be smaller than raw
    assert 0 < sizes[0] < 2 * n


@pytest.mark.gpu
@pytest.mark.parametrize(
    "dtype", [np.float16, "bfloat16", np.float32, np.float64]
)
def test_large_batch_256x512k(rng, dtype):
    """FloatTest.cu:316-328: 256 members of 512Ki floats each."""
    import ml_dtypes  # jax dep; gives numpy a bfloat16 dtype

    dt = np.dtype(ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype)
    # 8 distinct buffers cycled to 256 members keeps host RAM bounded
    # while every member still gets its own header/blocks/archive slot
    ts = [rng.standard_normal(512 * 1024).astype(dt) for _ in range(8)] * 32
    _roundtrip(ts, dt)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float16, np.float32])
def test_large_single_123m(rng, dtype):
    """dietgpu/float_test.py:66-76: one 123,456,789-element tensor."""
    t = rng.standard_normal(123_456_789).astype(dtype)
    _roundtrip([t], np.dtype(dtype))
