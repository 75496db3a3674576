"""The CUDA rANS walks (ops/rans_cuda.py) and what surrounds them.

On the CPU: the choice of implementation (the kernel on a "gpu" backend,
the plain walk elsewhere), the kernel wrappers' shapes, stream stride and
argument checks through a stub FFI call, and the whole codec running
through those wrappers. On the card (``gpu`` marker): each kernel against
its plain jax.numpy reference at the edge sizes and every prob_bits.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dietgpu_fork_tpu.core import reference as R
from dietgpu_fork_tpu.models import ans as A
from dietgpu_fork_tpu.ops import rans_cuda, rans_decode, rans_encode
from dietgpu_fork_tpu.ops.histogram import histogram_packed
from dietgpu_fork_tpu.ops.table import (
    build_decode_table_batched,
    normalize_probs_batched,
    pack_encode_table,
)
from tests.conftest import make_exponential_bytes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def walk_inputs(rng, sizes, prob_bits):
    """Classic-layout walk inputs for a batch of exponential-byte members:
    (encode args, decode-side (uncomp_words, lut), member bytes)."""
    nb = max(1, -(-max(sizes) // 4096))
    buf = np.zeros((len(sizes), nb * 4096), np.uint8)
    datas = []
    for i, n in enumerate(sizes):
        d = make_exponential_bytes(rng, n, 10.0)
        buf[i, :n] = d
        datas.append(d)
    x32 = jnp.asarray(buf.view(np.uint32))
    sz = jnp.asarray(sizes, jnp.int32)
    pdf, cdf, magic, shift = normalize_probs_batched(
        histogram_packed(x32, sz), sz, prob_bits
    )
    blk = jnp.arange(nb, dtype=jnp.int32)[None, :]
    uncomp = jnp.clip(sz[:, None] - blk * 4096, 0, 4096)
    lut = build_decode_table_batched(pdf, prob_bits)
    enc_args = (x32, sz, pack_encode_table(pdf, cdf, shift), magic)
    return enc_args, (uncomp, lut), datas


class StubFFI:
    """Stands in for jax.ffi.ffi_call: records each call and answers with
    the plain walk, so the codec around the kernel runs unchanged."""

    def __init__(self):
        self.calls = []

    def __call__(self, name, result_shapes):
        def run(*args, prob_bits):
            self.calls.append((name, result_shapes, args, prob_bits))
            pb = int(prob_bits)
            if name == "dietgpu_rans_encode":
                return rans_encode.encode_blocks_plain(*args, pb)
            return rans_decode.decode_blocks_plain(*args, pb)

        return run


@pytest.fixture
def stub_gpu(monkeypatch):
    """A "gpu" default backend with the kernel library replaced by a stub."""
    stub = StubFFI()
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(rans_cuda, "_ensure_registered", lambda: None)
    monkeypatch.setattr(rans_cuda, "_ffi", stub)
    return stub


def _fail_ffi(name, shapes):
    raise AssertionError(f"kernel {name} reached on the CPU backend")


@pytest.mark.parametrize("prob_bits", [9, 11])
def test_gpu_backend_reaches_encode_kernel(rng, stub_gpu, prob_bits):
    enc_args, _, _ = walk_inputs(rng, [5000, 1], prob_bits)
    got = rans_encode.encode_blocks(*enc_args, prob_bits)
    (name, shapes, args, pb), = stub_gpu.calls
    assert name == "dietgpu_rans_encode"
    assert pb.dtype == np.int32 and int(pb) == prob_bits
    # the contract: (states, streams32 with a 1280-word stride, num_words)
    assert [(s.shape, s.dtype) for s in shapes] == [
        ((2, 2, 32), jnp.uint32),
        ((2, 2, rans_cuda.STREAM_WORDS32), jnp.uint32),
        ((2, 2), jnp.int32),
    ]
    assert [a.dtype for a in args] == [jnp.uint32, jnp.int32, jnp.uint32,
                                       jnp.uint32]
    want = rans_encode.encode_blocks_plain(*enc_args, prob_bits)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert np.array_equal(np.asarray(g), np.asarray(w))


def test_gpu_backend_reaches_decode_kernel(rng, stub_gpu):
    enc_args, (uncomp, lut), datas = walk_inputs(rng, [4097, 300], 10)
    states, streams, nw = rans_encode.encode_blocks_plain(*enc_args, 10)
    staged = jnp.pad(streams, ((0, 0), (0, 0), (0, 8)))
    out = rans_decode.decode_blocks(staged, nw, uncomp, states, lut, 10)
    (name, shape, args, pb), = stub_gpu.calls
    assert name == "dietgpu_rans_decode"
    assert (shape.shape, shape.dtype) == ((2, 2, 1024), jnp.uint32)
    assert args[0].shape == (2, 2, rans_cuda.DECODE_STAGE_WORDS32)
    got = np.asarray(out).view(np.uint8).reshape(2, -1)
    for i, d in enumerate(datas):
        assert np.array_equal(got[i, : d.size], d)
        assert not got[i, d.size:].any()


@pytest.mark.parametrize("native", [False, True])
def test_cpu_backend_takes_plain_walks(rng, monkeypatch, native):
    """On the CPU neither walk reaches the kernel, in either layout."""
    monkeypatch.setattr(rans_cuda, "_ffi", _fail_ffi)
    d = make_exponential_bytes(rng, 9000, 10.0)
    comp, nbytes = A.ans_encode_padded(
        jnp.asarray(d[None]), jnp.asarray([d.size], jnp.int32), 10, True,
        native=native,
    )
    oracle = R.ans_encode_native if native else R.ans_encode
    assert np.array_equal(
        np.asarray(comp)[0, : int(nbytes[0])], oracle(d, 10, True)
    )
    out, ok, _, _ = A.ans_decode_padded(comp, d.size, 10, native=native)
    assert bool(ok[0]) and np.array_equal(np.asarray(out)[0], d)


def test_codec_through_kernel_wrappers_matches_oracle(rng, stub_gpu):
    """The classic codec, with both walks routed through the kernel
    wrappers, writes the oracle's archive and reads it back: the kernels'
    1280-word stream stride and 1288-word decode staging fit the archive
    assembly and parsing around them."""
    sizes = [0, 1, 4095, 4096, 4097, 12000]
    datas = [make_exponential_bytes(rng, n, 10.0) for n in sizes]
    S = max(sizes)
    buf = np.zeros((len(sizes), S), np.uint8)
    for i, d in enumerate(datas):
        buf[i, : d.size] = d
    comp, nbytes = A.ans_encode_padded(
        jnp.asarray(buf), jnp.asarray(sizes, jnp.int32), 10, True
    )
    for i, d in enumerate(datas):
        assert np.array_equal(
            np.asarray(comp)[i, : int(nbytes[i])], R.ans_encode(d, 10, True)
        )
    out, ok, n, _ = A.ans_decode_padded(comp, S, 10)
    assert np.asarray(ok).all()
    for i, d in enumerate(datas):
        assert np.array_equal(np.asarray(out)[i, : d.size], d)
    names = [c[0] for c in stub_gpu.calls]
    assert names == ["dietgpu_rans_encode", "dietgpu_rans_decode"]


def test_kernel_wrappers_check_shapes(stub_gpu):
    with pytest.raises(ValueError, match="4 KiB blocks"):
        rans_cuda.encode_blocks(
            jnp.zeros((1, 1000), jnp.uint32), jnp.zeros((1,), jnp.int32),
            jnp.zeros((1, 256), jnp.uint32), jnp.zeros((1, 256), jnp.uint32),
            10,
        )
    with pytest.raises(ValueError, match="stride"):
        rans_cuda.decode_blocks(
            jnp.zeros((1, 1, 2000), jnp.uint32), jnp.zeros((1, 1), jnp.int32),
            jnp.zeros((1, 1), jnp.int32), jnp.zeros((1, 1, 32), jnp.uint32),
            jnp.zeros((1, 1024), jnp.uint32), 10,
        )
    assert not stub_gpu.calls


def test_kernel_wrappers_batch_under_vmap(monkeypatch):
    """vmap (as the compressed collectives use it) adds leading dimensions
    to every argument and result of the real ffi_call; the kernels treat
    all leading dimensions as one batch."""
    monkeypatch.setattr(rans_cuda, "_ensure_registered", lambda: None)
    S = jax.ShapeDtypeStruct
    u32, i32 = jnp.uint32, jnp.int32
    enc = jax.vmap(lambda x, s, p, m: rans_cuda.encode_blocks(x, s, p, m, 10))
    got = jax.eval_shape(
        enc, S((3, 2, 2048), u32), S((3, 2), i32), S((3, 2, 256), u32),
        S((3, 2, 256), u32),
    )
    assert [g.shape for g in got] == [
        (3, 2, 2, 32), (3, 2, 2, rans_cuda.STREAM_WORDS32), (3, 2, 2)
    ]
    dec = jax.vmap(
        lambda st, c, u, s0, lut: rans_cuda.decode_blocks(st, c, u, s0, lut, 9)
    )
    got = jax.eval_shape(
        dec, S((3, 2, 2, rans_cuda.DECODE_STAGE_WORDS32), u32),
        S((3, 2, 2), i32), S((3, 2, 2), i32), S((3, 2, 2, 32), u32),
        S((3, 2, 512), u32),
    )
    assert got.shape == (3, 2, 2, 1024)


def test_library_path_tracks_source():
    path = rans_cuda.library_path()
    assert os.path.dirname(path) == os.path.join(
        REPO, "dietgpu_fork_tpu", "ops", "cuda", "build"
    )
    assert os.path.basename(path).startswith("librans_")


# --------------------------------------------------------------------------
# compile cache and chip_smoke's device check
# --------------------------------------------------------------------------


def test_compile_cache_uses_env_dir(monkeypatch, tmp_path):
    from dietgpu_fork_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch):
    from dietgpu_fork_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = compile_cache.enable_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_chip_smoke_device_check_refuses_cpu():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    with pytest.raises(SystemExit) as e:
        chip_smoke.require_gpu(jax.default_backend())
    assert e.value.code != 0
    chip_smoke.require_gpu("gpu")


def test_chip_smoke_exits_nonzero_on_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO,
    )
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


# --------------------------------------------------------------------------
# on the card: kernels against the plain walks
# --------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("prob_bits", [9, 10, 11])
@pytest.mark.parametrize("n", [0, 1, 4095, 4096, 4097])
def test_kernels_match_plain_walks(rng, n, prob_bits):
    enc_args, (uncomp, lut), datas = walk_inputs(rng, [n, 6000], prob_bits)
    got = rans_cuda.encode_blocks(*enc_args, prob_bits)
    want = rans_encode.encode_blocks_plain(*enc_args, prob_bits)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert np.array_equal(np.asarray(g), np.asarray(w))
    states, streams, nw = got
    staged = jnp.pad(streams, ((0, 0), (0, 0), (0, 8)))
    args = (staged, nw, uncomp, states, lut, prob_bits)
    out_k = np.asarray(rans_cuda.decode_blocks(*args))
    out_p = np.asarray(rans_decode.decode_blocks_plain(*args))
    assert np.array_equal(out_k, out_p)
    flat = out_k.view(np.uint8).reshape(2, -1)
    for i, d in enumerate(datas):
        assert np.array_equal(flat[i, : d.size], d)


@pytest.mark.gpu
def test_kernels_match_plain_walks_under_vmap(rng):
    """Two stacked batches through vmap: the kernels flatten the leading
    dimensions into one batch of members."""
    batches = [walk_inputs(rng, sizes, 10) for sizes in ([5000, 7], [1, 8000])]
    enc_args = [jnp.stack(a) for a in zip(*(b[0] for b in batches))]
    enc_k = jax.vmap(lambda *a: rans_cuda.encode_blocks(*a, 10))
    enc_p = jax.vmap(lambda *a: rans_encode.encode_blocks_plain(*a, 10))
    got, want = enc_k(*enc_args), enc_p(*enc_args)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))
    states, streams, nw = got
    staged = jnp.pad(streams, ((0, 0), (0, 0), (0, 0), (0, 8)))
    uncomp = jnp.stack([b[1][0] for b in batches])
    lut = jnp.stack([b[1][1] for b in batches])
    args = (staged, nw, uncomp, states, lut)
    out_k = jax.vmap(lambda *a: rans_cuda.decode_blocks(*a, 10))(*args)
    out_p = jax.vmap(lambda *a: rans_decode.decode_blocks_plain(*a, 10))(*args)
    assert np.array_equal(np.asarray(out_k), np.asarray(out_p))
