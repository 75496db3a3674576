#!/usr/bin/env python3
"""End-to-end check that the codec runs on the GPU.

    python chip_smoke.py               # one card, phases 1-7
    python chip_smoke.py --four-cards  # the multi-card path only, 4 cards

One card, one JAX process at a time:

  1. device check: JAX's platform must be "gpu" (exit non-zero otherwise);
     device kind, count, JAX version, and the card's name and power limit
     from nvidia-smi;
  2. build the CUDA rANS kernels and compile each at the widths of phase 4;
  3. each kernel against its plain jax.numpy reference on 64 MiB of bf16
     exponent bytes, prob_bits 9/10/11: integer-exact, with median times;
  4. the public API (compress_data / decompress_data, checksum on) at the
     reference benchmarks' sizes: bit-exact round trips, ratios, device
     times and peak device memory; bf16 1x64Mi also with the plain walks;
  5. classic archives written on the card equal the NumPy oracle's bytes;
  6. row-stream (0xDB0D) and float v2 archives written on the card decode
     bit-exactly;
  7. the gpu-marked tests, in a child pytest that runs before this process
     first touches JAX.

Every phase raises on failure. The last line of stdout is one JSON object,
{"ok": true, "device": {...}}, printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
MiB = 1 << 20

_PROBE = (
    "import json, jax; d = jax.devices(); "
    "print(json.dumps({'platform': d[0].platform, 'kind': d[0].device_kind, "
    "'count': len(d), 'jax': jax.__version__}))"
)


def log(*args) -> None:
    print(*args, flush=True)


def require_gpu(platform: str) -> None:
    """Exit non-zero unless JAX's device platform is the GPU."""
    if platform != "gpu":
        log(f"no GPU: JAX's device platform is {platform!r}")
        raise SystemExit(2)


def card_name_and_power() -> str:
    """`nvidia-smi` name and power limit, read by a child without JAX."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip()


def probe_device() -> dict:
    """Device platform/kind/count from a short-lived child process, so this
    process stays off the card until the child pytest has run."""
    res = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True,
        timeout=300, cwd=HERE,
    )
    if res.returncode != 0:
        log(res.stderr[-2000:])
        raise SystemExit(2)
    return json.loads(res.stdout.strip().splitlines()[-1])


def phase7_gpu_tests() -> None:
    log("== phase 7: gpu-marked tests (child pytest)")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "pytest", os.path.join(HERE, "tests"),
         "-m", "gpu", "-q", "-p", "no:cacheprovider", "-rs"],
        capture_output=True, text=True, cwd=HERE, timeout=900,
    )
    tail = res.stdout.strip().splitlines()[-15:]
    for line in tail:
        log("   ", line)
    if res.returncode != 0:
        log(res.stderr[-3000:])
        raise RuntimeError(f"gpu-marked tests failed (rc {res.returncode})")
    if " skipped" in tail[-1]:
        raise RuntimeError("gpu-marked tests were skipped on the card")
    log(f"   phase 7 took {time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------------------------
# helpers that need JAX (imported only after phase 7's child has exited)
# --------------------------------------------------------------------------


def median_ms(fn, *args, reps: int = 10) -> float:
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(ts)


def peak_bytes() -> int:
    import jax

    return int(jax.devices()[0].memory_stats()["peak_bytes_in_use"])


def bf16_exponent_bytes(rng, n):
    """Bytes drawn from the exponent distribution of N(0,1) bf16 floats."""
    import numpy as np

    x = rng.standard_normal(n, dtype=np.float32)
    return ((x.view(np.uint32) >> 23) & 0xFF).astype(np.uint8)


@contextlib.contextmanager
def plain_walks():
    """Trace the codec with the plain jax.numpy walks in place of the CUDA
    kernels (for the kernel-vs-plain end-to-end timing)."""
    import dietgpu_fork_tpu.models.ans as A
    from dietgpu_fork_tpu.ops.rans_decode import decode_blocks_plain
    from dietgpu_fork_tpu.ops.rans_encode import encode_blocks_plain

    saved = A.encode_blocks, A.decode_blocks
    A.encode_blocks, A.decode_blocks = encode_blocks_plain, decode_blocks_plain
    try:
        yield
    finally:
        A.encode_blocks, A.decode_blocks = saved


def walk_inputs(data, prob_bits):
    """Classic-layout walk inputs for one member of raw bytes."""
    import jax.numpy as jnp
    import numpy as np

    from dietgpu_fork_tpu.ops.histogram import histogram_packed
    from dietgpu_fork_tpu.ops.table import (
        normalize_probs_batched,
        pack_encode_table,
    )

    n = data.size
    nb = -(-n // 4096)
    buf = np.zeros(nb * 4096, np.uint8)
    buf[:n] = data
    x32 = jnp.asarray(buf.view(np.uint32).reshape(1, -1))
    sizes = jnp.array([n], jnp.int32)
    hist = histogram_packed(x32, sizes)
    pdf, cdf, magic, shift = normalize_probs_batched(hist, sizes, prob_bits)
    return x32, sizes, pack_encode_table(pdf, cdf, shift), magic, pdf


# --------------------------------------------------------------------------
# phases 2-6
# --------------------------------------------------------------------------


def phase2_build_and_compile() -> None:
    import jax
    import jax.numpy as jnp

    from dietgpu_fork_tpu.ops import rans_cuda

    log("== phase 2: kernel build and compile")
    t0 = time.perf_counter()
    log(f"   library {rans_cuda.build()} ({time.perf_counter() - t0:.1f} s)")
    # phase 4's bf16 1x64Mi exponent plane: 64 MiB, 16384 blocks
    nb = 64 * MiB // 4096
    u32, i32 = jnp.uint32, jnp.int32
    S = jax.ShapeDtypeStruct
    enc = jax.jit(rans_cuda.encode_blocks, static_argnums=4).lower(
        S((1, nb * 1024), u32), S((1,), i32), S((1, 256), u32),
        S((1, 256), u32), 10,
    ).compile()
    log(f"   encode kernel memory: {enc.memory_analysis()}")
    dec = jax.jit(rans_cuda.decode_blocks, static_argnums=5).lower(
        S((1, nb, rans_cuda.DECODE_STAGE_WORDS32), u32), S((1, nb), i32),
        S((1, nb), i32), S((1, nb, 32), u32), S((1, 1 << 10), u32), 10,
    ).compile()
    log(f"   decode kernel memory: {dec.memory_analysis()}")


def phase3_kernel_vs_plain() -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from dietgpu_fork_tpu.ops import rans_cuda
    from dietgpu_fork_tpu.ops.rans_decode import decode_blocks_plain
    from dietgpu_fork_tpu.ops.rans_encode import encode_blocks_plain
    from dietgpu_fork_tpu.ops.table import build_decode_table_batched

    log("== phase 3: kernels vs plain reference (64 MiB, partial last block)")
    rng = np.random.default_rng(0x5EED)
    n = 64 * MiB - 1000
    data = bf16_exponent_bytes(rng, n)
    enc_k = jax.jit(rans_cuda.encode_blocks, static_argnums=4)
    enc_p = jax.jit(encode_blocks_plain, static_argnums=4)
    dec_k = jax.jit(rans_cuda.decode_blocks, static_argnums=5)
    dec_p = jax.jit(decode_blocks_plain, static_argnums=5)
    times = {}
    for pb in (9, 10, 11):
        x32, sizes, packed, magic, pdf = walk_inputs(data, pb)
        got = enc_k(x32, sizes, packed, magic, pb)
        want = enc_p(x32, sizes, packed, magic, pb)
        for name, a, b in zip(("states", "streams", "num_words"), got, want):
            if a.shape != b.shape or not np.array_equal(
                np.asarray(a), np.asarray(b)
            ):
                raise AssertionError(f"encode {name} differs at pb={pb}")
        states, streams, num_words = got
        nb = num_words.shape[1]
        staged = jnp.pad(streams, ((0, 0), (0, 0), (0, 8)))
        blk = jnp.arange(nb, dtype=jnp.int32)[None, :]
        uncomp = jnp.clip(n - blk * 4096, 0, 4096)
        lut = build_decode_table_batched(pdf, pb)
        dargs = (staged, num_words, uncomp, states, lut, pb)
        out_k = np.asarray(dec_k(*dargs))
        out_p = np.asarray(dec_p(*dargs))
        if not np.array_equal(out_k, out_p):
            raise AssertionError(f"decode output differs at pb={pb}")
        if not np.array_equal(out_k.reshape(-1).view(np.uint8)[:n], data):
            raise AssertionError(f"decode does not restore input at pb={pb}")
        t = {
            "encode_kernel_ms": median_ms(enc_k, x32, sizes, packed, magic, pb),
            "encode_plain_ms": median_ms(enc_p, x32, sizes, packed, magic, pb),
            "decode_kernel_ms": median_ms(dec_k, *dargs),
            "decode_plain_ms": median_ms(dec_p, *dargs),
        }
        times[pb] = t
        words = int(np.asarray(num_words).sum())
        log(f"   pb={pb}: equal; {2 * words / n:.4f} compressed/raw; "
            + ", ".join(f"{k} {v:.3f}" for k, v in t.items()))
    return times


def _float_case(C, FloatType, name, ts, ft, sparse=False, reps=10):
    """Public-API round trip (checksum on) plus device times of the API's
    own jitted compress/decompress on device-resident rows."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from dietgpu_fork_tpu.ops.bitops import bitcast_u8_to_u32

    dtype = C.dtype_of(ft)
    comp, comp_bytes, _ = C.compress_data(True, ts, checksum=True,
                                          sparse=sparse)
    outs, sizes, success, _, _ = C.decompress_data(
        True, comp, [t.size for t in ts], dtype=dtype, checksum=True,
        sparse=sparse,
    )
    if not all(bool(s) for s in success):
        raise AssertionError(f"{name}: success false")
    for o, t in zip(outs, ts):
        if o.shape != t.shape or not np.array_equal(
            o.view(np.uint8), t.view(np.uint8)
        ):
            raise AssertionError(f"{name}: round trip not bit-exact")
    raw = sum(t.nbytes for t in ts)
    ratio = float(np.asarray(comp_bytes).astype(np.int64).sum()) / raw

    data32, n, max_elems = C._float_rows_to_u32(ts, ft)
    cfn = C._jit_sparse_compress if sparse else C._jit_float_compress
    dfn = C._jit_sparse_decompress if sparse else C._jit_float_decompress
    kw = dict(float_type=ft, prob_bits=10, use_checksum=True, native=False)
    comp_ms = median_ms(lambda d: cfn(d, n, **kw), data32, reps=reps)
    m32 = bitcast_u8_to_u32(comp)
    caps = jnp.asarray([t.size for t in ts], jnp.int32)
    dkw = dict(out_floats=max_elems, float_type=ft, prob_bits=10,
               verify_checksum=True, native=False)
    if sparse:
        dec = lambda m: dfn(m, capacities=caps, **dkw)  # noqa: E731
    else:
        zeros = jnp.zeros((len(ts),), jnp.int32)
        dec = lambda m: dfn(m, zeros, capacities=caps, **dkw)  # noqa: E731
    dec_ms = median_ms(dec, m32, reps=reps)
    del comp, m32, data32
    return {"ratio": ratio, "compress_ms": comp_ms, "decompress_ms": dec_ms,
            "compress_gbps": raw / comp_ms / 1e6,
            "decompress_gbps": raw / dec_ms / 1e6}


def _ans_case(C, name, data, reps=10):
    import jax.numpy as jnp
    import numpy as np

    comp, comp_bytes, _ = C.compress_data(False, [data], checksum=True)
    outs, _, success, _, _ = C.decompress_data(
        False, comp, [data.size], checksum=True
    )
    if not bool(success[0]) or not np.array_equal(outs[0], data):
        raise AssertionError(f"{name}: round trip not bit-exact")
    buf, sizes = C._pack_byte_rows([data], data.size)
    buf, sizes = jnp.asarray(buf), jnp.asarray(sizes)
    comp_ms = median_ms(
        lambda b: C._jit_ans_encode(b, sizes, prob_bits=10, use_checksum=True,
                                    native=False), buf, reps=reps)
    caps = jnp.asarray([data.size], jnp.int32)
    dec_ms = median_ms(
        lambda m: C._jit_ans_decode(m, out_capacity=data.size, prob_bits=10,
                                    capacities=caps, native=False),
        comp, reps=reps)
    return {"ratio": int(np.asarray(comp_bytes)[0]) / data.size,
            "compress_ms": comp_ms, "decompress_ms": dec_ms,
            "compress_gbps": data.size / comp_ms / 1e6,
            "decompress_gbps": data.size / dec_ms / 1e6}


def _kernel_vs_plain_e2e(ts, reps=10):
    """bf16 1x64Mi compress and decompress with the CUDA walks and with the
    plain walks, in turns (kernel, plain, plain, kernel)."""
    import jax
    import jax.numpy as jnp

    import dietgpu_fork_tpu.api.codec as C
    from dietgpu_fork_tpu.core.constants import FloatType
    from dietgpu_fork_tpu.models.float_codec import (
        float_compress_padded,
        float_decompress_core,
    )
    from dietgpu_fork_tpu.ops.bitops import bitcast_u8_to_u32

    ft = FloatType.BFLOAT16
    data32, n, max_elems = C._float_rows_to_u32(ts, ft)
    zeros = jnp.zeros((1,), jnp.int32)

    def variant(plain):
        # fresh functions, so each variant is traced with its own walks
        def comp(d):
            return float_compress_padded(d, n, ft, 10, True)

        def dec(m):
            return float_decompress_core(m, zeros, max_elems, ft, 10,
                                         verify_checksum=True)

        cj, dj = jax.jit(comp), jax.jit(dec)
        with plain_walks() if plain else contextlib.nullcontext():
            c, _ = cj(data32)
            m32 = bitcast_u8_to_u32(c)
            out, ok, _, ca, cg = dj(m32)
        if not (bool(ok[0]) and int(ca[0]) == int(cg[0])):
            raise AssertionError(f"bf16 64Mi plain={plain}: decode failed")
        return cj, dj, m32

    kc, kd, km = variant(False)
    pc, pd, pm = variant(True)
    if not bool(jnp.array_equal(km, pm)):
        raise AssertionError("kernel and plain archives differ")
    res = {"compress_kernel_ms": [], "compress_plain_ms": [],
           "decompress_kernel_ms": [], "decompress_plain_ms": []}
    for plain in (False, True, True, False):
        tag = "plain" if plain else "kernel"
        c, d, m = (pc, pd, pm) if plain else (kc, kd, km)
        res[f"compress_{tag}_ms"].append(median_ms(c, data32, reps=reps))
        res[f"decompress_{tag}_ms"].append(median_ms(d, m, reps=reps))
    return res


def phase4_public_api() -> dict:
    import numpy as np
    import ml_dtypes

    import dietgpu_fork_tpu.api.codec as C
    from dietgpu_fork_tpu.core.constants import FloatType

    log("== phase 4: public API round trips (checksum on)")
    rng = np.random.default_rng(0xD1E7)
    bf16 = ml_dtypes.bfloat16
    results = {}

    def run(name, fn):
        t0 = time.perf_counter()
        r = fn()
        r["peak_bytes_in_use"] = peak_bytes()
        r["wall_s"] = time.perf_counter() - t0
        results[name] = r
        log(f"   {name}: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in r.items()))

    big = [rng.standard_normal(64 * MiB, dtype=np.float32).astype(bf16)]
    run("bf16 1x64Mi",
        lambda: _float_case(C, FloatType, "bf16 1x64Mi", big,
                            FloatType.BFLOAT16))
    e2e = _kernel_vs_plain_e2e(big)
    results["bf16 1x64Mi kernel vs plain"] = e2e
    log("   bf16 1x64Mi kernel vs plain (kernel, plain, plain, kernel): "
        + ", ".join(f"{k} {['%.3f' % x for x in v]}" for k, v in e2e.items()))
    del big

    base = [rng.standard_normal(512 * 1024, dtype=np.float32).astype(bf16)
            for _ in range(8)]
    run("bf16 128x512Ki",
        lambda: _float_case(C, FloatType, "bf16 128x512Ki", base * 16,
                            FloatType.BFLOAT16))
    run("fp16 1x16Mi",
        lambda: _float_case(
            C, FloatType, "fp16 1x16Mi",
            [rng.standard_normal(16 * MiB, dtype=np.float32).astype(
                np.float16)], FloatType.FLOAT16))
    run("fp32 1x16Mi",
        lambda: _float_case(
            C, FloatType, "fp32 1x16Mi",
            [rng.standard_normal(16 * MiB, dtype=np.float32)],
            FloatType.FLOAT32))
    run("fp64 1x100M",
        lambda: _float_case(
            C, FloatType, "fp64 1x100M", [rng.standard_normal(100_000_000)],
            FloatType.FLOAT64, reps=5))
    run("raw ANS 1x64MiB",
        lambda: _ans_case(C, "raw ANS 1x64MiB",
                          bf16_exponent_bytes(rng, 64 * MiB)))

    def sparse():
        ts = []
        for _ in range(3):
            x = rng.standard_normal(15_000_000, dtype=np.float32)
            x[rng.random(x.size) < 0.5] = 0.0
            ts.append(x)
        return _float_case(C, FloatType, "sparse fp32 3x15M", ts,
                           FloatType.FLOAT32, sparse=True, reps=5)

    run("sparse fp32 3x15M 50% zeros", sparse)
    return results


def phase5_oracle() -> None:
    import numpy as np

    import dietgpu_fork_tpu.api.codec as C
    from dietgpu_fork_tpu.core import reference as R
    from dietgpu_fork_tpu.core.constants import FloatType

    log("== phase 5: classic archives vs the NumPy oracle")
    rng = np.random.default_rng(0x0AC1E)
    w = (rng.standard_normal(MiB, dtype=np.float32).view(np.uint32)
         >> 16).astype(np.uint16)
    import ml_dtypes

    comp, nbytes, _ = C.compress_data(
        True, [w.view(ml_dtypes.bfloat16)], checksum=True, native=False)
    got = np.asarray(comp)[0, : int(np.asarray(nbytes)[0])]
    want = R.float_compress(w, FloatType.BFLOAT16, 10, use_checksum=True)
    if not np.array_equal(got, want):
        raise AssertionError("bf16 1Mi archive differs from the oracle")
    d = bf16_exponent_bytes(rng, MiB)
    comp, nbytes, _ = C.compress_data(False, [d], checksum=True, native=False)
    got = np.asarray(comp)[0, : int(np.asarray(nbytes)[0])]
    if not np.array_equal(got, R.ans_encode(d, 10, True)):
        raise AssertionError("raw 1 MiB archive differs from the oracle")
    log(f"   bf16 1Mi ({want.size} B) and raw 1 MiB ({got.size} B) "
        "archives equal the oracle byte for byte")


def phase6_other_layouts() -> None:
    import ml_dtypes
    import numpy as np

    import dietgpu_fork_tpu.api.codec as C
    from dietgpu_fork_tpu.core import reference as R
    from dietgpu_fork_tpu.core.constants import FLOAT_ALIGN_MIN, FloatType

    log("== phase 6: row-stream and v2 archives written on the card")
    rng = np.random.default_rng(0xDB0D)
    n = FLOAT_ALIGN_MIN + 12345  # the v2 container's threshold is 2^20
    t = rng.standard_normal(n, dtype=np.float32).astype(ml_dtypes.bfloat16)
    comp, nbytes, _ = C.compress_data(True, [t], checksum=True, native=True)
    arc = np.asarray(comp)[0, : int(np.asarray(nbytes)[0])]
    if arc[:4].view(np.uint32)[0] != (0xF00F << 16) | 2:
        raise AssertionError("float archive is not the v2 container")
    want = R.float_compress(t.view(np.uint16), FloatType.BFLOAT16, 10,
                            use_checksum=True, native=True)
    if not np.array_equal(arc, want):
        raise AssertionError("v2 archive differs from the oracle")
    outs, _, ok, _, _ = C.decompress_data(
        True, comp, [n], dtype=ml_dtypes.bfloat16, checksum=True)
    if not (bool(ok[0]) and np.array_equal(outs[0].view(np.uint16),
                                           t.view(np.uint16))):
        raise AssertionError("v2 archive does not decode bit-exactly")
    d = bf16_exponent_bytes(rng, MiB + 7)
    comp, nbytes, _ = C.compress_data(False, [d], checksum=True, native=True)
    arc = np.asarray(comp)[0, : int(np.asarray(nbytes)[0])]
    if arc[:4].view(np.uint32)[0] >> 16 != 0xDB0D:
        raise AssertionError("raw archive is not row-stream")
    outs, _, ok, _, _ = C.decompress_data(False, comp, [d.size],
                                          checksum=True)
    if not (bool(ok[0]) and np.array_equal(outs[0], d)):
        raise AssertionError("row-stream archive does not decode bit-exactly")
    log("   v2 bf16 and row-stream raw archives decode bit-exactly")


# --------------------------------------------------------------------------
# four cards
# --------------------------------------------------------------------------


def four_cards() -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from dietgpu_fork_tpu.core.constants import FloatType
    from dietgpu_fork_tpu.parallel import collectives as coll
    from dietgpu_fork_tpu.parallel import sharded as sh

    ndev = len(jax.devices())
    if ndev != 4:
        raise RuntimeError(f"--four-cards needs 4 devices, found {ndev}")
    mesh = sh.data_mesh()
    log(f"== four cards: 1-D mesh {mesh.shape} over {mesh.devices.tolist()}")
    rng = np.random.default_rng(0x4CA)

    def spread(a):
        devs = {s.device for s in a.addressable_shards}
        if len(devs) != ndev:
            raise AssertionError(f"result lives on {len(devs)} device(s)")

    def wall_ms(fn, *args, reps=5):
        return median_ms(fn, *args, reps=reps)

    res = {}
    # sharded codec: 64 MiB of bf16 per card (one 32Mi-float member each)
    n = 32 * MiB
    w = (rng.standard_normal((ndev, n), dtype=np.float32).view(np.uint32)
         >> 16).astype(np.uint16)
    data32 = sh.shard_batch(mesh, jnp.asarray(w.view(np.uint32)))
    sizes = sh.shard_batch(mesh, jnp.full((ndev,), n, jnp.int32))
    comp_fn = jax.jit(lambda d, s: sh.float_compress_sharded(
        mesh, d, s, FloatType.BFLOAT16))
    comp, cbytes = comp_fn(data32, sizes)
    spread(comp)
    dec_fn = jax.jit(lambda c: sh.float_decompress_sharded(
        mesh, c, n, FloatType.BFLOAT16))
    out32, ok, _, _, _ = dec_fn(comp)
    spread(out32)
    if not bool(jnp.all(ok)) or not np.array_equal(
        np.asarray(out32).view(np.uint16)[:, :n], w
    ):
        raise AssertionError("sharded codec round trip not bit-exact")
    res["sharded_compress_ms"] = wall_ms(comp_fn, data32, sizes)
    res["sharded_decompress_ms"] = wall_ms(dec_fn, comp)
    res["sharded_ratio"] = float(np.asarray(cbytes).sum()) / w.nbytes

    # compressed all-gather vs lax.all_gather on the same shards
    x = jax.device_put(
        jnp.asarray(rng.standard_normal((ndev, n), dtype=np.float32),
                    jnp.bfloat16),
        NamedSharding(mesh, P("data")),
    )
    cag = jax.jit(lambda v: coll.compressed_all_gather(v, mesh))
    ref_ag = jax.jit(sh.shard_map(
        lambda v: jax.lax.all_gather(v, "data", tiled=True), mesh=mesh,
        in_specs=(P("data"),), out_specs=P(None)))
    got, good = cag(x)
    want = ref_ag(x)
    if not bool(jnp.all(good)) or not np.array_equal(
        np.asarray(got).view(np.uint16), np.asarray(want).view(np.uint16)
    ):
        raise AssertionError("compressed all-gather != lax.all_gather")
    res["all_gather_compressed_ms"] = wall_ms(cag, x)
    res["all_gather_lax_ms"] = wall_ms(ref_ag, x)

    # reduce-scatter / all-reduce on 64 MiB fp32 buckets per card
    m = 16 * MiB
    xr = jax.device_put(
        jnp.asarray(rng.standard_normal((ndev, m), dtype=np.float32)),
        NamedSharding(mesh, P("data")),
    )
    crs = jax.jit(lambda v: coll.compressed_reduce_scatter(v, mesh))
    ref_rs = jax.jit(sh.shard_map(
        lambda v: jax.lax.psum_scatter(
            v.reshape(ndev, m // ndev), "data", scatter_dimension=0,
            tiled=True),
        mesh=mesh, in_specs=(P("data"),), out_specs=P("data")))
    got, good = crs(xr)
    spread(got)
    want = ref_rs(xr)
    if not bool(jnp.all(good)) or not np.allclose(
        np.asarray(got).reshape(-1), np.asarray(want).reshape(-1),
        rtol=1e-5, atol=1e-5,
    ):
        raise AssertionError("compressed reduce-scatter != psum_scatter")
    res["reduce_scatter_compressed_ms"] = wall_ms(crs, xr)
    res["reduce_scatter_lax_ms"] = wall_ms(ref_rs, xr)

    car = jax.jit(lambda v: coll.compressed_all_reduce(v, mesh))
    ref_ar = jax.jit(sh.shard_map(
        lambda v: jax.lax.psum(v, "data"), mesh=mesh,
        in_specs=(P("data"),), out_specs=P("data")))
    got, good = car(xr)
    spread(got)
    want = ref_ar(xr)
    if not bool(jnp.all(good)) or not np.allclose(
        np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-5
    ):
        raise AssertionError("compressed all-reduce != psum")
    res["all_reduce_compressed_ms"] = wall_ms(car, xr)
    res["all_reduce_lax_ms"] = wall_ms(ref_ar, xr)
    for k, v in res.items():
        log(f"   {k}: {v:.4f}")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-card path (needs 4 GPUs)")
    args = ap.parse_args()
    t_start = time.perf_counter()

    log("== phase 1: device check")
    dev = probe_device()
    require_gpu(dev["platform"])
    card = card_name_and_power()
    log(f"   nvidia-smi: {card}")

    if not args.four_cards:
        phase7_gpu_tests()

    import jax

    sys.path.insert(0, HERE)
    from dietgpu_fork_tpu.utils.compile_cache import enable_compile_cache

    log(f"   compile cache: {enable_compile_cache()}")
    devices = jax.devices()
    require_gpu(devices[0].platform)
    kind, count = devices[0].device_kind, len(devices)
    log(f"   platform gpu, device_kind {kind!r}, count {count}, "
        f"jax {jax.__version__}")

    if args.four_cards:
        four_cards()
    else:
        phase2_build_and_compile()
        phase3_kernel_vs_plain()
        phase4_public_api()
        phase5_oracle()
        phase6_other_layouts()
    log(f"card: {card}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
