"""Sparse float codec sweep, CSV-compatible with the reference's
sparse_float_benchmark (float/SparseFloatBenchmark.cu:421-449).

CSV columns: float_type, prob_bits, num_batches, million_floats, sparsity,
comp_bandwidth_gbps, decomp_bandwidth_gbps. 50% exact zeros over N(0,1),
probBits 9, round-trip asserted.

Usage: python bench/sparse_float_benchmark.py [--sizes 0.1,1,15]
       [--batches 1,3,5]
"""

import argparse
import sys

import numpy as np

import jax
import jax.numpy as jnp

sys.path.insert(0, ".")

from dietgpu_fork_tpu.core.constants import FLOAT_WORD_SIZE, FloatType
from dietgpu_fork_tpu.utils.compile_cache import enable_compile_cache
from dietgpu_fork_tpu.utils.profiling import gpu_description, timed
from dietgpu_fork_tpu.models.sparse import (
    sparse_float_compress_core,
    sparse_float_decompress_core,
)

NATIVE = False  # classic archive layout (what the GPU writes by default)
REPEATS = 10  # timed calls per stage; the median is reported


def sparse_words(rng, ft, n, sparsity=0.5):
    x = rng.normal(0, 1, n)
    x[rng.random(n) < sparsity] = 0.0
    if ft == FloatType.FLOAT16:
        w = x.astype(np.float16).view(np.uint16)
        return np.pad(w, (0, n % 2)).view(np.uint32)
    if ft == FloatType.BFLOAT16:
        w = (x.astype(np.float32).view(np.uint32) >> 16).astype(np.uint16)
        return np.pad(w, (0, n % 2)).view(np.uint32)
    if ft == FloatType.FLOAT32:
        return x.astype(np.float32).view(np.uint32)
    return x.astype(np.float64).view(np.uint32)


def bench_one(ft, n, bs, prob_bits, sparsity=0.5):
    rng = np.random.default_rng(99)
    ws = FLOAT_WORD_SIZE[ft]
    rows = [sparse_words(rng, ft, n, sparsity) for _ in range(bs)]
    data32 = jnp.asarray(np.stack(rows))
    sizes = jnp.full((bs,), n, jnp.int32)
    raw_gb = bs * n * ws / 1e9

    def enc(d):
        return sparse_float_compress_core(
            d, sizes, ft, prob_bits=prob_bits, native=NATIVE
        )

    jenc = jax.jit(enc)
    comp32, comp_bytes = jenc(data32)

    def dec(c):
        return sparse_float_decompress_core(
            c, n, ft, prob_bits=prob_bits, native=NATIVE
        )

    jdec = jax.jit(dec)
    out = jdec(comp32)
    got = np.asarray(out[0]).view(np.uint8)[:, : n * ws]
    exp = np.asarray(data32).view(np.uint8)[:, : n * ws]
    assert np.array_equal(got, exp), f"sparse round-trip failed {ft} {n}"

    t_enc = timed(lambda: jenc(data32), repeats=REPEATS) / 1e3
    t_dec = timed(lambda: jdec(comp32), repeats=REPEATS) / 1e3
    return raw_gb / t_enc, raw_gb / t_dec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="0.1,1,15")
    ap.add_argument("--batches", default="1,3,5")
    ap.add_argument("--probbits", type=int, default=9)
    ap.add_argument(
        "--types", default="float16,bfloat16,float32,float64"
    )
    args = ap.parse_args()
    enable_compile_cache()
    print(f"# {gpu_description()}", flush=True)
    names = {
        "float16": FloatType.FLOAT16, "bfloat16": FloatType.BFLOAT16,
        "float32": FloatType.FLOAT32, "float64": FloatType.FLOAT64,
    }

    print(
        "float_type,prob_bits,num_batches,million_floats,sparsity,"
        "comp_bandwidth_gbps,decomp_bandwidth_gbps"
    )
    # type-innermost: a sweep cut short still covers every dtype for the
    # configurations it reached
    for bs in [int(b) for b in args.batches.split(",")]:
        for mf in [float(s) for s in args.sizes.split(",")]:
            for ft in [names[t] for t in args.types.split(",")]:
                n = int(mf * 1e6)
                cbw, dbw = bench_one(ft, n, bs, args.probbits)
                print(
                    f"{ft.name.lower()},{args.probbits},{bs},{mf},0.5,"
                    f"{cbw:.3f},{dbw:.3f}",
                    flush=True,
                )


if __name__ == "__main__":
    main()
