"""Dense float codec sweep, CSV-compatible with the reference's C++
float_benchmark (float/FloatBenchmark.cu:402-428).

CSV columns: float_type, prob_bits, million_floats, ratio,
comp_bandwidth_gbps, decomp_bandwidth_gbps
(the reference writes ratio but omits it from its header row; we include
it). N(0,1) data, batch size 1, probBits 9, round-trip asserted.

Usage: python bench/float_benchmark.py [--sizes 0.1,1,10,50] [--probbits 9]
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
from dietgpu_fork_tpu.models.float_codec import (
    float_compress_core,
    float_decompress_core,
)

NATIVE = False  # classic archive layout (what the GPU writes by default)
REPEATS = 10  # timed calls per stage; the median is reported


def words_of(rng, ft, n):
    x = rng.normal(0, 1, n)
    if ft == FloatType.FLOAT16:
        w = x.astype(np.float16).view(np.uint16)
        return np.pad(w, (0, n % 2)).view(np.uint32)
    if ft == FloatType.BFLOAT16:
        w = (x.astype(np.float32).view(np.uint32) >> 16).astype(np.uint16)
        return np.pad(w, (0, n % 2)).view(np.uint32)
    if ft == FloatType.FLOAT32:
        return x.astype(np.float32).view(np.uint32)
    return x.astype(np.float64).view(np.uint32)


def bench_one(ft, n, prob_bits):
    rng = np.random.default_rng(1234)
    ws = FLOAT_WORD_SIZE[ft]
    data32 = jnp.asarray(words_of(rng, ft, n).reshape(1, -1))
    sizes = jnp.array([n], jnp.int32)
    raw_gb = n * ws / 1e9

    def enc(d):
        return float_compress_core(
            d, sizes, ft, prob_bits=prob_bits, native=NATIVE
        )

    jenc = jax.jit(enc)
    comp32, comp_bytes = jenc(data32)

    def dec(c):
        return float_decompress_core(
            c, jnp.zeros((1,), jnp.int32), n, ft, prob_bits=prob_bits,
            native=NATIVE,
        )

    jdec = jax.jit(dec)
    out = jdec(comp32)
    got = np.asarray(out[0]).view(np.uint8)[0, : n * ws]
    exp = np.asarray(data32).view(np.uint8)[0, : n * ws]
    assert np.array_equal(got, exp), f"round-trip failed ft={ft} n={n}"
    assert bool(np.asarray(out[1])[0])

    t_enc = timed(lambda: jenc(data32), repeats=REPEATS) / 1e3
    t_dec = timed(lambda: jdec(comp32), repeats=REPEATS) / 1e3
    ratio = int(np.asarray(comp_bytes)[0]) / (n * ws)
    return ratio, raw_gb / t_enc, raw_gb / t_dec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="0.1,1,10,50")
    ap.add_argument("--probbits", type=int, default=9)
    ap.add_argument(
        "--types", default="float16,bfloat16,float32,float64"
    )
    args = ap.parse_args()
    enable_compile_cache()
    print(f"# {gpu_description()}", flush=True)
    sizes = [float(s) for s in args.sizes.split(",")]
    names = {
        "float16": FloatType.FLOAT16, "bfloat16": FloatType.BFLOAT16,
        "float32": FloatType.FLOAT32, "float64": FloatType.FLOAT64,
    }
    fts = [names[t] for t in args.types.split(",")]

    print(
        "float_type,prob_bits,million_floats,ratio,"
        "comp_bandwidth_gbps,decomp_bandwidth_gbps"
    )
    for ft in fts:
        for mf in sizes:
            n = int(mf * 1e6)
            ratio, cbw, dbw = bench_one(ft, n, args.probbits)
            print(
                f"{ft.name.lower()},{args.probbits},{mf},"
                f"{ratio:.4f},{cbw:.3f},{dbw:.3f}",
                flush=True,
            )


if __name__ == "__main__":
    main()
