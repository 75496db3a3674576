"""PyTorch-protocol benchmark: both reference configurations
(dietgpu/benchmark.py:151-223) — non-batched and large-batch — for
bf16/fp16/fp32 N(0,1) data. Prints the reference's human-readable style:
comp/decomp time, bandwidth, and ratio per configuration.

Usage: python bench/benchmark.py [--floats 16777216] [--batch 128]
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


def rows_of(rng, ft, bs, n):
    x = rng.normal(0, 1, (bs, n))
    if ft == FloatType.FLOAT16:
        w = x.astype(np.float16).view(np.uint16)
        return np.pad(w, ((0, 0), (0, n % 2))).view(np.uint32)
    if ft == FloatType.BFLOAT16:
        w = (x.astype(np.float32).view(np.uint32) >> 16).astype(np.uint16)
        return np.pad(w, ((0, 0), (0, n % 2))).view(np.uint32)
    return x.astype(np.float32).view(np.uint32)


def bench(ft, bs, n, prob_bits=10):
    rng = np.random.default_rng(7)
    ws = FLOAT_WORD_SIZE[ft]
    data32 = jnp.asarray(rows_of(rng, ft, bs, n))
    sizes = jnp.full((bs,), n, jnp.int32)
    raw_gb = bs * n * ws / 1e9

    def enc(d):
        return float_compress_core(
            d, sizes, ft, prob_bits=prob_bits, native=NATIVE
        )

    jenc = jax.jit(enc)
    comp32, comp_bytes = jenc(data32)

    def dec(c):
        return float_decompress_core(
            c, jnp.zeros((bs,), jnp.int32), n, ft, prob_bits=prob_bits,
            native=NATIVE,
        )

    jdec = jax.jit(dec)
    out = jdec(comp32)
    got = np.asarray(out[0]).view(np.uint8)[:, : n * ws]
    exp = np.asarray(data32).view(np.uint8)[:, : n * ws]
    assert np.array_equal(got, exp) and bool(np.all(np.asarray(out[1])))

    t_e = timed(lambda: jenc(data32), repeats=REPEATS) / 1e3
    t_d = timed(lambda: jdec(comp32), repeats=REPEATS) / 1e3
    ratio = int(np.asarray(comp_bytes).sum()) / (bs * n * ws)
    return t_e, t_d, raw_gb, ratio


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--floats", type=int, default=1 << 24)
    ap.add_argument("--batch", type=int, default=128)
    args = ap.parse_args()
    enable_compile_cache()
    print(f"# {gpu_description()}", flush=True)

    names = {
        FloatType.BFLOAT16: "bfloat16",
        FloatType.FLOAT16: "float16",
        FloatType.FLOAT32: "float32",
    }
    for ft, name in names.items():
        for bs, n in [(1, args.floats), (args.batch, args.floats // args.batch)]:
            t_e, t_d, gb, ratio = bench(ft, bs, n)
            print(
                f"{name} bs={bs} x {n} floats: "
                f"comp {t_e*1e3:.2f} ms ({gb/t_e:.2f} GB/s), "
                f"decomp {t_d*1e3:.2f} ms ({gb/t_d:.2f} GB/s), "
                f"ratio {ratio:.4f}",
                flush=True,
            )


if __name__ == "__main__":
    main()
