"""Headline benchmark: bf16 float codec round trip on one GPU.

Protocol mirrors the reference's benchmark.py (N(0,1) data, warm-up, then
timed runs) on its non-batched configuration, in the classic archive layout
(0xD00D, byte-identical to the CUDA reference). Each stage is timed as the
median over REPEATS calls, each ended by block_until_ready. Refuses to run
on anything but the GPU. The device (platform, device_kind, count, and the
card's name and power limit from nvidia-smi) goes to stderr; stdout gets
exactly ONE JSON line:

  {"metric": "float_bf16_codec_geomean_gbps", "value": <geomean of
   compress/decompress GB/s>, "unit": "GB/s", "vs_baseline": <value / 250>}

Baseline: the reference reports ~250-600 GB/s for the float codec on an
A100 (README.md:36); vs_baseline is measured against the 250 GB/s low end.
"""

import json
import sys

import numpy as np

import jax
import jax.numpy as jnp

from dietgpu_fork_tpu.core.constants import FloatType
from dietgpu_fork_tpu.models.float_codec import (
    float_compress_core,
    float_decompress_core,
)
from dietgpu_fork_tpu.utils.compile_cache import enable_compile_cache
from dietgpu_fork_tpu.utils.profiling import gpu_description, timed

N_FLOATS = 1 << 24  # 16Mi bf16 floats = 32 MiB
REPEATS = 20
NATIVE = False  # classic archive layout (what the GPU writes by default)


def main():
    enable_compile_cache()
    print(gpu_description(), file=sys.stderr)
    rng = np.random.default_rng(0)
    w = (
        rng.normal(0, 1, N_FLOATS).astype(np.float32).view(np.uint32) >> 16
    ).astype(np.uint16)
    data32 = jnp.asarray(w.view(np.uint32).reshape(1, -1))
    sizes = jnp.array([N_FLOATS], jnp.int32)
    raw_gb = 2 * N_FLOATS / 1e9

    enc = jax.jit(lambda d: float_compress_core(
        d, sizes, FloatType.BFLOAT16, prob_bits=10, native=NATIVE))
    dec = jax.jit(lambda c: float_decompress_core(
        c, jnp.zeros((1,), jnp.int32), N_FLOATS, FloatType.BFLOAT16,
        prob_bits=10, native=NATIVE))

    comp32, comp_bytes = enc(data32)
    t_enc = timed(lambda: enc(data32), repeats=REPEATS) / 1e3
    t_dec = timed(lambda: dec(comp32), repeats=REPEATS) / 1e3
    ratio = int(np.asarray(comp_bytes)[0]) / (2 * N_FLOATS)

    # round-trip correctness gate: a fast wrong codec scores zero
    out = dec(comp32)
    ok = np.array_equal(
        np.asarray(out[0]).view(np.uint8)[0, : 2 * N_FLOATS], w.view(np.uint8)
    ) and bool(np.asarray(out[1])[0])

    comp_bw = raw_gb / t_enc
    decomp_bw = raw_gb / t_dec
    geo = float(np.sqrt(comp_bw * decomp_bw)) if ok else 0.0

    print(
        f"bf16 {N_FLOATS} floats (native={NATIVE}): compress "
        f"{1e3 * t_enc:.3f} ms ({comp_bw:.2f} GB/s), decompress "
        f"{1e3 * t_dec:.3f} ms ({decomp_bw:.2f} GB/s), medians of {REPEATS}; "
        f"ratio {ratio:.4f}, roundtrip={ok}",
        file=sys.stderr,
    )
    print(
        json.dumps(
            {
                "metric": "float_bf16_codec_geomean_gbps",
                "value": round(geo, 3),
                "unit": "GB/s",
                "vs_baseline": round(geo / 250.0, 5),
            }
        )
    )


if __name__ == "__main__":
    main()
