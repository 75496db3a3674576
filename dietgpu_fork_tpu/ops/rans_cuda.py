"""CUDA rANS block walks (ops/cuda/rans.cu) bound to JAX through the FFI.

``encode_blocks`` and ``decode_blocks`` have the exact contracts of the
plain functions in ops/rans_encode.py and ops/rans_decode.py, which call
them when JAX's default backend is the GPU. There is no fallback: a GPU
process that cannot build or load the library raises.

The library is built from the committed source with ``nvcc`` at first use,
into ``ops/cuda/build/`` (listed in .gitignore), under a file lock so
concurrent processes build it once. To build ahead of time::

    python -m dietgpu_fork_tpu.ops.rans_cuda
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..core.constants import BLOCK_SIZE, WARP_SIZE, raw_comp_block_max_size

I32 = jnp.int32
U32 = jnp.uint32

_SRC_DIR = os.path.join(os.path.dirname(__file__), "cuda")
_SRC = os.path.join(_SRC_DIR, "rans.cu")
_BUILD_DIR = os.path.join(_SRC_DIR, "build")
_ENCODE = "dietgpu_rans_encode"
_DECODE = "dietgpu_rans_decode"

STREAM_WORDS32 = raw_comp_block_max_size(BLOCK_SIZE) // 4  # 1280
DECODE_STAGE_WORDS32 = STREAM_WORDS32 + 8  # kStageWords32 in rans.cu

_lock = threading.Lock()
_registered = False


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the GPU rANS "
            "kernels are built from ops/cuda/rans.cu at first use"
        )
    return path


def library_path() -> str:
    """Path of the shared library for the current source (content hash in
    the name, so an edited source never loads a stale build)."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"librans_{digest}.so")


def build() -> str:
    """Compile rans.cu for sm_90a if this source has no library yet.
    Returns the library path."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(so):
            return so
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [
            _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-I", jax.ffi.include_dir(), "-o", tmp, _SRC,
        ]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}):\n{res.stderr[-4000:]}"
            )
        os.replace(tmp, so)
    return so


def _ensure_registered() -> None:
    global _registered
    with _lock:
        if _registered:
            return
        lib = ctypes.cdll.LoadLibrary(build())
        jax.ffi.register_ffi_target(
            _ENCODE, jax.ffi.pycapsule(lib.DietgpuRansEncode),
            platform="CUDA",
        )
        jax.ffi.register_ffi_target(
            _DECODE, jax.ffi.pycapsule(lib.DietgpuRansDecode),
            platform="CUDA",
        )
        _registered = True


def _ffi(name: str, result_shapes):
    # every argument and result leads with the batch of members, which the
    # kernels treat as one flat batch: vmap just adds leading dimensions
    return jax.ffi.ffi_call(name, result_shapes, vmap_method="broadcast_all")


def encode_blocks(
    x32: jax.Array,
    sizes: jax.Array,
    packed_table: jax.Array,
    magic_table: jax.Array,
    prob_bits: int,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Kernel twin of ops.rans_encode.encode_blocks (classic layout):
    x32 uint32[B, NB*1024] -> (states uint32[B, NB, 32], streams32
    uint32[B, NB, 1280] zero past each block's words, num_words
    int32[B, NB])."""
    _ensure_registered()
    B, W = x32.shape
    if W % (BLOCK_SIZE // 4):
        raise ValueError(f"row of {W} words is not whole 4 KiB blocks")
    NB = W // (BLOCK_SIZE // 4)
    out = (
        jax.ShapeDtypeStruct((B, NB, WARP_SIZE), U32),
        jax.ShapeDtypeStruct((B, NB, STREAM_WORDS32), U32),
        jax.ShapeDtypeStruct((B, NB), I32),
    )
    states, streams32, num_words = _ffi(_ENCODE, out)(
        x32.astype(U32), sizes.astype(I32), packed_table.astype(U32),
        magic_table.astype(U32), prob_bits=np.int32(prob_bits),
    )
    return states, streams32, num_words


def decode_blocks(
    streams32: jax.Array,
    comp_words: jax.Array,
    uncomp_words: jax.Array,
    states: jax.Array,
    lut: jax.Array,
    prob_bits: int,
) -> jax.Array:
    """Kernel twin of ops.rans_decode.decode_blocks: start-aligned staged
    streams uint32[B, NB, SW <= 1288] -> uint32[B, NB, 1024] packed decoded
    bytes, zero past each block's byte count."""
    _ensure_registered()
    B, NB, SW = streams32.shape
    if SW > DECODE_STAGE_WORDS32:
        raise ValueError(f"stream stride {SW} > {DECODE_STAGE_WORDS32}")
    out = jax.ShapeDtypeStruct((B, NB, BLOCK_SIZE // 4), U32)
    return _ffi(_DECODE, out)(
        streams32.astype(U32), comp_words.astype(I32),
        uncomp_words.astype(I32), states.astype(U32), lut.astype(U32),
        prob_bits=np.int32(prob_bits),
    )


if __name__ == "__main__":
    print(build())
