"""Batched XOR checksum over masked byte rows.

The reference checksum is the XOR of all input bytes, computed with
vectorized uint32 loads and a final byte-fold (GpuChecksum.cuh:26-93); the
fold makes it exactly equal to a byte-wise XOR reduction, which is how we
compute it — one masked XOR-tree reduction per batch member, a
memory-bound op.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

U32 = jnp.uint32


def checksum_batched(data_u8: jax.Array, sizes: jax.Array) -> jax.Array:
    """data_u8: uint8[B, S]; sizes: int32[B] valid byte counts.
    Returns uint32[B] checksums (values in [0, 255])."""
    B, S = data_u8.shape
    pos = jnp.arange(S, dtype=jnp.int32)
    masked = jnp.where(pos[None, :] < sizes[:, None].astype(jnp.int32),
                       data_u8, jnp.uint8(0))
    return jax.lax.reduce(
        masked.astype(U32), U32(0), jax.lax.bitwise_xor, (1,)
    )


def _byte_mask32(nbytes_from_here: jax.Array) -> jax.Array:
    """uint32 mask keeping the first clip(n, 0, 4) little-endian bytes."""
    c = jnp.clip(nbytes_from_here, 0, 4).astype(U32)
    return jnp.where(
        c >= 4, U32(0xFFFFFFFF), (U32(1) << (U32(8) * c)) - U32(1)
    )


def mask_packed_bytes(x32: jax.Array, nbytes: jax.Array) -> jax.Array:
    """Zero all bytes at positions >= nbytes[b] of uint32-packed rows."""
    W = x32.shape[1]
    wpos = jnp.arange(W, dtype=jnp.int32)[None, :]
    return x32 & _byte_mask32(nbytes.astype(jnp.int32)[:, None] - 4 * wpos)


def checksum_packed(data32: jax.Array, nbytes: jax.Array) -> jax.Array:
    """XOR byte checksum of uint32-packed rows, entirely in 32-bit lanes:
    XOR all (masked) words, then fold the four byte positions."""
    w = jax.lax.reduce(
        mask_packed_bytes(data32.astype(U32), nbytes),
        U32(0), jax.lax.bitwise_xor, (1,),
    )
    w = w ^ (w >> U32(16))
    return (w ^ (w >> U32(8))) & U32(0xFF)
