"""Integer bit-manipulation primitives for the codec, in jnp.

The CUDA reference uses PTX intrinsics (__umulhi, __clz, funnel-shift rotates
— utils/PtxUtils.cuh). JAX runs with 64-bit types off by default, so the
wide operations are built from 16/32-bit ops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

U32 = jnp.uint32
U16 = jnp.uint16


def u32(x):
    return jnp.asarray(x, U32)


def umulhi(a: jax.Array, b: jax.Array) -> jax.Array:
    """High 32 bits of the 64-bit product of two uint32 arrays.

    Decomposed into 16-bit partial products so it needs no 64-bit type
    (replaces PTX __umulhi; reference use: GpuANSEncode.cuh:79).
    """
    a = a.astype(U32)
    b = b.astype(U32)
    a_lo = a & u32(0xFFFF)
    a_hi = a >> u32(16)
    b_lo = b & u32(0xFFFF)
    b_hi = b >> u32(16)

    lo = a_lo * b_lo
    m1 = a_lo * b_hi
    m2 = a_hi * b_lo
    hi = a_hi * b_hi

    # carry-correct accumulation of the middle partials
    t = (lo >> u32(16)) + (m1 & u32(0xFFFF)) + (m2 & u32(0xFFFF))
    return hi + (m1 >> u32(16)) + (m2 >> u32(16)) + (t >> u32(16))


def clz32(x: jax.Array) -> jax.Array:
    """Count leading zeros of uint32 (clz(0) == 32)."""
    return jax.lax.clz(x.astype(U32)).astype(U32)


def rotl16(x: jax.Array, k: int) -> jax.Array:
    x = x.astype(U16)
    return (x << U16(k)) | (x >> U16(16 - k))


def rotr16(x: jax.Array, k: int) -> jax.Array:
    x = x.astype(U16)
    return (x >> U16(k)) | (x << U16(16 - k))


def rotl32(x: jax.Array, k: int) -> jax.Array:
    x = x.astype(U32)
    return (x << u32(k)) | (x >> u32(32 - k))


def rotr32(x: jax.Array, k: int) -> jax.Array:
    x = x.astype(U32)
    return (x >> u32(k)) | (x << u32(32 - k))


def udiv_u43_by_u32(a_hi: jax.Array, divisor: jax.Array) -> jax.Array:
    """floor((a_hi << 32) / divisor) via 16-bit long division.

    Used for the magic-constant computation
    magic = (2^32 * (2^shift - pdf)) / pdf + 1 (GpuANSStatistics.cuh:345-358)
    where a_hi = 2^shift - pdf < pdf, so the quotient fits in uint32.
    """
    a_hi = a_hi.astype(U32)
    divisor = divisor.astype(U32)
    q1 = (a_hi << u32(16)) // divisor
    r1 = (a_hi << u32(16)) - q1 * divisor
    q2 = (r1 << u32(16)) // divisor
    return (q1 << u32(16)) + q2


def bitcast_u32_to_u8(x: jax.Array) -> jax.Array:
    """uint32[..., n] -> uint8[..., 4n], little-endian byte order."""
    b = jax.lax.bitcast_convert_type(x, jnp.uint8)
    return b.reshape(*x.shape[:-1], x.shape[-1] * 4)


def bitcast_u8_to_u32(x: jax.Array) -> jax.Array:
    """uint8[..., 4n] -> uint32[..., n], little-endian byte order."""
    b = x.reshape(*x.shape[:-1], x.shape[-1] // 4, 4)
    return jax.lax.bitcast_convert_type(b, U32)


def row_take(tables: jax.Array, idx: jax.Array) -> jax.Array:
    """values[r, k] = tables[r, idx[r, k]], indices clamped to the row.

    tables: [R, H]; idx: int32[R, K]. The codec's table lookups (encode
    table pre-gather, decode LUT, per-block reverse stream reads)."""
    safe = jnp.clip(idx, 0, tables.shape[1] - 1)
    return jnp.take_along_axis(tables, safe, axis=1)


def bitcast_u32_to_u16(x: jax.Array) -> jax.Array:
    b = jax.lax.bitcast_convert_type(x, jnp.uint16)
    return b.reshape(*x.shape[:-1], x.shape[-1] * 2)


def bitcast_u16_to_u32(x: jax.Array) -> jax.Array:
    b = x.reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
    return jax.lax.bitcast_convert_type(b, U32)
