"""Batched 256-bin byte histograms.

The reference builds per-warp shared-memory histograms with atomics
(GpuANSStatistics.cuh:21-134). Here the count is one XLA scatter-add, which
the GPU backend lowers to atomic adds.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.constants import NUM_SYMBOLS
from .bitops import bitcast_u32_to_u8

I32 = jnp.int32
U32 = jnp.uint32


def histogram_batched(data_u8: jax.Array, sizes: jax.Array) -> jax.Array:
    """data_u8: uint8[B, S]; sizes: int32[B]. Returns uint32[B, 256] counts
    of each member's first sizes[b] bytes."""
    B, S = data_u8.shape
    pos = jnp.arange(S, dtype=I32)
    valid = pos[None, :] < sizes[:, None].astype(I32)
    b_idx = jnp.broadcast_to(jnp.arange(B, dtype=I32)[:, None], (B, S))
    hist = jnp.zeros((B, NUM_SYMBOLS), I32).at[
        b_idx, data_u8.astype(I32)
    ].add(valid.astype(I32))
    return hist.astype(U32)


def histogram_packed(data32: jax.Array, sizes: jax.Array) -> jax.Array:
    """Byte histogram of uint32-packed rows (B, W); sizes in bytes."""
    return histogram_batched(bitcast_u32_to_u8(data32), sizes)
