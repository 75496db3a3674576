"""Interleaved 32-state rANS decoder.

On the GPU the classic-layout walk is the CUDA kernel of ops/rans_cuda.py,
which follows the reference decoder (GpuANSDecode.cuh:56-297): one warp per
block, the decode LUT in shared memory, ballot + popc to rank the reverse
reads.

The plain jax.numpy formulation here is the CPU path and the kernel's
reference. All blocks advance in lockstep under one ``lax.scan``; the
reference's per-warp reverse walk becomes a uniform 128-iteration schedule:

  iteration k = 0 handles the block's tail partial group of
  r' = ((U-1) mod 32) + 1 lanes; iterations k >= 1 handle full 32-lane
  groups walking toward position 0 (this folds the reference's
  decodeOnePartialWarp / decodeOneWarp split into one masked code path).

The reference's reverse ballot (reading renorm words in descending lane
order, GpuANSDecode.cuh:89-104) becomes a reversed 32-lane cumsum.

Decoded symbols are emitted per step and laid down at the end with a single
per-block constant-shift gather: iteration k lane l decodes position
U - r' - 32k + l, so the time-reversed emission tensor is the output shifted
by (4064 + r' - U) — no scatter needed.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..core.constants import (
    ANS_MIN_STATE,
    BLOCK_SIZE,
    STEPS_PER_BLOCK,
    WARP_SIZE,
)
from .bitops import bitcast_u8_to_u32, row_take, u32

I32 = jnp.int32
U32 = jnp.uint32


def decode_blocks(
    streams32: jax.Array,
    comp_words: jax.Array,
    uncomp_words: jax.Array,
    states: jax.Array,
    lut: jax.Array,
    prob_bits: int,
) -> jax.Array:
    """Decode all blocks of a batch of archives.

    streams32:   uint32[B, NB, SW] per-block staged compressed streams
                 (uint16 pairs; block word k at [.., k>>1], half k&1)
    comp_words:  int32[B, NB]    per-block compressed uint16 word count
    uncomp_words:int32[B, NB]    per-block decoded byte count (0 for unused)
    states:      uint32[B, NB, 32] initial interleaved states
    lut:         uint32[B, 2^prob_bits] decode lookup table

    Returns out: uint32[B, NB, 1024] packed decoded bytes (little-endian).

    On the GPU this is the CUDA kernel (ops/rans_cuda.py); elsewhere the
    plain walk below, which is also the kernel's reference.
    """
    if jax.default_backend() == "gpu":
        from . import rans_cuda

        return rans_cuda.decode_blocks(
            streams32, comp_words, uncomp_words, states, lut, prob_bits
        )
    return decode_blocks_plain(
        streams32, comp_words, uncomp_words, states, lut, prob_bits
    )


def decode_blocks_plain(
    streams32: jax.Array,
    comp_words: jax.Array,
    uncomp_words: jax.Array,
    states: jax.Array,
    lut: jax.Array,
    prob_bits: int,
) -> jax.Array:
    """The jax.numpy decode_blocks, on any backend."""
    B, NB, SW = streams32.shape
    lanes = jnp.arange(WARP_SIZE, dtype=I32)

    uw = uncomp_words.astype(I32)
    r = ((uw - 1) % WARP_SIZE) + 1  # tail group width (32 for full blocks)
    nsteps = -(-uw // WARP_SIZE)

    state_mask = u32((1 << prob_bits) - 1)
    st_rows = streams32.reshape(B * NB, SW)

    def step(carry, k):
        states, ptr = carry
        active = (k < nsteps) & (uw > 0)
        lane_valid = active[:, :, None] & (
            (k > 0) | (lanes[None, None, :] < r[:, :, None])
        )

        s_bar = (states & state_mask).astype(I32)
        ent = row_take(lut, s_bar.reshape(B, -1)).reshape(s_bar.shape)
        sym = (ent & u32(0xFF)).astype(jnp.uint8)
        pdf = (ent >> u32(8)) & u32(0xFFF)
        smc = ent >> u32(20)

        new_state = pdf * (states >> u32(prob_bits)) + smc
        states = jnp.where(lane_valid, new_state, states)

        read = lane_valid & (states < u32(ANS_MIN_STATE))
        # inclusive count of reading lanes with index >= l
        # (the reference's reverse ballot, GpuANSDecode.cuh:89-104)
        suffix = jnp.flip(
            jnp.cumsum(jnp.flip(read.astype(I32), axis=2), axis=2), axis=2
        )
        idx16 = ptr[:, :, None] - suffix  # block-relative uint16 index
        idx32 = jnp.clip(idx16 >> 1, 0, SW - 1)
        w32 = row_take(
            st_rows, idx32.reshape(B * NB, WARP_SIZE)
        ).reshape(idx16.shape)
        val = jnp.where(
            (idx16 & 1) == 1, w32 >> u32(16), w32 & u32(0xFFFF)
        )
        states = jnp.where(read, (states << u32(16)) + val, states)
        ptr = ptr - read.astype(I32).sum(axis=2, dtype=I32)
        return (states, ptr), sym

    ks = jnp.arange(STEPS_PER_BLOCK, dtype=I32)
    (_, _), syms = jax.lax.scan(step, (states, comp_words.astype(I32)), ks)

    # syms: (128, B, NB, 32); time-reverse so flat index i within a block
    # holds position (U - r' - 4064) + i, then shift per block by
    # (4064 + r' - U): a per-block dynamic slice of the padded row.
    flat = jnp.flip(syms, axis=0).transpose(1, 2, 0, 3).reshape(
        B * NB, BLOCK_SIZE
    )
    # shift in [0, 4064]; pad rows so the slice window stays in bounds
    # (out-of-range tail is masked below)
    flat = jnp.pad(flat, ((0, 0), (0, BLOCK_SIZE)))
    shift = ((STEPS_PER_BLOCK - 1) * WARP_SIZE + r - uw).reshape(-1)
    out = jax.vmap(
        lambda row, s: jax.lax.dynamic_slice(row, (s,), (BLOCK_SIZE,))
    )(flat, jnp.clip(shift, 0, BLOCK_SIZE))
    out = out.reshape(B, NB, BLOCK_SIZE)
    p = jnp.arange(BLOCK_SIZE, dtype=I32)
    out = jnp.where(p[None, None, :] < uw[:, :, None], out, jnp.uint8(0))
    return bitcast_u8_to_u32(out)


def decode_blocks_rows(
    streams_row: jax.Array,
    comp_words: jax.Array,
    uncomp_words: jax.Array,
    states: jax.Array,
    lut: jax.Array,
    prob_bits: int,
) -> jax.Array:
    """Decode ROW-STREAM native archives (core/reference.py
    ans_decode_native): each row of 4 consecutive blocks shares ONE
    reverse-read cursor over its interleaved stream.

    streams_row: uint32[B, NR, SWR] per-row staged streams (start-aligned
    u16 pairs); comp_words/uncomp_words: int32[B, NB] per BLOCK; states:
    uint32[B, NB, 32]. Returns uint32[B, NB, 1024] packed decoded bytes.

    The walk is BOTTOM-aligned: block decode iteration k = i - (S - nsteps)
    so that at global iteration i every active block of a row is processing
    the same encode step (S - 1 - i) — the interleaved stream's reverse
    order is then a single suffix count over the row's 128 lanes.
    """
    B, NR, SWR = streams_row.shape
    NB = comp_words.shape[1]
    NB4 = 4 * NR
    lanes32 = jnp.arange(WARP_SIZE, dtype=I32)

    def pad4(a, fill=0):
        return jnp.pad(
            a, [(0, 0), (0, NB4 - NB)] + [(0, 0)] * (a.ndim - 2),
            constant_values=fill,
        )

    uw = pad4(uncomp_words.astype(I32)).reshape(B, NR, 4)
    cw = pad4(comp_words.astype(I32)).reshape(B, NR, 4)
    r = ((uw - 1) % WARP_SIZE) + 1
    nsteps = -(-uw // WARP_SIZE)
    st = pad4(states).reshape(B, NR, 4 * WARP_SIZE)
    row_words = cw.sum(axis=2)  # u16 words per row stream

    state_mask = u32((1 << prob_bits) - 1)
    st_rows = streams_row.reshape(B * NR, SWR)
    S = STEPS_PER_BLOCK

    def step(carry, i):
        states, ptr = carry
        k = i - (S - nsteps)  # (B, NR, 4) per-block iteration index
        active = (k >= 0) & (uw > 0)
        lane_valid = (
            active[:, :, :, None]
            & ((k[:, :, :, None] > 0) | (lanes32[None, None, None, :] < r[:, :, :, None]))
        ).reshape(B, NR, 4 * WARP_SIZE)

        s_bar = (states & state_mask).astype(I32)
        ent = row_take(lut, s_bar.reshape(B, -1)).reshape(s_bar.shape)
        sym = (ent & u32(0xFF)).astype(jnp.uint8)
        pdf = (ent >> u32(8)) & u32(0xFFF)
        smc = ent >> u32(20)

        states = jnp.where(
            lane_valid, pdf * (states >> u32(prob_bits)) + smc, states
        )

        read = lane_valid & (states < u32(ANS_MIN_STATE))
        suffix = jnp.flip(
            jnp.cumsum(jnp.flip(read.astype(I32), axis=2), axis=2), axis=2
        )
        idx16 = ptr[:, :, None] - suffix  # row-relative uint16 index
        idx32 = jnp.clip(idx16 >> 1, 0, SWR - 1)
        w32 = row_take(
            st_rows, idx32.reshape(B * NR, 4 * WARP_SIZE)
        ).reshape(idx16.shape)
        val = jnp.where((idx16 & 1) == 1, w32 >> u32(16), w32 & u32(0xFFFF))
        states = jnp.where(read, (states << u32(16)) + val, states)
        ptr = ptr - read.astype(I32).sum(axis=2, dtype=I32)
        return (states, ptr), sym

    ks = jnp.arange(S, dtype=I32)
    (_, _), syms = jax.lax.scan(step, (st, row_words), ks)

    # syms: (S, B, NR, 128). Bottom-aligned walk means block iteration k
    # decodes positions u - r - 32k + lane, and time-reversing the step
    # axis lays every block's bytes down from position 0 with NO shift
    # (u = 32 * (nsteps - 1) + r exactly).
    out = (
        jnp.flip(syms, axis=0)
        .reshape(S, B, NR, 4, WARP_SIZE)
        .transpose(1, 2, 3, 0, 4)
        .reshape(B, NB4, BLOCK_SIZE)[:, :NB]
    )
    p = jnp.arange(BLOCK_SIZE, dtype=I32)
    out = jnp.where(
        p[None, None, :] < uncomp_words.astype(I32)[:, :, None],
        out,
        jnp.uint8(0),
    )
    return bitcast_u8_to_u32(out)
