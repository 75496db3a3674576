"""Interleaved 32-state rANS encoder.

On the GPU the classic-layout walk is the CUDA kernel of ops/rans_cuda.py,
which follows the reference (GpuANSEncode.cuh:50-211): one warp per 4 KiB
block, ballot + popc to rank each step's emissions.

The plain jax.numpy formulation here is the CPU path and the kernel's
reference:

* *All* blocks of all batch members advance in lockstep: state is a
  (batch, blocks, 32) uint32 tensor and the 128 interleave steps run under
  ``lax.scan``. The per-step warp ballot becomes a 32-lane masked cumsum.
* Partial blocks are handled by validity masks instead of a separate kernel
  (encodeOnePartialWarp semantics: invalid lanes neither emit nor update
  state).
* Emissions are not compacted online. Each step contributes one
  (word, mask) pair per lane; compaction to the format's (step-major,
  lane-ascending) stream order happens once at the end with a cumsum and a
  per-block sort of (position, word) keys.

The archive byte order this produces is identical to the reference's.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..core.constants import (
    ANS_START_STATE,
    ANS_STATE_BITS,
    BLOCK_SIZE,
    STEPS_PER_BLOCK,
    WARP_SIZE,
    raw_comp_block_max_size,
)
from .bitops import bitcast_u32_to_u8, row_take, u32, umulhi
from .table import unpack_encode_table

I32 = jnp.int32
U32 = jnp.uint32

# Worst-case uint16 words per block, and uint32 pairs
MAX_BLOCK_WORDS = raw_comp_block_max_size(BLOCK_SIZE) // 2  # 2560
MAX_BLOCK_WORDS32 = MAX_BLOCK_WORDS // 2  # 1280
# Row-stream native layout: one shared stream per row of 4 blocks
MAX_ROW_WORDS32 = 4 * MAX_BLOCK_WORDS32  # 5120


def encode_blocks(
    x32: jax.Array,
    sizes: jax.Array,
    packed_table: jax.Array,
    magic_table: jax.Array,
    prob_bits: int,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Encode all blocks of a padded batch.

    x32: uint32[B, NB*1024] packed symbol bytes (zero-padded);
    sizes: int32[B] byte counts; packed_table/magic_table: uint32[B, 256].

    Returns:
      states:    uint32[B, NB, 32]  final per-block interleaved states
      streams32: uint32[B, NB, MAX_BLOCK_WORDS32] compressed words,
                 little-endian u16 pairs, zero past each block's words
      num_words: int32[B, NB]       emitted uint16 words per block

    On the GPU this is the CUDA kernel (ops/rans_cuda.py); elsewhere the
    plain walk below, which is also the kernel's reference.
    """
    if jax.default_backend() == "gpu":
        from . import rans_cuda

        return rans_cuda.encode_blocks(
            x32, sizes, packed_table, magic_table, prob_bits
        )
    return encode_blocks_plain(x32, sizes, packed_table, magic_table, prob_bits)


def encode_blocks_plain(
    x32: jax.Array,
    sizes: jax.Array,
    packed_table: jax.Array,
    magic_table: jax.Array,
    prob_bits: int,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """The jax.numpy encode_blocks, on any backend."""

    states, words, mask = _walk_plain(
        x32, sizes, packed_table, magic_table, prob_bits
    )
    B = x32.shape[0]
    NB = words.shape[2]

    # Compact to format order: step-major, lane-ascending within each block,
    # as a per-block sort of (position << 16 | word) keys. Emission
    # positions are unique per block, so the keys sort into stream order.
    mask_f = mask.transpose(1, 2, 0, 3).reshape(B, NB, BLOCK_SIZE)
    words_f = words.transpose(1, 2, 0, 3).reshape(B, NB, BLOCK_SIZE)

    inc = jnp.cumsum(mask_f.astype(I32), axis=2)
    num_words = inc[:, :, -1]
    wpos = inc - 1  # exclusive position where mask

    key = jnp.where(
        mask_f,
        (wpos << 16) | words_f.astype(I32),
        jnp.int32(0x7FFFFFFF),
    )
    skey = jax.lax.sort(key, dimension=2)
    w16 = (skey[:, :, : 2 * MAX_BLOCK_WORDS32] & 0xFFFF).astype(U32)
    slot = jnp.arange(2 * MAX_BLOCK_WORDS32, dtype=I32)[None, None, :]
    w16 = jnp.where(slot < num_words[:, :, None], w16, u32(0))
    v = w16.reshape(B, NB, MAX_BLOCK_WORDS32, 2)
    streams32 = v[..., 0] | (v[..., 1] << u32(16))
    return states, streams32, num_words


def encode_blocks_rows(
    x32: jax.Array,
    sizes: jax.Array,
    packed_table: jax.Array,
    magic_table: jax.Array,
    prob_bits: int,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Encode for the ROW-STREAM native layout (core/reference.py
    ans_encode_native): the per-step emissions of each row of 4 consecutive
    blocks interleave (step-major; blocks then lanes ascending within a
    step) into ONE shared stream per row.

    Same walk as encode_blocks; only the compaction differs. Returns
    (states uint32[B, NB, 32], row_streams32 uint32[B, NR, MAX_ROW_WORDS32]
    with NR = ceil(NB/4), num_words int32[B, NB])."""

    states, words, mask = _walk_plain(
        x32, sizes, packed_table, magic_table, prob_bits
    )
    B = x32.shape[0]
    S, _, NB, _ = words.shape
    NR = -(-NB // 4)
    NB4 = 4 * NR

    # per-block word counts (blockWords.x keeps them even in native mode)
    num_words = mask.transpose(1, 2, 0, 3).reshape(B, NB, -1).astype(
        I32
    ).sum(axis=2)

    # (S, B, NB, 32) -> (B, NR, S * 128) in (step, block-in-row, lane) order
    pad = [(0, 0), (0, 0), (0, NB4 - NB), (0, 0)]
    words_r = (
        jnp.pad(words, pad)
        .reshape(S, B, NR, 4 * WARP_SIZE)
        .transpose(1, 2, 0, 3)
        .reshape(B, NR, S * 4 * WARP_SIZE)
    )
    mask_r = (
        jnp.pad(mask, pad)
        .reshape(S, B, NR, 4 * WARP_SIZE)
        .transpose(1, 2, 0, 3)
        .reshape(B, NR, S * 4 * WARP_SIZE)
    )

    inc = jnp.cumsum(mask_r.astype(I32), axis=2)
    row_words = inc[:, :, -1]
    wpos = inc - 1
    # wpos < 4 * 2560 = 10240, so (wpos << 16 | word) fits int32
    key = jnp.where(
        mask_r,
        (wpos << 16) | words_r.astype(I32),
        jnp.int32(0x7FFFFFFF),
    )
    skey = jax.lax.sort(key, dimension=2)
    w16 = (skey[:, :, : 2 * MAX_ROW_WORDS32] & 0xFFFF).astype(U32)
    slot = jnp.arange(2 * MAX_ROW_WORDS32, dtype=I32)[None, None, :]
    w16 = jnp.where(slot < row_words[:, :, None], w16, u32(0))
    v = w16.reshape(B, NR, MAX_ROW_WORDS32, 2)
    row_streams32 = v[..., 0] | (v[..., 1] << u32(16))
    return states, row_streams32, num_words


def _walk_plain(
    x32: jax.Array,
    sizes: jax.Array,
    packed_table: jax.Array,
    magic_table: jax.Array,
    prob_bits: int,
):
    """The 128-step interleaved encode walk (lax.scan). Returns
    (states uint32[B, NB, 32], words uint16[S, B, NB, 32],
    mask bool[S, B, NB, 32])."""
    x_u8 = bitcast_u32_to_u8(x32)
    B, padded = x_u8.shape
    NB = padded // BLOCK_SIZE
    sym = x_u8.astype(I32).reshape(B, NB, STEPS_PER_BLOCK, WARP_SIZE)

    # Pre-gather per-position table entries (one packed word + magic), so the
    # sequential scan below does no gathers.
    flat = sym.reshape(B, -1)
    tab = row_take(packed_table, flat).reshape(sym.shape)
    mag = row_take(magic_table, flat).reshape(sym.shape)

    pos = jnp.arange(padded, dtype=I32).reshape(NB, STEPS_PER_BLOCK, WARP_SIZE)
    valid = pos[None] < sizes[:, None, None, None].astype(I32)

    # step-major layout for lax.scan
    tab = tab.transpose(2, 0, 1, 3)
    mag = mag.transpose(2, 0, 1, 3)
    valid = valid.transpose(2, 0, 1, 3)

    state_check_shift = ANS_STATE_BITS - prob_bits
    prob_mul = u32(1 << prob_bits)

    def step(states, xs):
        t, m, v = xs
        pdf, cdf, shift = unpack_encode_table(t)
        # shift is 0..11 by construction (pdf==0 rows pack shift 0 and are
        # never taken by valid lanes); defensive clamp only
        shift = jnp.minimum(shift, u32(31))

        write = v & (states >= (pdf << u32(state_check_shift)))
        word = (states & u32(0xFFFF)).astype(jnp.uint16)
        states = jnp.where(write, states >> u32(16), states)

        # exact (state / pdf, state % pdf) via magic multiply
        # (GpuANSEncode.cuh:79-86)
        q = (umulhi(states, m) + states) >> shift
        mod = states - q * pdf
        states = jnp.where(v, q * prob_mul + mod + cdf, states)
        return states, (word, write)

    init = jnp.full((B, NB, WARP_SIZE), ANS_START_STATE, dtype=U32)
    states, (words, mask) = jax.lax.scan(step, init, (tab, mag, valid))
    return states, words, mask
