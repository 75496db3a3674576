"""Probability normalization and coding-table construction, batched in jnp.

Replicates the reference's quantization exactly — including its float32
first-pass arithmetic and the symbol-id (not rank) +1 distribution quirk —
so that archives match the NumPy oracle byte-for-byte
(reference: GpuANSStatistics.cuh:178-367, GpuANSDecode.cuh:405-476).

These are (batch, 256)-shaped computations: tiny next to the coding kernels,
so they are expressed in plain jnp and left to XLA.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..core.constants import NUM_SYMBOLS
from .bitops import clz32, u32, udiv_u43_by_u32

I32 = jnp.int32
U32 = jnp.uint32


def normalize_probs_batched(
    counts: jax.Array, totals: jax.Array, prob_bits: int
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Quantize histograms so each row sums to exactly 2^prob_bits.

    counts: uint32[B, 256]; totals: int32/uint32[B] (may be 0 for empty
    members, whose rows come back all-zero).
    Returns (pdf, cdf, magic, shift), each uint32[B, 256].
    """
    B = counts.shape[0]
    target = 1 << prob_bits
    counts = counts.astype(U32)
    totals = totals.astype(U32)
    nonempty = (totals > 0)[:, None]

    # First-pass float32 quantization with truncating cast
    # (GpuANSStatistics.cuh:215-218).
    safe_tot = jnp.where(totals > 0, totals, 1).astype(jnp.float32)
    q = (
        jnp.float32(target) * (counts.astype(jnp.float32) / safe_tot[:, None])
    ).astype(U32)
    q = jnp.where((counts > 0) & (q == 0), u32(1), q)
    q = jnp.where(nonempty, q, u32(0))
    qsum = q.astype(I32).sum(axis=1)  # <= 2^16 * 256, fits easily

    # The reference sorts (qProb << 16 | sym) descending and walks the sorted
    # array (GpuANSStatistics.cuh:229-315). Both corrections only depend on
    # each element's RANK, so they run here in symbol order with compare-sum
    # ranks instead of a sort.
    syms = jnp.arange(NUM_SYMBOLS, dtype=I32)
    prob = q.astype(I32)
    diff = target - qsum  # int32[B]

    # diff > 0: +1 to symbols whose *id* < remaining diff, in rounds of 256
    # (reference quirk, GpuANSStatistics.cuh:261-273) — rank-independent.
    pos_diff = jnp.maximum(diff, 0)
    add = (pos_diff[:, None] // NUM_SYMBOLS) + (
        syms[None, :] < (pos_diff[:, None] % NUM_SYMBOLS)
    ).astype(I32)
    prob = prob + jnp.where(diff[:, None] > 0, add, 0)

    # diff < 0: iteratively subtract 1 from the `it` smallest values > 1,
    # ties broken by symbol id via the packed sort key
    # (GpuANSStatistics.cuh:274-315). Elements with prob > 1 are exactly the
    # top of the descending sort, so "positions [num_gt1-it, num_gt1)" is
    # "ascending key rank < it among prob > 1".
    neg_diff = jnp.maximum(-diff, 0)

    def cond(state):
        _, d = state
        return jnp.any(d > 0)

    def body(state):
        prob, d = state
        gt1 = prob > 1
        num_gt1 = gt1.astype(I32).sum(axis=1)
        it = jnp.minimum(d, num_gt1)
        key = (prob << 16) | syms[None, :]
        arank = jnp.sum(
            (gt1[:, None, :] & (key[:, None, :] < key[:, :, None])),
            axis=2,
            dtype=I32,
        )
        sub = gt1 & (arank < it[:, None]) & (d[:, None] > 0)
        return prob - sub.astype(I32), d - it

    prob, _ = jax.lax.while_loop(cond, body, (prob, neg_diff))
    pdf = jnp.where(nonempty, prob, 0).astype(U32)

    csum = jnp.cumsum(pdf.astype(I32), axis=1)
    cdf = jnp.concatenate([jnp.zeros((B, 1), I32), csum[:, :-1]], axis=1).astype(
        U32
    )

    # Magic-multiply division constants (GpuANSStatistics.cuh:345-358).
    nz = pdf > 0
    shift = jnp.where(nz, u32(32) - clz32(pdf - u32(1)), u32(0))
    safe_pdf = jnp.where(nz, pdf, u32(1))
    a_hi = (u32(1) << shift) - pdf  # < pdf for pdf > 0
    magic = jnp.where(nz, udiv_u43_by_u32(a_hi, safe_pdf) + u32(1), u32(0))
    return pdf, cdf, magic, shift


def pack_encode_table(pdf, cdf, shift):
    """Pack (pdf[12b] | cdf[11b]<<12 | shift<<23) into one uint32 so the
    per-symbol encode gather is a single lookup (magic is gathered
    separately). pdf needs 12 bits: the degenerate single-symbol table has
    pdf = 2^prob_bits = 2048 at prob_bits 11 (cdf is exclusive, so it is
    always <= 2^prob_bits - 1 and fits 11 bits). shift occupies the top 9
    bits but normalize_probs_batched only ever produces 0..11 (pdf == 0
    rows pack shift 0), so unpack's `t >> 23` needs no mask."""
    return pdf | (cdf << u32(12)) | (shift << u32(23))


def unpack_encode_table(t):
    pdf = t & u32(0xFFF)
    cdf = (t >> u32(12)) & u32(0x7FF)
    shift = t >> u32(23)
    return pdf, cdf, shift


def build_decode_table_batched(pdf: jax.Array, prob_bits: int) -> jax.Array:
    """Expand pdf rows into 2^prob_bits decode LUTs; entries pack
    ((slot - cdf) << 20 | pdf << 8 | sym) (GpuANSDecode.cuh:34-41).

    pdf: uint32[B, 256] -> uint32[B, 2^prob_bits].
    """
    nbuckets = 1 << prob_bits
    bounds = jnp.cumsum(pdf.astype(I32), axis=1)  # inclusive
    slots = jnp.arange(nbuckets, dtype=I32)

    def one(bounds_row, pdf_row):
        sym = jnp.searchsorted(bounds_row, slots, side="right").astype(I32)
        sym = jnp.minimum(sym, NUM_SYMBOLS - 1)
        cdf_row = bounds_row - pdf_row.astype(I32)  # exclusive cdf
        within = slots - cdf_row[sym]
        return (
            (within.astype(U32) << u32(20))
            | (pdf_row[sym].astype(U32) << u32(8))
            | sym.astype(U32)
        )

    return jax.vmap(one)(bounds, pdf)
