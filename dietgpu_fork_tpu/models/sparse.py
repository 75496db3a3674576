"""Batched sparse float codec: nonzero bitmap + dense float codec.

Equivalent of floatCompressSparseDevice / floatDecompressSparseDevice
(GpuSparseFloatCompress.cuh:253-446, GpuSparseFloatDecompress.cuh:183-353).
Differences from the reference, by design:

* The reference runs one thrust::exclusive_scan per batch member in a host
  loop with device synchronizations (GpuSparseFloatCompress.cuh:357-369);
  here the scan is a single batched ``jnp.cumsum`` — fully on device, fully
  async.
* The reference's last-element special case miscounts nonzeros when the
  second-to-last element is zero and encodes one uninitialized word
  (GpuSparseFloatCompress.cuh:170-184). We implement the corrected
  semantics: the dense sub-archive holds exactly the nonzero words in order
  (matching core/reference.py, so archives stay oracle-exact).
* Compaction is a scatter on the compress side and a rank gather on the
  decompress side — no sort, no host round trips.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..core.constants import (
    FloatType,
    max_sparse_float_compressed_size,
)
from ..ops.bitops import bitcast_u32_to_u8, u32
from ..ops.merge import runs_merge
from .float_codec import (
    _floats_capacity,
    float_compress_core,
    float_decompress_core,
)

I32 = jnp.int32
U32 = jnp.uint32
U8 = jnp.uint8


def _nonzero_mask(data32: jax.Array, n: jax.Array, S_cap: int, ft: FloatType):
    """Boolean (B, S_cap) mask of nonzero float words (integer compare, so
    -0.0 is 'nonzero' exactly as in generate_bitmap,
    GpuSparseFloatCompress.cuh:29-58)."""
    B = data32.shape[0]
    if ft in (FloatType.FLOAT16, FloatType.BFLOAT16):
        w16 = jnp.stack(
            [data32 & u32(0xFFFF), data32 >> u32(16)], axis=2
        ).reshape(B, -1)[:, :S_cap]
        nz = w16 != 0
    elif ft == FloatType.FLOAT32:
        nz = data32[:, :S_cap] != 0
    else:
        # pairwise OR of each float's (lo, hi) words
        nz = (
            jax.lax.reduce_window(
                data32[:, : 2 * S_cap], u32(0), jax.lax.bitwise_or,
                window_dimensions=(1, 2), window_strides=(1, 2),
                padding="VALID",
            )
            != 0
        )
    pos = jnp.arange(S_cap, dtype=I32)[None, :]
    return nz & (pos < n[:, None])


def _bitmap_words(n):
    """uint32 words of the 16B-aligned bit-packed bitmap section."""
    return (-(-(-(-n // 8)) // 16) * 16) // 4


def _pack_bitmap_direct(
    data32: jax.Array, n: jax.Array, S_cap: int, ft: FloatType
) -> jax.Array:
    """MSB-first bit packing (GpuSparseFloatCompress.cuh:64-113) straight
    from the packed input words, with no per-float boolean plane: byte k
    of each output word is bits 8k..8k+7, bit 7 first. Each bit is shifted
    to its in-word position and OR-folded with a strided reduce_window, in
    the natural (B, W) layout."""
    nI = n.astype(I32)[:, None]
    if ft in (FloatType.FLOAT16, FloatType.BFLOAT16):
        W = S_cap // 2
        w = data32[:, :W]
        f0 = 2 * jnp.arange(W, dtype=I32)[None, :]
        sh_lo = ((f0 & 31) ^ 7).astype(U32)  # even position: ^7 = +7
        lo = ((w & u32(0xFFFF)) != 0) & (f0 < nI)
        hi = ((w >> u32(16)) != 0) & (f0 + 1 < nI)
        val = (lo.astype(U32) << sh_lo) | (hi.astype(U32) << (sh_lo - 1))
        win = 16
    else:
        if ft == FloatType.FLOAT32:
            nzw = data32[:, :S_cap]
        else:
            nzw = jax.lax.reduce_window(
                data32[:, : 2 * S_cap], u32(0), jax.lax.bitwise_or,
                window_dimensions=(1, 2), window_strides=(1, 2),
                padding="VALID",
            )
        pos = jnp.arange(S_cap, dtype=I32)[None, :]
        val = ((nzw != 0) & (pos < nI)).astype(U32) << (
            ((pos & 31) ^ 7).astype(U32)
        )
        win = 32
    pad = (-val.shape[1]) % win
    val = jnp.pad(val, ((0, 0), (0, pad)))
    return jax.lax.reduce_window(
        val, u32(0), jax.lax.bitwise_or,
        window_dimensions=(1, win), window_strides=(1, win),
        padding="VALID",
    )


def _unpack_bitmap(bm32: jax.Array, S_cap: int) -> jax.Array:
    B, W = bm32.shape
    shifts = (u32(8) * jnp.arange(4, dtype=U32))[None, None, :]
    bytes_ = (bm32[:, :, None] >> shifts) & u32(0xFF)
    bitw = (u32(1) << jnp.arange(7, -1, -1, dtype=U32))[None, None, None, :]
    bits = ((bytes_[:, :, :, None] & bitw) > 0).reshape(B, -1)
    return bits[:, :S_cap]


def _compact_nonzeros(data32, nz, ft: FloatType, S_cap: int):
    """Scatter nonzero float words to the front, preserving order.
    Returns (packed uint32[B, W32], nnz int32[B])."""
    B = data32.shape[0]
    rank = jnp.cumsum(nz.astype(I32), axis=1)
    nnz = rank[:, -1]
    pos = rank - 1
    bb = jnp.arange(B, dtype=I32)[:, None]

    if ft in (FloatType.FLOAT16, FloatType.BFLOAT16):
        w16 = jnp.stack(
            [data32 & u32(0xFFFF), data32 >> u32(16)], axis=2
        ).reshape(B, -1)[:, :S_cap]
        dump = S_cap
        idx = jnp.where(nz, pos, dump)
        out16 = jnp.zeros((B, S_cap + 1), U32).at[bb, idx].add(
            jnp.where(nz, w16.astype(U32), u32(0))
        )[:, :S_cap]
        pad = (-S_cap) % 2
        v = jnp.pad(out16, ((0, 0), (0, pad))).reshape(B, -1, 2)
        return v[..., 0] | (v[..., 1] << u32(16)), nnz
    if ft == FloatType.FLOAT32:
        dump = S_cap
        idx = jnp.where(nz, pos, dump)
        out = jnp.zeros((B, S_cap + 1), U32).at[bb, idx].add(
            jnp.where(nz, data32[:, :S_cap], u32(0))
        )
        return out[:, :S_cap], nnz
    # FLOAT64: scatter lo/hi halves
    lo = data32[:, 0 : 2 * S_cap : 2]
    hi = data32[:, 1 : 2 * S_cap : 2]
    dump = S_cap
    idx = jnp.where(nz, pos, dump)
    out_lo = jnp.zeros((B, S_cap + 1), U32).at[bb, idx].add(
        jnp.where(nz, lo, u32(0))
    )[:, :S_cap]
    out_hi = jnp.zeros((B, S_cap + 1), U32).at[bb, idx].add(
        jnp.where(nz, hi, u32(0))
    )[:, :S_cap]
    return jnp.stack([out_lo, out_hi], axis=2).reshape(B, -1), nnz


def sparse_float_compress_core(
    data32: jax.Array,
    n: jax.Array,
    float_type: FloatType,
    prob_bits: int = 10,
    use_checksum: bool = False,
    native: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    """Compress sparse float rows. Returns (out32, comp_bytes)."""
    ft = FloatType(float_type)
    B, W32 = data32.shape
    S_cap = _floats_capacity(W32, ft)
    n = n.astype(I32)

    bm32 = _pack_bitmap_direct(data32, n, S_cap, ft)
    bmw_cap = _bitmap_words(S_cap)
    if bm32.shape[1] < bmw_cap:
        bm32 = jnp.pad(bm32, ((0, 0), (0, bmw_cap - bm32.shape[1])))
    nz = _nonzero_mask(data32, n, S_cap, ft)
    packed, nnz = _compact_nonzeros(data32, nz, ft, S_cap)

    dense32, dense_bytes = float_compress_core(
        packed, nnz, ft, prob_bits, use_checksum, native=native
    )

    hdr = jnp.stack(
        [n.astype(U32)] + [jnp.zeros((B,), U32)] * 3, axis=1
    )
    bmw = _bitmap_words(n)
    o_bm = 4
    o_dense = o_bm + bmw
    end = o_dense + (dense_bytes.astype(I32) >> 2)

    # archive assembly: [header | bitmap | dense archive] runs per member
    CWs = (4 + bm32.shape[1] + dense32.shape[1])
    BW = bm32.shape[1]
    DW = dense32.shape[1]
    src_flat = jnp.concatenate(
        [hdr.reshape(-1), bm32.reshape(-1), dense32.reshape(-1)]
    )
    b_ar = jnp.arange(B, dtype=I32)
    row0 = b_ar * CWs
    dst = jnp.stack(
        [row0, row0 + o_bm, row0 + o_dense], axis=1
    ).reshape(-1)
    src = jnp.stack(
        [b_ar * 4, B * 4 + b_ar * BW, B * 4 + B * BW + b_ar * DW], axis=1
    ).reshape(-1)
    lens = jnp.stack(
        [jnp.full((B,), 4, I32), bmw, dense_bytes.astype(I32) >> 2], axis=1
    ).reshape(-1)
    out = runs_merge(src_flat, dst, src, lens, B * CWs).reshape(B, CWs)
    comp_bytes = (4 * end).astype(U32)
    return out, comp_bytes


def sparse_float_decompress_core(
    comp32: jax.Array,
    out_floats: int,
    float_type: FloatType,
    prob_bits: int = 10,
    capacities: Optional[jax.Array] = None,
    verify_checksum: bool = False,
    native: bool = False,
):
    """Decompress sparse float archives.

    Returns (words32, success, n uint32[B], archive_checksum, computed_checksum).
    """
    ft = FloatType(float_type)
    B, CW = comp32.shape
    n = comp32[:, 0].astype(I32)

    # The sparse header carries only the float count (GpuSparseFloatHeader,
    # GpuFloatUtils.cuh:107-128 — no magic); sanitize it so a garbage count
    # cannot produce negative/overflowing section offsets. Real validation
    # happens on the embedded dense archive's magic below.
    sane = (n >= 0) & (4 + _bitmap_words(jnp.maximum(n, 0)) + 4 <= CW)
    n = jnp.where(sane, n, 0)

    if capacities is None:
        capacities = jnp.full((B,), out_floats, I32)
    success = sane & (n <= capacities.astype(I32))

    bmw = _bitmap_words(n)
    BMW_cap = max(_bitmap_words(out_floats), 1)
    b_ar = jnp.arange(B, dtype=I32)
    bm32 = runs_merge(
        comp32.reshape(-1),
        b_ar * BMW_cap,
        b_ar * CW + 4,
        jnp.minimum(bmw, BMW_cap),
        B * BMW_cap,
    ).reshape(B, BMW_cap)
    dense_base = 4 + bmw
    nz32, dsuccess, nnz, csum_arch, csum_got = float_decompress_core(
        comp32, dense_base, out_floats, ft, prob_bits, capacities,
        verify_checksum, native=native,
    )
    success = success & dsuccess

    # expansion: out[i] = bitmap[i] ? nonzeros[rank(i)] : 0, a rank gather
    bitmap = _unpack_bitmap(bm32, out_floats)
    pos = jnp.arange(out_floats, dtype=I32)[None, :]
    bitmap = bitmap & (pos < n[:, None])
    rank = jnp.cumsum(bitmap.astype(I32), axis=1) - 1
    rank = jnp.clip(rank, 0, out_floats - 1)
    if ft in (FloatType.FLOAT16, FloatType.BFLOAT16):
        h16 = jnp.stack(
            [nz32 & u32(0xFFFF), nz32 >> u32(16)], axis=2
        ).reshape(B, -1)[:, :out_floats]
        vals = jnp.take_along_axis(h16, rank, axis=1)
        w16 = jnp.where(bitmap, vals, u32(0))
        pad = (-out_floats) % 2
        v = jnp.pad(w16, ((0, 0), (0, pad))).reshape(B, -1, 2)
        words32 = v[..., 0] | (v[..., 1] << u32(16))
    elif ft == FloatType.FLOAT32:
        vals = jnp.take_along_axis(nz32[:, :out_floats], rank, axis=1)
        words32 = jnp.where(bitmap, vals, u32(0))
    else:
        lo = jnp.take_along_axis(nz32[:, 0 : 2 * out_floats : 2], rank, axis=1)
        hi = jnp.take_along_axis(nz32[:, 1 : 2 * out_floats : 2], rank, axis=1)
        lo = jnp.where(bitmap, lo, u32(0))
        hi = jnp.where(bitmap, hi, u32(0))
        words32 = jnp.stack([lo, hi], axis=2).reshape(B, -1)
    return words32, success, n.astype(U32), csum_arch, csum_got


def sparse_float_compress_padded(
    data32, n, float_type, prob_bits=10, use_checksum=False, out_bytes=None,
    native=False,
):
    """uint8-row wrapper with the getMaxSparseFloatCompressedSize contract."""
    ft = FloatType(float_type)
    out32, comp_bytes = sparse_float_compress_core(
        data32, n, ft, prob_bits, use_checksum, native=native
    )
    comp = bitcast_u32_to_u8(out32)
    cb = (
        out_bytes
        if out_bytes is not None
        else max_sparse_float_compressed_size(
            ft, _floats_capacity(data32.shape[1], ft)
        )
    )
    if comp.shape[1] < cb:
        comp = jnp.pad(comp, ((0, 0), (0, cb - comp.shape[1])))
    return comp, comp_bytes
