"""Float word split/join bit tricks, batched in jnp — uint32-native.

The split isolates the high-entropy-free exponent byte(s) for ANS coding and
leaves sign+mantissa raw, using a rotate-left-by-1 so the sign bit lands in
the raw section (reference: FloatTypeInfo<FT>::split/join,
GpuFloatUtils.cuh:194-382).

Every plane here is produced and consumed PACKED in uint32 words (the
exact little-endian byte layout the archive stores): the only
non-elementwise work is the 2:1/4:1 word (de)interleave, expressed as
strided slices that XLA fuses into the elementwise split and join. fp64 is
(lo, hi) uint32 pairs so nothing needs 64-bit types (the reference builds
its 64-bit rotate from two 32-bit funnel shifts, GpuFloatUtils.cuh:342-356).

Layouts (all little-endian within each uint32):
  comp planes: 1 exponent byte per float, 4 floats per word
               (fp64: two planes).
  bf16/fp16 raw: 1 byte per float, 4 per word.
  fp32 raw: sec1 = low 2 bytes per float, 2 per word; sec2 = third byte,
            4 per word.
  fp64 raw: sec1 = low 4 bytes (1 word per float); sec2 = middle 2 bytes,
            2 per word.
"""

from __future__ import annotations

from typing import List, Tuple

import jax
import jax.numpy as jnp

from ..core.constants import FloatType
from .bitops import u32

U32 = jnp.uint32
# plain int, not u32(): a jnp scalar at module scope would initialize the
# JAX backend at import time (breaking late jax_platforms overrides)
_B0 = 0xFF


def _rotl16x2(x: jax.Array) -> jax.Array:
    """rotl(·,1) of both 16-bit halves of each uint32 lane."""
    return ((x << u32(1)) & u32(0xFFFEFFFE)) | ((x >> u32(15)) & u32(0x00010001))


def _rotr16x2(x: jax.Array) -> jax.Array:
    return ((x >> u32(1)) & u32(0x7FFF7FFF)) | ((x << u32(15)) & u32(0x80008000))


def _pack4(b0, b1, b2, b3) -> jax.Array:
    return b0 | (b1 << u32(8)) | (b2 << u32(16)) | (b3 << u32(24))


def _deint2(x: jax.Array) -> Tuple[jax.Array, jax.Array]:
    return x[:, 0::2], x[:, 1::2]


def _int2(a: jax.Array, b: jax.Array) -> jax.Array:
    B, W = a.shape
    return jnp.stack([a, b], axis=2).reshape(B, 2 * W)


def split_packed(
    data32: jax.Array, float_type: FloatType
) -> Tuple[List[jax.Array], List[jax.Array]]:
    """Split uint32-packed float rows (B, W32) into packed planes.

    Capacity-sized: callers mask/ignore content beyond their float count.
    Returns (comp_planes, raw_sections), all uint32-packed as in the
    archive. Requires W32 % 2 == 0 (bf16/fp16/fp64) or % 4 == 0 (fp32).
    """
    ft = FloatType(float_type)
    if ft in (FloatType.FLOAT16, FloatType.BFLOAT16):
        r = data32 if ft == FloatType.FLOAT16 else _rotl16x2(data32)
        we, wo = _deint2(r)
        exp = _pack4(
            (we >> u32(8)) & _B0, we >> u32(24),
            (wo >> u32(8)) & _B0, wo >> u32(24),
        )
        raw = _pack4(
            we & _B0, (we >> u32(16)) & _B0,
            wo & _B0, (wo >> u32(16)) & _B0,
        )
        return [exp], [raw]
    if ft == FloatType.FLOAT32:
        r = (data32 << u32(1)) | (data32 >> u32(31))
        w0, w1, w2, w3 = r[:, 0::4], r[:, 1::4], r[:, 2::4], r[:, 3::4]
        exp = _pack4(w0 >> u32(24), w1 >> u32(24), w2 >> u32(24), w3 >> u32(24))
        sec2 = _pack4(
            (w0 >> u32(16)) & _B0, (w1 >> u32(16)) & _B0,
            (w2 >> u32(16)) & _B0, (w3 >> u32(16)) & _B0,
        )
        e, o = _deint2(r)
        sec1 = (e & u32(0xFFFF)) | (o << u32(16))
        return [exp], [sec1, sec2]
    if ft == FloatType.FLOAT64:
        lo, hi = _deint2(data32)
        v_hi = (hi << u32(1)) | (lo >> u32(31))
        v_lo = (lo << u32(1)) | (hi >> u32(31))
        h0, h1, h2, h3 = v_hi[:, 0::4], v_hi[:, 1::4], v_hi[:, 2::4], v_hi[:, 3::4]
        exp0 = _pack4(h0 >> u32(24), h1 >> u32(24), h2 >> u32(24), h3 >> u32(24))
        exp1 = _pack4(
            (h0 >> u32(16)) & _B0, (h1 >> u32(16)) & _B0,
            (h2 >> u32(16)) & _B0, (h3 >> u32(16)) & _B0,
        )
        he, ho = _deint2(v_hi)
        sec2 = (he & u32(0xFFFF)) | (ho << u32(16))
        return [exp0, exp1], [v_lo, sec2]
    raise ValueError(f"unsupported float type {float_type}")


def _b(x, k):
    return (x >> u32(8 * k)) & _B0


def split_hist_packed(data32: jax.Array, n_floats: jax.Array,
                      float_type: FloatType, archive: bool = False):
    """split_packed plus per-exponent-plane byte histograms and the input
    byte checksum (the reference's splitFloat+histogram+checksum,
    GpuFloatCompress.cuh:423-551, 702-710). Returns (comp_planes,
    raw_sections, hists, csum) with hists uint32[B, 256] over the first
    n_floats bytes and csum uint32[B].

    archive=True returns raw sections as merge sources
    (flat uint32[B * member_stride_words], member_stride_words) — tail-
    masked, addressed directly by runs_merge_multi."""
    ft = FloatType(float_type)
    from ..core.constants import FLOAT_WORD_SIZE
    from .checksum import checksum_packed, mask_packed_bytes
    from .histogram import histogram_packed

    comp, raw = split_packed(data32, ft)
    hists = [histogram_packed(p, n_floats) for p in comp]
    csum = checksum_packed(
        data32, n_floats.astype(jnp.int32) * FLOAT_WORD_SIZE[ft]
    )
    if archive:
        ws = FLOAT_WORD_SIZE[ft]
        bpi = {2: (1,), 4: (2, 1), 8: (4, 2)}[ws]
        refs = []
        for sec, bp in zip(raw, bpi):
            sec = mask_packed_bytes(sec, n_floats.astype(jnp.int32) * bp)
            # archive sections round up to 16 B past the packed capacity:
            # pad each member's row so those words read as zeros
            B, Wsec = sec.shape
            stride = -(-Wsec // 128) * 128
            sec = jnp.pad(sec, ((0, 0), (0, stride - Wsec)))
            refs.append((sec.reshape(-1), stride))
        raw = refs
    return comp, raw, hists, csum


def join_packed(
    comp: List[jax.Array], raw: List[jax.Array], float_type: FloatType
) -> jax.Array:
    """Inverse of split_packed: packed planes -> uint32-packed float rows."""
    ft = FloatType(float_type)
    if ft in (FloatType.FLOAT16, FloatType.BFLOAT16):
        exp, rw = comp[0], raw[0]
        we = (_b(rw, 0)) | (_b(exp, 0) << u32(8)) | (
            _b(rw, 1) << u32(16)
        ) | (_b(exp, 1) << u32(24))
        wo = (_b(rw, 2)) | (_b(exp, 2) << u32(8)) | (
            _b(rw, 3) << u32(16)
        ) | (_b(exp, 3) << u32(24))
        r = _int2(we, wo)
        return r if ft == FloatType.FLOAT16 else _rotr16x2(r)
    if ft == FloatType.FLOAT32:
        exp, sec1, sec2 = comp[0], raw[0], raw[1]
        e = sec1 & u32(0xFFFF)
        o = sec1 >> u32(16)
        lo16 = _int2(e, o)  # (B, n) low halves
        B, n = lo16.shape
        t0, t1, t2, t3 = _b(sec2, 0), _b(sec2, 1), _b(sec2, 2), _b(sec2, 3)
        third = jnp.stack([t0, t1, t2, t3], axis=2).reshape(B, n)
        e0, e1, e2, e3 = _b(exp, 0), _b(exp, 1), _b(exp, 2), _b(exp, 3)
        top = jnp.stack([e0, e1, e2, e3], axis=2).reshape(B, n)
        r = lo16 | (third << u32(16)) | (top << u32(24))
        return (r >> u32(1)) | (r << u32(31))
    if ft == FloatType.FLOAT64:
        exp0, exp1, v_lo, sec2 = comp[0], comp[1], raw[0], raw[1]
        B = v_lo.shape[0]
        n = v_lo.shape[1]
        he = sec2 & u32(0xFFFF)
        ho = sec2 >> u32(16)
        mid = _int2(he, ho)[:, :n]
        e0 = jnp.stack([_b(exp0, k) for k in range(4)], axis=2).reshape(B, -1)[:, :n]
        e1 = jnp.stack([_b(exp1, k) for k in range(4)], axis=2).reshape(B, -1)[:, :n]
        v_hi = mid | (e1 << u32(16)) | (e0 << u32(24))
        lo = (v_lo >> u32(1)) | (v_hi << u32(31))
        hi = (v_hi >> u32(1)) | (v_lo << u32(31))
        return _int2(lo, hi)
    raise ValueError(f"unsupported float type {float_type}")
