"""Batched float codec pipelines: split + ANS compose, on device.

Equivalent of floatCompressDevice / floatDecompressDevice
(GpuFloatCompress.cuh:670-874, GpuFloatDecompress.cuh:900-1073). Structure:

* compress: split + per-plane histograms (the reference's
  splitFloat+histogram) -> per-plane ANS encode (1 plane; 2 independent
  planes for fp64) -> one ragged runs-merge placing header, raw sections,
  and ANS archive(s) in the archive layout. Every plane stays packed in
  uint32 words end to end.
* decompress: header parse -> per-plane ANS decode at dynamic offsets ->
  raw-section runs-merge into dense staging -> packed join (the
  reference fuses the join into the decoder, JoinFloatWriter; here it is
  a second elementwise pass).

fp64 is two ANS planes; the byte offset of the second is recorded in the
second header word exactly as GpuFloatHeader2 does (GpuFloatUtils.cuh:78-96).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..core.constants import (
    BLOCK_SIZE,
    FLOAT_NUM_COMP_SEGMENTS,
    FLOAT_WORD_SIZE,
    FloatType,
    max_compressed_size,
    max_float_compressed_size,
)
from ..ops.bitops import bitcast_u32_to_u8, u32
from ..ops.checksum import checksum_packed
from ..ops.float_split import join_packed, split_hist_packed
from ..ops.merge import _RSH, runs_merge, runs_merge_multi
from .ans import ans_decode_core, ans_encode_sections

I32 = jnp.int32
U32 = jnp.uint32
U16 = jnp.uint16
U8 = jnp.uint8

_FLOAT_MAGIC_VERSION = (0xF00F << 16) | 0x0001
# Version 2 (native archives with >= FLOAT_ALIGN_MIN floats): raw sections
# start on 128-word (512 B) boundaries. Costs <= 3*512 B of zero padding
# per member; the layout is per-member self-describing via this magic.
_FLOAT_MAGIC_VERSION2 = (0xF00F << 16) | 0x0002
FLOAT_ALIGN_MIN = 1 << 20


def _r128(x):
    return ((x + 127) // 128) * 128


def _floats_capacity(W32: int, ft: FloatType) -> int:
    ws = FLOAT_WORD_SIZE[ft]
    return (W32 * 4) // ws


def _words32(n_floats: int, ft: FloatType) -> int:
    ws = FLOAT_WORD_SIZE[ft]
    return -(-(n_floats * ws) // 4)


def _section_word_counts(n, ft: FloatType):
    """Per-member uint32 word counts of the raw sections (each 16B aligned;
    reference: getUncompDataSize per type, GpuFloatUtils.cuh). Works on
    traced arrays and Python ints alike."""
    r = lambda x, m: -(-x // m) * m  # noqa: E731
    if ft in (FloatType.FLOAT16, FloatType.BFLOAT16):
        return r(n, 16) // 4, n * 0
    if ft == FloatType.FLOAT32:
        return r(n, 8) // 2, r(n, 16) // 4
    if ft == FloatType.FLOAT64:
        return r(n, 4), r(n, 8) // 2
    raise ValueError(ft)


def float_compress_core(
    data32: jax.Array,
    n: jax.Array,
    float_type: FloatType,
    prob_bits: int = 10,
    use_checksum: bool = False,
    native: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    """Compress uint32-packed float rows.

    data32: uint32[B, W32] packed float words; n: int32[B] float counts.
    Returns (out32 uint32[B, CWf], comp_bytes uint32[B]).

    native=True embeds ROW-STREAM (0xDB0D) ANS segments — the float header
    is unchanged and decoders dispatch on the embedded ANS magic.
    """
    ft = FloatType(float_type)
    B, W32 = data32.shape
    # the packed split deinterleaves lanes 2:1/4:1; pad rows so the strides
    # divide evenly (extra capacity is zero-masked everywhere)
    req = {
        FloatType.FLOAT16: 2, FloatType.BFLOAT16: 2,
        FloatType.FLOAT32: 4, FloatType.FLOAT64: 8,
    }[ft]
    if W32 % req:
        data32 = jnp.pad(data32, ((0, 0), (0, req - W32 % req)))
        W32 = data32.shape[1]
    S_cap = _floats_capacity(W32, ft)
    ws = FLOAT_WORD_SIZE[ft]
    n = n.astype(I32)

    comp_planes, raw_refs, hists, csum_f = split_hist_packed(
        data32, n, ft, archive=True
    )
    csum = csum_f if use_checksum else jnp.zeros((B,), U32)

    # ANS-encode each exponent plane (independent archives; fp64 has two —
    # RUN_ANS, GpuFloatCompress.cuh:807-869). One exponent byte per float
    # per plane, so the plane byte capacity is S_cap; the histograms were
    # accumulated during the split. The encoders return RUNS, not merged
    # buffers: the ANS archives are placed directly into the float archive
    # by the single merge below (the reference's FloatANSOutProvider points
    # the encoder at the float archive the same way,
    # GpuFloatCompress.cuh:807-869).
    seg_parts = []
    seg_bytes = []
    for plane, hist in zip(comp_planes, hists):
        parts = ans_encode_sections(
            plane, n, prob_bits, use_checksum=False, s_bytes=S_cap,
            hist=hist, native=native,
        )
        seg_parts.append(parts)
        seg_bytes.append(parts[5].astype(I32))
    nsegs = len(seg_parts)

    # raw sections arrive as tail-masked flat merge sources straight from
    # split_hist_packed's archive mode

    s1w, s2w = _section_word_counts(n, ft)
    # aligned (v2) layout per member: native streams + big enough to win
    is_al = (
        (n >= FLOAT_ALIGN_MIN) if native else jnp.zeros((B,), bool)
    )
    first_seg = seg_bytes[0] if nsegs > 1 else jnp.zeros((B,), I32)
    hdr = jnp.stack(
        [
            jnp.where(
                is_al, u32(_FLOAT_MAGIC_VERSION2), u32(_FLOAT_MAGIC_VERSION)
            ),
            n.astype(U32),
            jnp.full((B,), int(ft) | (int(use_checksum) << 4), U32),
            csum,
            first_seg.astype(U32),
            jnp.zeros((B,), U32),
            jnp.zeros((B,), U32),
            jnp.zeros((B,), U32),
        ],
        axis=1,
    )

    # region offsets (uint32 words, per member); v2 aligns section starts
    # to 128 words
    o_s1 = jnp.where(is_al, 128, 8)
    o1 = o_s1 + jnp.where(is_al, _r128(s1w), s1w)
    o2 = o1 + jnp.where(is_al, _r128(s2w), s2w)
    a1 = o2 + (seg_bytes[0] >> 2)
    end = a1 + ((seg_bytes[1] >> 2) if nsegs > 1 else 0)

    s1w_cap, s2w_cap = _section_word_counts(S_cap, ft)
    from ..core.constants import max_compressed_size as _mcs
    from ..ops.rans_encode import MAX_BLOCK_WORDS32 as _MBW

    NBp = max(1, -(-S_cap // BLOCK_SIZE))
    ans_tight = min(
        _mcs(S_cap),
        -(-(4 * 136 + 128 * NBp + 8 * ((NBp + 1) // 2 * 2)
            + 4 * _MBW * NBp) // 16) * 16,
    )
    tight = 4 * (8 + s1w_cap + s2w_cap + 3 * 128) + nsegs * ans_tight
    # row width a multiple of 128 words (every member's raw section
    # lands at dst % 128 == 8)
    CWf = min(max_float_compressed_size(ft, S_cap), tight) // 4
    CWf = -(-CWf // 128) * 128

    # archive assembly: ONE ragged multi-source runs-merge per batch
    # placing the float header, raw section(s), and every ANS segment's
    # header/blockWords/stream runs, ordered by destination within each
    # member.

    # ref 0: small metadata blob = float headers + each segment's
    # (header/pdf/states, blockWords) sections
    small_list = [hdr]
    seg_src_base = []
    acc = hdr.size
    for parts in seg_parts:
        seg_src_base.append(acc)
        small_list.extend(parts[0])
        acc += sum(s.size for s in parts[0])
    small_flat = jnp.concatenate([s.reshape(-1) for s in small_list])

    # refs 1..nsegs: per-segment stream staging; nsegs+1..: raw sections
    refs = [small_flat] + [parts[1] for parts in seg_parts] + [
        r[0] for r in raw_refs
    ]
    rid_sec = [(1 + nsegs + i) << _RSH for i in range(len(raw_refs))]

    b_ar = jnp.arange(B, dtype=I32)
    row0 = b_ar * CWf
    zeros = jnp.zeros((B,), I32)
    HW = hdr.shape[1]

    sec1_src = (rid_sec[0] + b_ar * raw_refs[0][1])[:, None]
    if len(raw_refs) == 1:
        dst_cols = [zeros[:, None], o_s1[:, None]]
        src_cols = [(b_ar * HW)[:, None], sec1_src]
        len_cols = [(zeros + 8)[:, None], s1w[:, None]]
    else:
        sec2_src = (rid_sec[1] + b_ar * raw_refs[1][1])[:, None]
        dst_cols = [zeros[:, None], o_s1[:, None], o1[:, None]]
        src_cols = [(b_ar * HW)[:, None], sec1_src, sec2_src]
        len_cols = [(zeros + 8)[:, None], s1w[:, None], s2w[:, None]]
    for si, parts in enumerate(seg_parts):
        a_dst, a_src, a_len = parts[2], parts[3], parts[4]
        base_col = o2 if si == 0 else a1
        # stream runs already carry refid 1; shift to refid 1+si.
        # metadata runs shift into the small blob at this seg's base
        is_stream = a_src >= (1 << _RSH)
        a_src = jnp.where(
            is_stream, a_src + (si << _RSH), a_src + seg_src_base[si]
        )
        dst_cols.append(a_dst + base_col[:, None])
        src_cols.append(a_src)
        len_cols.append(a_len)

    dst = (jnp.concatenate(dst_cols, axis=1) + row0[:, None]).reshape(-1)
    src = jnp.concatenate(src_cols, axis=1).reshape(-1)
    lens = jnp.concatenate(len_cols, axis=1).reshape(-1)

    out = runs_merge_multi(refs, dst, src, lens, B * CWf).reshape(
        B, CWf
    )

    comp_bytes = (4 * end).astype(U32)
    return out, comp_bytes


def float_decompress_core(
    comp32: jax.Array,
    base32: jax.Array,
    out_floats: int,
    float_type: FloatType,
    prob_bits: int = 10,
    capacities: Optional[jax.Array] = None,
    verify_checksum: bool = False,
    native: bool = False,
):
    """Decompress float archives at per-member uint32 offsets base32.

    Returns (words32 uint32[B, W32cap], success bool[B], n uint32[B],
    archive_checksum uint32[B], computed_checksum uint32[B] — zeros unless
    verify_checksum, which costs an extra pass over the output).

    native selects the embedded ANS segment layout (static — staging shapes
    differ); the API layer auto-detects it from the archive's ANS magic
    (api.codec.detect_native_layout).
    """
    ft = FloatType(float_type)
    B, CW = comp32.shape
    ws = FLOAT_WORD_SIZE[ft]
    base32 = base32.astype(I32)
    nseg = FLOAT_NUM_COMP_SEGMENTS[ft]

    def gat(idx):
        idx = jnp.clip(base32[:, None] + idx, 0, CW - 1)
        return jnp.take_along_axis(comp32, idx, axis=1)

    hdr = gat(jnp.broadcast_to(jnp.arange(8, dtype=I32), (B, 8)))
    n = hdr[:, 1].astype(I32)
    csum_arch = hdr[:, 3]
    first_seg = hdr[:, 4].astype(I32)

    # header validation, as the reference's float decompress kernel does
    # before touching any payload (GpuFloatDecompress.cuh:577-587 checks
    # magic+version and the declared float type): mismatches fold into
    # per-member success (size reported 0) rather than trapping. Version 2
    # = the 128-word-aligned native layout, decided per member.
    is_al = hdr[:, 0] == u32(_FLOAT_MAGIC_VERSION2)
    valid = (
        ((hdr[:, 0] == u32(_FLOAT_MAGIC_VERSION)) | is_al)
        & ((hdr[:, 2] & u32(0xF)) == u32(int(ft)))
        & (n >= 0)
    )
    n = jnp.where(valid, n, 0)
    is_al = is_al & valid
    first_seg = jnp.where(valid, first_seg, 0)

    if capacities is None:
        capacities = jnp.full((B,), out_floats, I32)
    success = valid & (n <= capacities.astype(I32))

    s1w, s2w = _section_word_counts(n, ft)
    o_s1 = jnp.where(is_al, 128, 8)
    o_s2 = o_s1 + jnp.where(is_al, _r128(s1w), s1w)
    ans_base0 = base32 + o_s2 + jnp.where(is_al, _r128(s2w), s2w)

    planes = []
    for seg in range(nseg):
        base = ans_base0 if seg == 0 else ans_base0 + (first_seg >> 2)
        plane, ok, psize, _ = ans_decode_core(
            comp32, base, out_floats, prob_bits, capacities, native=native
        )
        planes.append(plane)
        success = success & ok & (psize.astype(I32) == n)

    # raw section extraction into dense staging (one ragged runs-merge;
    # masked to n at the float level below)
    S1W_cap, S2W_cap = _section_word_counts(out_floats, ft)
    C1 = max(S1W_cap, 1)
    C2 = max(S2W_cap, 1)
    b_ar = jnp.arange(B, dtype=I32)
    abs_base = b_ar * CW + base32
    dst = jnp.concatenate([b_ar * C1, B * C1 + b_ar * C2])
    src = jnp.concatenate([abs_base + o_s1, abs_base + o_s2])
    lens = jnp.concatenate([jnp.minimum(s1w, C1), jnp.minimum(s2w, C2)])
    stage = runs_merge(comp32.reshape(-1), dst, src, lens, B * (C1 + C2))
    sec1_32 = stage[: B * C1].reshape(B, C1)
    sec2_32 = stage[B * C1 :].reshape(B, C2)

    # join in packed uint32 lanes: planes are already packed exponent bytes
    # (zeros beyond n from the ANS decoder), sections are archive-exact
    # (zeros in their alignment tails). E = exponent-plane words per member.
    E = max(-(-out_floats // 4), 1)
    if ft in (FloatType.FLOAT16, FloatType.BFLOAT16):
        secs = [sec1_32[:, :E]]
    elif ft == FloatType.FLOAT32:
        secs = [sec1_32[:, : 2 * E], sec2_32[:, :E]]
    else:
        secs = [sec1_32[:, : 4 * E], sec2_32[:, : 2 * E]]
    comp_planes = [p[:, :E] for p in planes]
    words32 = join_packed(comp_planes, secs, ft)
    # planes and sections are zero beyond n by construction; one select
    # zeroes failed members (mask_packed_bytes here was ~0.3 ms/16 MiB)
    words32 = jnp.where(success[:, None], words32, u32(0))

    csum_got = (
        checksum_packed(words32, n * ws)
        if verify_checksum
        else jnp.zeros((B,), U32)
    )
    return words32, success, n.astype(U32), csum_arch, csum_got


def float_compress_padded(
    data32: jax.Array,
    n: jax.Array,
    float_type: FloatType,
    prob_bits: int = 10,
    use_checksum: bool = False,
    out_bytes: Optional[int] = None,
    native: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    """uint8-row wrapper with the reference's getMaxFloatCompressedSize
    output-buffer contract."""
    ft = FloatType(float_type)
    out32, comp_bytes = float_compress_core(
        data32, n, ft, prob_bits, use_checksum, native=native
    )
    comp = bitcast_u32_to_u8(out32)
    cb = (
        out_bytes
        if out_bytes is not None
        else max_float_compressed_size(ft, _floats_capacity(data32.shape[1], ft))
    )
    if comp.shape[1] < cb:
        comp = jnp.pad(comp, ((0, 0), (0, cb - comp.shape[1])))
    return comp, comp_bytes


def float_get_compressed_info(comp_u8: jax.Array):
    """Header read: (sizes in float words, float types, stored checksums)
    (reference: GpuFloatInfo.cuh:18-62)."""
    from ..ops.bitops import bitcast_u8_to_u32

    h = bitcast_u8_to_u32(comp_u8[:, :16])
    return h[:, 1], h[:, 2] & u32(0xF), h[:, 3]
