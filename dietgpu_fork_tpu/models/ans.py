"""Batched ANS codec pipelines: archive assembly and parsing on device.

This is the equivalent of ansEncodeBatchDevice / ansDecodeBatch
(GpuANSEncode.cuh:670-845, GpuANSDecode.cuh:478-596). Everything is
static-shape and jit-friendly:

* Batch members live in rows of a padded (B, S) matrix with an explicit
  sizes vector — the reference's Stride calling convention. Pointer and
  SplitSize conventions are host-side wrappers (api/codec.py).
* Archive layout offsets depend on the dynamic per-member block count, so
  assembly and parsing are expressed as ragged runs (header / probs /
  states / blockWords / per-block streams) executed by the runs-merge
  gather (ops/merge.py).
* Compressed outputs are zero-padded to the worst-case row size given by
  ``max_compressed_size`` — same buffer contract as the reference API, but
  with deterministic (zero) padding instead of garbage.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..core.constants import (
    BLOCK_SIZE,
    NUM_SYMBOLS,
    max_compressed_size,
)
from ..ops.bitops import bitcast_u32_to_u8, bitcast_u8_to_u32, u32
from ..ops.checksum import checksum_packed, mask_packed_bytes
from ..ops.histogram import histogram_packed
from ..ops.merge import _RSH, runs_merge, runs_merge_multi
from ..ops.rans_decode import decode_blocks, decode_blocks_rows
from ..ops.rans_encode import (
    MAX_BLOCK_WORDS32,
    MAX_ROW_WORDS32,
    encode_blocks,
    encode_blocks_rows,
)
from ..ops.table import (
    build_decode_table_batched,
    normalize_probs_batched,
    pack_encode_table,
)

I32 = jnp.int32
U32 = jnp.uint32

_ANS_MAGIC_VERSION = (0xD00D << 16) | 0x0001
# ROW-STREAM layout (opt-in; versioned via the header's
# magic+version word exactly as the reference's mechanism allows,
# GpuANSUtils.cuh:52-55). Executable spec: core/reference.py
# ans_encode_native / ans_decode_native.
_ANS_MAGIC_NATIVE_VERSION = (0xDB0D << 16) | 0x0001
_META_WORDS = 136  # header (8) + packed pdf table (128)


def _num_blocks_dyn(sizes: jax.Array) -> jax.Array:
    return -(-sizes.astype(I32) // BLOCK_SIZE)


def _layout(nb: jax.Array):
    """Per-member uint32 section offsets given dynamic block counts."""
    bw_off = _META_WORDS + 32 * nb
    data_off = bw_off + 2 * (((nb + 1) // 2) * 2)
    return bw_off, data_off


def ans_encode_sections(
    x32: jax.Array,
    sizes: jax.Array,
    prob_bits: int = 10,
    use_checksum: bool = False,
    hist: Optional[jax.Array] = None,
    s_bytes: Optional[int] = None,
    hist_totals: Optional[jax.Array] = None,
    native: bool = False,
):
    """Encode and return the archive as runs instead of merging them.

    Returns (small_sections, stream_ref, dst_rel, src_rel, lens,
    comp_bytes):

    * ``small_sections`` — list of uint32 arrays whose flattened
      concatenation is the metadata run source (headers, pdf tables,
      states, blockWords pairs);
    * ``stream_ref`` — flat uint32 view of the encoder's compressed-stream
      staging buffer, addressed DIRECTLY by the archive merge
      (runs_merge_multi) with no intermediate copy;
    * (dst_rel, src_rel, lens) — int32[B, 2+N] per-member run columns:
      dst_rel relative to the member's archive word start (ascending
      within a member); src_rel is a metadata-blob offset, or
      (1 << merge._RSH) | stream word offset for stream runs.

    Callers place the blob/ref anywhere in a larger merge and the archive
    anywhere in a larger destination (the float codec fuses this into its
    own archive merge, saving a full intermediate archive write+read — the
    reference instead points the ANS encoder's OutProvider at the float
    archive, GpuFloatCompress.cuh:807-869).
    """
    B, W = x32.shape
    S = s_bytes if s_bytes is not None else 4 * W
    NB = max(1, -(-S // BLOCK_SIZE))
    sizes = sizes.astype(I32)

    if hist is None:
        hist = histogram_packed(x32, sizes)
    norm_tot = sizes if hist_totals is None else hist_totals.astype(I32)
    pdf, cdf, magic, shift = normalize_probs_batched(hist, norm_tot, prob_bits)

    csum = (
        checksum_packed(x32, sizes)
        if use_checksum
        else jnp.zeros((B,), U32)
    )

    pad = NB * (BLOCK_SIZE // 4) - W
    xp = jnp.pad(x32, ((0, 0), (0, pad))) if pad else x32

    packed = pack_encode_table(pdf, cdf, shift)
    walk = encode_blocks_rows if native else encode_blocks
    states, streams32, num_words = walk(xp, sizes, packed, magic, prob_bits)
    k1 = streams32.shape[2]
    blk_stride = streams32.shape[1]

    nb = _num_blocks_dyn(sizes)
    NR = -(-NB // 4)
    if native:
        # 16B-aligned exclusive prefix per ROW of 4 blocks; blockWords.y
        # holds the row start, duplicated across the row's blocks
        nw4 = jnp.pad(num_words, ((0, 0), (0, 4 * NR - NB)))
        row_words = nw4.reshape(B, NR, 4).sum(axis=2)
        aligned = ((row_words + 7) // 8) * 8
        incl = jnp.cumsum(aligned, axis=1)
        row_prefix = incl - aligned
        prefix = jnp.repeat(row_prefix, 4, axis=1)[:, :NB]
    else:
        # aligned exclusive prefix of per-block word counts (16B = 8 words)
        aligned = ((num_words + 7) // 8) * 8
        incl = jnp.cumsum(aligned, axis=1)
        prefix = incl - aligned
    total_words = incl[:, -1].astype(U32)

    blk = jnp.arange(NB, dtype=I32)[None, :]
    uncomp_w = jnp.clip(
        sizes[:, None] - blk * BLOCK_SIZE, 0, BLOCK_SIZE
    ).astype(U32)

    options = u32(prob_bits | (int(use_checksum) << 4))
    magic_word = _ANS_MAGIC_NATIVE_VERSION if native else _ANS_MAGIC_VERSION
    hdr8 = jnp.stack(
        [
            jnp.full((B,), magic_word, U32),
            nb.astype(U32),
            sizes.astype(U32),
            total_words,
            jnp.broadcast_to(options, (B,)),
            csum,
            jnp.zeros((B,), U32),
            jnp.zeros((B,), U32),
        ],
        axis=1,
    )

    bw_off, data_off = _layout(nb)
    comp_bytes = (4 * data_off + 2 * total_words.astype(I32)).astype(U32)

    # run source blob (the ansEncodeCoalesce layout, GpuANSEncode.cuh:511-624)
    probs16 = pdf[:, 0::2] | (pdf[:, 1::2] << u32(16))
    meta_src = jnp.concatenate(
        [hdr8, probs16, states.reshape(B, NB * 32)], axis=1
    )
    MW = meta_src.shape[1]
    bw_x = (uncomp_w.astype(U32) << u32(16)) | num_words.astype(U32)
    live = blk < nb[:, None]
    pairs = jnp.stack(
        [jnp.where(live, bw_x, u32(0)),
         jnp.where(live, prefix.astype(U32), u32(0))], axis=2
    ).reshape(B, 2 * NB)
    PW = pairs.shape[1]
    small_sections = [meta_src, pairs]
    off_pairs = B * MW

    b_ar = jnp.arange(B, dtype=I32)
    dstA = jnp.zeros((B, 1), I32)
    srcA = (b_ar * MW)[:, None]
    lenA = (_META_WORDS + 32 * nb)[:, None]
    dstB = bw_off[:, None]
    srcB = (off_pairs + b_ar * PW)[:, None]
    lenB = (2 * nb)[:, None]
    stream_tag = 1 << _RSH
    if native:
        # one tightly-packed stream segment per ROW: 4x fewer merge pieces
        row_ar = jnp.arange(NR, dtype=I32)[None, :]
        row_live = row_ar < (-(-nb // 4))[:, None]
        dstC = data_off[:, None] + (row_prefix.astype(I32) >> 1)
        srcC = stream_tag + (b_ar[:, None] * blk_stride + row_ar) * k1
        lenC = jnp.where(row_live, (row_words + 1) >> 1, 0)
    else:
        dstC = data_off[:, None] + (prefix.astype(I32) >> 1)
        srcC = stream_tag + (b_ar[:, None] * blk_stride + blk) * k1
        lenC = jnp.where(live, (num_words + 1) >> 1, 0)

    dst_rel = jnp.concatenate([dstA, dstB, dstC], axis=1)
    src_rel = jnp.concatenate([srcA, srcB, srcC], axis=1)
    lens = jnp.concatenate([lenA, lenB, lenC], axis=1)
    return (
        small_sections, streams32.reshape(-1), dst_rel, src_rel, lens,
        comp_bytes,
    )


def ans_encode_core(
    x32: jax.Array,
    sizes: jax.Array,
    prob_bits: int = 10,
    use_checksum: bool = False,
    hist: Optional[jax.Array] = None,
    s_bytes: Optional[int] = None,
    hist_totals: Optional[jax.Array] = None,
    native: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    """Compress batch rows to coalesced ANS archives in uint32 words.

    x32: uint32[B, ceil(S/4)] packed row bytes (little-endian); sizes:
    int32[B] valid byte counts; s_bytes: row byte capacity (default 4*W).

    hist: optional caller-supplied uint32[B, 256] byte histograms — skips
    the statistics pass, as every reference encode entry point allows
    (GpuANSCodec.h:82-84, GpuANSEncode.cuh:688-697). By reference semantics
    the histogram is normalized against the member's own byte count;
    hist_totals overrides that normalization total (int32[B]) so several
    shards can quantize one shared histogram identically — the hook for the
    distributed shared-frequency-table mode (parallel/sharded.py).

    Returns (out32 uint32[B, CW_tight], comp_bytes uint32[B]).
    """
    B, W = x32.shape
    S = s_bytes if s_bytes is not None else 4 * W
    NB = max(1, -(-S // BLOCK_SIZE))
    smalls, stream, dst_rel, src_rel, lens, comp_bytes = (
        ans_encode_sections(
            x32, sizes, prob_bits, use_checksum, hist, s_bytes=S,
            hist_totals=hist_totals, native=native,
        )
    )

    # tight buffer: metadata + fully incompressible streams for NB blocks
    tight_need = (
        4 * _META_WORDS + 128 * NB + 8 * ((NB + 1) // 2 * 2)
        + 4 * MAX_BLOCK_WORDS32 * NB
    )
    tight = min(max_compressed_size(S), -(-tight_need // 16) * 16)
    out_words = tight // 4

    small_flat = jnp.concatenate([s.reshape(-1) for s in smalls])
    row0 = (jnp.arange(B, dtype=I32) * out_words)[:, None]
    out = runs_merge_multi(
        (small_flat, stream),
        (dst_rel + row0).reshape(-1),
        src_rel.reshape(-1),
        lens.reshape(-1),
        B * out_words,
    )
    return out.reshape(B, out_words), comp_bytes


def ans_encode_padded(
    x_u8: jax.Array,
    sizes: jax.Array,
    prob_bits: int = 10,
    use_checksum: bool = False,
    hist: Optional[jax.Array] = None,
    out_bytes: Optional[int] = None,
    hist_totals: Optional[jax.Array] = None,
    native: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    """Byte-row wrapper around ans_encode_core with the reference's
    ``max_compressed_size`` output-buffer contract (zero padded)."""
    S = x_u8.shape[1]
    pad = (-S) % 4
    if pad:
        x_u8 = jnp.pad(x_u8, ((0, 0), (0, pad)))
    x32 = mask_packed_bytes(bitcast_u8_to_u32(x_u8), sizes.astype(I32))
    out32, comp_bytes = ans_encode_core(
        x32, sizes, prob_bits, use_checksum, hist, s_bytes=S,
        hist_totals=hist_totals, native=native,
    )
    comp = bitcast_u32_to_u8(out32)
    cb = out_bytes if out_bytes is not None else max_compressed_size(S)
    if comp.shape[1] < cb:
        comp = jnp.pad(comp, ((0, 0), (0, cb - comp.shape[1])))
    return comp, comp_bytes


def _ans_parse_and_stage(
    comp32: jax.Array,
    base32: jax.Array,
    out_capacity: int,
    capacities: Optional[jax.Array],
    prob_bits: int,
    native: bool = False,
):
    """Shared decode front half: header parse + validation, capacity check,
    and the states/stream staging merge (streams start-aligned per block or
    row). Returns (streams, comp_w, uncomp_w, states, pdf, success, n,
    csum, NB).

    Header validation mirrors the reference's decode-side asserts
    (GpuANSUtils.cuh:109-112 magic+version, GpuANSDecode.cuh:323 probBits)
    but folds failures into per-member ``success`` instead of trapping:
    wrong magic/version, probBits mismatch, inconsistent block count, or a
    claimed archive extent beyond the buffer row all mark the member failed
    (size reported as 0) and zero its staging, so garbage input can never
    come back as success=True."""
    B, CW = comp32.shape
    NB = max(1, -(-out_capacity // BLOCK_SIZE))
    base32 = base32.astype(I32)

    def row_gather(idx):
        idx = jnp.clip(base32.reshape(B, *([1] * (idx.ndim - 1))) + idx, 0, CW - 1)
        return jnp.take_along_axis(comp32, idx.reshape(B, -1), axis=1).reshape(
            idx.shape
        )

    hdr = row_gather(jnp.broadcast_to(jnp.arange(8, dtype=I32), (B, 8)))
    nb_arch = hdr[:, 1].astype(I32)
    n = hdr[:, 2].astype(I32)
    total_w = hdr[:, 3].astype(I32)
    options = hdr[:, 4]
    csum = hdr[:, 5]

    magic_ok = hdr[:, 0] == u32(
        _ANS_MAGIC_NATIVE_VERSION if native else _ANS_MAGIC_VERSION
    )
    pb_ok = (options & u32(0xF)) == u32(prob_bits)
    struct_ok = (n >= 0) & (total_w >= 0) & (nb_arch == _num_blocks_dyn(n))
    nb_safe = jnp.clip(nb_arch, 0, 1 << 24)
    _, data_off_arch = _layout(nb_safe)
    fits = base32 + data_off_arch + ((total_w + 1) >> 1) <= CW
    valid = magic_ok & pb_ok & struct_ok & fits
    n = jnp.where(valid, n, 0)
    nb_arch = jnp.where(valid, nb_arch, 0)

    if capacities is None:
        capacities = jnp.full((B,), out_capacity, I32)
    success = valid & (n <= capacities.astype(I32))

    # unpack pdf table
    pw = row_gather(jnp.broadcast_to(8 + jnp.arange(128, dtype=I32), (B, 128)))
    pdf = jnp.stack([pw & u32(0xFFFF), pw >> u32(16)], axis=2).reshape(
        B, NUM_SYMBOLS
    )

    # decodable blocks: those that fit the output buffer
    nb = jnp.minimum(nb_arch, NB)
    blk = jnp.arange(NB, dtype=I32)[None, :]
    live = (blk < nb[:, None]) & success[:, None]

    flat = comp32.reshape(-1)
    b_ar = jnp.arange(B, dtype=I32)
    abs_base = b_ar * CW + base32

    # blockWords are needed to COMPUTE the stream runs, so they come from a
    # row gather; the states ride the stream staging merge below
    bw_off, data_off = _layout(nb_arch)
    SM = 32 * NB
    bw = row_gather(
        bw_off[:, None] + jnp.arange(2 * NB, dtype=I32)[None, :]
    ).reshape(B, NB, 2)

    bx, by = bw[:, :, 0], bw[:, :, 1]
    uncomp_w = jnp.where(live, (bx >> u32(16)).astype(I32), 0)
    comp_w = jnp.where(live, (bx & u32(0xFFFF)).astype(I32), 0)
    starts = jnp.where(live, by.astype(I32), 0)

    # Validate archive-supplied blockWords against the format before they
    # feed staging offsets: comp_w is bounded by the worst-case block
    # stream (2*MAX_BLOCK_WORDS32 u16 words), uncomp_w must EQUAL the
    # header-derived block fill (the encoder always writes exactly
    # clip(n - blk*4096, 0, 4096) — requiring it means decoded outputs are
    # zero beyond n by construction, so callers can skip byte-granular
    # output masking), and every block's stream extent must lie inside the
    # header-declared total (already bounds-checked against the buffer).
    # A corrupt count would otherwise push the staging runs out of their
    # per-segment windows and violate runs_merge's non-overlapping-
    # destination precondition; fold it into per-member success instead.
    uw_expect = jnp.clip(n[:, None] - blk * BLOCK_SIZE, 0, BLOCK_SIZE)
    blk_ok = (
        ~live
        | (
            (comp_w <= 2 * MAX_BLOCK_WORDS32)
            & (uncomp_w == uw_expect)
            & (starts >= 0)
            & (starts + comp_w <= total_w[:, None])
        )
    )
    success = success & jnp.all(blk_ok, axis=1)
    live = live & success[:, None]
    uncomp_w = jnp.where(live, uncomp_w, 0)
    comp_w = jnp.where(live, comp_w, 0)
    starts = jnp.where(live, starts, 0)

    # stream staging. Classic: each block's compressed words into dense
    # (B, NB, SW) rows (uint16 word k of a block lives at staged word k>>1,
    # half k&1). Native row-stream: ONE segment per row of 4 blocks —
    # 4x fewer merge pieces — staged into (B, NR, SW) with the row's word
    # count. Both start-aligned.
    if native:
        NR = -(-NB // 4)
        cw4 = jnp.pad(comp_w, ((0, 0), (0, 4 * NR - NB))).reshape(B, NR, 4)
        seg_words = cw4.sum(axis=2)  # u16 words per row stream
        # blockWords.y duplicates the row start across the row's blocks
        seg_starts = starts[:, 0::4]
        NSEG, MAXW = NR, MAX_ROW_WORDS32
        seg_idx = jnp.arange(NR, dtype=I32)[None, :]
    else:
        seg_words, seg_starts = comp_w, starts
        NSEG, MAXW = NB, MAX_BLOCK_WORDS32
        seg_idx = blk
    # Per-SEGMENT extent check: a native row aggregates 4 blocks' counts,
    # so the per-block bound above does not imply the row stream stays
    # inside the declared total. (Redundant for classic; cheap.)
    seg_ok = jnp.all(seg_starts + seg_words <= total_w[:, None], axis=1)
    success = success & seg_ok
    dead = ~success[:, None]
    seg_words = jnp.where(dead, 0, seg_words)
    seg_starts = jnp.where(dead, 0, seg_starts)
    comp_w = jnp.where(dead, 0, comp_w)
    uncomp_w = jnp.where(dead, 0, uncomp_w)
    r_flat = (b_ar[:, None] * NSEG + seg_idx).reshape(-1)
    src2 = ((abs_base + data_off)[:, None] + (seg_starts >> 1)).reshape(-1)
    len2 = ((seg_words + 1) >> 1).reshape(-1)
    SW = MAXW + 8
    dst2 = r_flat * SW
    SB = B * NSEG * SW  # stream region, then the states region
    dst_all = jnp.concatenate([dst2, SB + b_ar * SM])
    src_all = jnp.concatenate([src2, abs_base + _META_WORDS])
    len_all = jnp.concatenate([len2, 32 * nb])
    stage = runs_merge(flat, dst_all, src_all, len_all, SB + B * SM)
    streams = stage[:SB].reshape(B, NSEG, SW)
    states = stage[SB:].reshape(B, NB, 32)
    return streams, comp_w, uncomp_w, states, pdf, success, n, csum, NB


def ans_decode_core(
    comp32: jax.Array,
    base32: jax.Array,
    out_capacity: int,
    prob_bits: int = 10,
    capacities: Optional[jax.Array] = None,
    native: bool = False,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Decode ANS archives located at per-member uint32 offsets ``base32``
    within the rows of ``comp32`` (the float codec places its ANS segments at
    dynamic offsets past headers and raw sections).

    Returns (out32 uint32[B, ceil(out_capacity/4)] packed decoded bytes
    (zeros beyond the decoded size), success bool[B], sizes uint32[B],
    archive_checksum uint32[B]). Mirrors ansDecodeKernel's capacity check:
    members whose decoded size exceeds capacity fail and report the required
    size (GpuANSDecode.cuh:326-337).
    """
    B = comp32.shape[0]
    streams, comp_w, uncomp_w, states, pdf, success, n, csum, NB = (
        _ans_parse_and_stage(
            comp32, base32, out_capacity, capacities, prob_bits,
            native=native,
        )
    )
    lut = build_decode_table_batched(pdf, prob_bits)
    walk = decode_blocks_rows if native else decode_blocks
    out_blocks = walk(streams, comp_w, uncomp_w, states, lut, prob_bits)
    OW = -(-out_capacity // 4)
    out32 = out_blocks.reshape(B, NB * (BLOCK_SIZE // 4))[:, :OW]
    # zeros beyond n are guaranteed by construction (decode lanes beyond a
    # block's validated uncomp_w emit 0), so the byte-granular tail mask
    # reduces to one per-member select for failed members — the full
    # mask_packed_bytes here cost ~0.3 ms per 16 MiB of pure glue
    out32 = jnp.where(success[:, None], out32, u32(0))
    return out32, success, n.astype(U32), csum


def ans_decode_padded(
    comp_u8: jax.Array,
    out_capacity: int,
    prob_bits: int = 10,
    capacities: Optional[jax.Array] = None,
    native: bool = False,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Byte-row wrapper around ans_decode_core (archives at row starts;
    output unpacked back to uint8 rows)."""
    B = comp_u8.shape[0]
    comp32 = bitcast_u8_to_u32(comp_u8)
    out32, success, n, csum = ans_decode_core(
        comp32, jnp.zeros((B,), I32), out_capacity, prob_bits, capacities,
        native=native,
    )
    out = bitcast_u32_to_u8(out32)[:, :out_capacity]
    return out, success, n, csum


def ans_get_compressed_info(comp_u8: jax.Array):
    """Read sizes and stored checksums from archive headers
    (reference: GpuANSInfo.cuh:16-37)."""
    comp32 = bitcast_u8_to_u32(comp_u8[:, :32])
    return comp32[:, 2], comp32[:, 5]
