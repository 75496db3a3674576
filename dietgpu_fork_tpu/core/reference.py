"""Bit-exact NumPy oracle for the dietgpu archive format.

This is the executable specification of the codec: a slow but vectorized
NumPy implementation of the 32-state interleaved rANS coder, the float split
codecs, and the sparse codec, producing byte-identical archives to what the
JAX implementation must emit. The CUDA reference has no such oracle; all of
its tests are GPU round-trips. Having one lets every device path be
asserted byte-for-byte on CPU.

Semantics are transcribed from the CUDA reference (citations inline). Two
reference quirks are handled explicitly:

* ``normalize_probs``: when the quantized pdf undershoots the target sum, the
  reference adds +1 to symbols whose *symbol id* (not sorted rank) is below
  the remaining diff (GpuANSStatistics.cuh:261-273 uses ``tidSymbol`` in the
  comparison). This is replicated exactly, since archives must match.
* Uninitialized padding in the reference (stack garbage in unused header
  fields and block padding) is defined as zero here, making archives
  deterministic. Round-trip behavior is unaffected.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .constants import (
    ANS_ENCODED_MASK,
    ANS_MIN_STATE,
    ANS_START_STATE,
    ANS_STATE_BITS,
    BLOCK_SIZE,
    FLOAT_NUM_COMP_SEGMENTS,
    NUM_SYMBOLS,
    SPARSE_HEADER_BYTES,
    STEPS_PER_BLOCK,
    WARP_SIZE,
    FloatType,
    ans_compressed_overhead,
    div_up,
    FLOAT_ALIGN_MIN,
    float_uncomp_data_size,
    num_blocks,
    round_up,
    sparse_bitmap_bytes,
)
from .format import (
    ANSHeader,
    FloatHeader,
    SparseFloatHeader,
    pack_block_words,
    unpack_block_words,
)

U32 = np.uint32
U64 = np.uint64


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def checksum(data: np.ndarray) -> int:
    """XOR-fold checksum over bytes. The reference folds uint32 loads down to
    8 bits, which is equivalent to XOR of all input bytes
    (reference: GpuChecksum.cuh:26-93)."""
    data = np.asarray(data, dtype=np.uint8)
    if data.size == 0:
        return 0
    return int(np.bitwise_xor.reduce(data))


def _umulhi(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return ((a.astype(U64) * b.astype(U64)) >> U64(32)).astype(U32)


def _clz32(x: np.ndarray) -> np.ndarray:
    """Count leading zeros of uint32 (clz(0) == 32, as CUDA __clz)."""
    x = np.asarray(x, dtype=U64)
    # bit_length via log-free method: position of highest set bit
    n = np.zeros(x.shape, dtype=np.int64)
    v = x.copy()
    for shift in (16, 8, 4, 2, 1):
        ge = v >= (U64(1) << U64(shift))
        n = np.where(ge, n + shift, n)
        v = np.where(ge, v >> U64(shift), v)
    bitlen = np.where(x > 0, n + 1, 0)
    return (32 - bitlen).astype(np.int64)


def histogram(data: np.ndarray) -> np.ndarray:
    data = np.asarray(data, dtype=np.uint8)
    return np.bincount(data, minlength=NUM_SYMBOLS).astype(U32)


# ---------------------------------------------------------------------------
# Probability normalization / encode table
# (reference: GpuANSStatistics.cuh:178-367)
# ---------------------------------------------------------------------------


def normalize_probs(
    counts: np.ndarray, total: int, prob_bits: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Quantize a 256-bin histogram so probabilities sum to exactly
    2^prob_bits, and derive magic-multiply division constants.

    Returns (pdf, cdf, magic, shift), each uint32[256].
    """
    assert total > 0
    counts = np.asarray(counts, dtype=U32)
    target = U32(1) << U32(prob_bits)

    # First-pass quantization in float32 (exact C semantics: float division,
    # float multiply, truncating uint cast) — GpuANSStatistics.cuh:215.
    q = (
        np.float32(target) * (counts.astype(np.float32) / np.float32(total))
    ).astype(U32)
    q = np.where((counts > 0) & (q == 0), U32(1), q)
    qsum = int(q.sum())

    # Descending sort of (qProb << 16 | symbol); all packed keys are unique
    # so this exactly matches cub radix SortDescending tie behavior
    # (GpuANSStatistics.cuh:229-241).
    packed = (q.astype(U32) << U32(16)) | np.arange(NUM_SYMBOLS, dtype=U32)
    order = np.argsort(packed)[::-1]
    sorted_sym = (packed[order] & U32(0xFFFF)).astype(np.int64)
    sorted_prob = (packed[order] >> U32(16)).astype(np.int64)

    diff = int(target) - qsum
    if diff > 0:
        # Reference quirk: bumps symbols whose *id* is < iterToApply
        # (GpuANSStatistics.cuh:261-273).
        while diff > 0:
            iter_to_apply = min(diff, NUM_SYMBOLS)
            sorted_prob = np.where(
                sorted_sym < iter_to_apply, sorted_prob + 1, sorted_prob
            )
            diff -= iter_to_apply
    elif diff < 0:
        # Subtract 1 from the smallest values that are > 1, by sorted rank
        # (GpuANSStatistics.cuh:274-315).
        diff = -diff
        ranks = np.arange(NUM_SYMBOLS)
        while diff > 0:
            num_gt1 = int((sorted_prob > 1).sum())
            iter_to_apply = min(diff, num_gt1)
            assert iter_to_apply > 0, "cannot normalize: no weights > 1 left"
            start = num_gt1 - iter_to_apply
            sorted_prob = np.where(
                (ranks >= start) & (ranks < num_gt1), sorted_prob - 1, sorted_prob
            )
            diff -= iter_to_apply

    pdf = np.zeros(NUM_SYMBOLS, dtype=U32)
    pdf[sorted_sym] = sorted_prob.astype(U32)
    cdf = np.zeros(NUM_SYMBOLS, dtype=U32)
    cdf[1:] = np.cumsum(pdf)[:-1].astype(U32)

    # Magic-multiply division constants (GpuANSStatistics.cuh:345-358):
    #   shift = 32 - clz(pdf - 1); magic = (2^32 * (2^shift - pdf)) / pdf + 1
    # pdf == 0 entries are never used during encode; leave magic/shift 0.
    pdf_i = pdf.astype(np.int64)
    shift = np.where(pdf_i > 0, 32 - _clz32((pdf_i - 1) & 0xFFFFFFFF), 0)
    magic = np.zeros(NUM_SYMBOLS, dtype=U32)
    for s in np.nonzero(pdf_i > 0)[0]:
        p = int(pdf_i[s])
        sh = int(shift[s])
        magic[s] = (((1 << 32) * ((1 << sh) - p)) // p + 1) & 0xFFFFFFFF
    return pdf, cdf, magic, shift.astype(U32)


def build_decode_table(pdf: np.ndarray, prob_bits: int) -> np.ndarray:
    """Expand pdf into the 2^prob_bits-entry decode LUT; each entry packs
    ((slot - cdf[sym]) << 20) | (pdf[sym] << 8) | sym
    (reference: GpuANSDecode.cuh:34-41, 405-476)."""
    pdf = np.asarray(pdf, dtype=U32)
    cdf = np.zeros(NUM_SYMBOLS, dtype=U32)
    cdf[1:] = np.cumsum(pdf)[:-1].astype(U32)
    nbuckets = 1 << prob_bits
    slots = np.arange(nbuckets, dtype=U32)
    # symbol owning each slot: searchsorted over cumulative boundaries
    bounds = np.cumsum(pdf.astype(np.int64))
    sym = np.searchsorted(bounds, slots, side="right").astype(U32)
    sym = np.minimum(sym, NUM_SYMBOLS - 1).astype(U32)
    within = slots - cdf[sym]
    return ((within << U32(20)) | (pdf[sym] << U32(8)) | sym).astype(U32)


# ---------------------------------------------------------------------------
# ANS encode (reference: GpuANSEncode.cuh)
# ---------------------------------------------------------------------------


def _encode_walk(
    data: np.ndarray,
    pdf: np.ndarray,
    cdf: np.ndarray,
    magic: np.ndarray,
    shift: np.ndarray,
    prob_bits: int,
):
    """Run the interleaved 32-state rANS coder over all blocks of one input.

    Returns (final_states (nb,32) u32, words (STEPS, nb, 32) u16 raw
    emission values, mask (STEPS, nb, 32) bool emission flags) — the
    pre-compaction walk shared by the classic (per-block streams) and
    native (per-row streams) archive layouts.
    Vectorized over blocks; sequential over the 128 steps, mirroring
    encodeOneWarp/encodeOnePartialWarp (GpuANSEncode.cuh:50-136).
    """
    n = data.size
    nb = num_blocks(n)
    padded = np.zeros(nb * BLOCK_SIZE, dtype=np.uint8)
    padded[:n] = data
    x = padded.reshape(nb, STEPS_PER_BLOCK, WARP_SIZE)
    idx = np.arange(nb * BLOCK_SIZE).reshape(nb, STEPS_PER_BLOCK, WARP_SIZE)
    valid = idx < n

    states = np.full((nb, WARP_SIZE), ANS_START_STATE, dtype=U32)
    words = np.zeros((STEPS_PER_BLOCK, nb, WARP_SIZE), dtype=np.uint16)
    mask = np.zeros((STEPS_PER_BLOCK, nb, WARP_SIZE), dtype=bool)

    state_check_shift = U32(ANS_STATE_BITS - prob_bits)
    prob_mul = U32(1) << U32(prob_bits)

    for step in range(STEPS_PER_BLOCK):
        sym = x[:, step, :]
        v = valid[:, step, :]
        p = pdf[sym]
        c = cdf[sym]
        m = magic[sym]
        sh = np.minimum(shift[sym], U32(31))

        write = v & (states >= (p << state_check_shift))
        words[step] = (states & U32(ANS_ENCODED_MASK)).astype(np.uint16)
        mask[step] = write
        states = np.where(write, states >> U32(16), states)

        t = _umulhi(states, m)
        dv = (t + states) >> sh
        mod = states - dv * p
        states = np.where(v, dv * prob_mul + mod + c, states)

    return states, words, mask


def _encode_blocks(
    data: np.ndarray,
    pdf: np.ndarray,
    cdf: np.ndarray,
    magic: np.ndarray,
    shift: np.ndarray,
    prob_bits: int,
):
    """Classic layout: compact emissions per BLOCK in (step, lane) order.

    Returns (final_states (nb,32) u32, streams (nb, maxw) u16,
    num_words (nb,) int64)."""
    nb = num_blocks(data.size)
    states, words, mask = _encode_walk(data, pdf, cdf, magic, shift, prob_bits)

    flat_mask = mask.transpose(1, 0, 2).reshape(nb, BLOCK_SIZE)
    flat_words = words.transpose(1, 0, 2).reshape(nb, BLOCK_SIZE)
    nwords = flat_mask.sum(axis=1).astype(np.int64)
    maxw = int(nwords.max()) if nb > 0 else 0
    streams = np.zeros((nb, max(maxw, 1)), dtype=np.uint16)
    for b in range(nb):
        streams[b, : nwords[b]] = flat_words[b][flat_mask[b]]
    return states, streams, nwords


def ans_encode(
    data: np.ndarray,
    prob_bits: int = 10,
    use_checksum: bool = False,
    hist: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Compress a byte array to a coalesced ANS archive. Returns uint8 bytes
    of exactly the reported compressed size (always a 16B multiple after the
    header sections, padded with zeros)."""
    data = np.ascontiguousarray(data, dtype=np.uint8).ravel()
    n = data.size
    nb = num_blocks(n)

    csum = checksum(data) if use_checksum else 0

    if n > 0:
        counts = histogram(data) if hist is None else np.asarray(hist, U32)
        pdf, cdf, magic, shift = normalize_probs(counts, n, prob_bits)
        states, streams, nwords = _encode_blocks(
            data, pdf, cdf, magic, shift, prob_bits
        )
    else:
        pdf = np.zeros(NUM_SYMBOLS, dtype=U32)
        states = np.zeros((0, WARP_SIZE), dtype=U32)
        streams = np.zeros((0, 1), dtype=np.uint16)
        nwords = np.zeros(0, dtype=np.int64)

    # Aligned exclusive prefix sum of per-block word counts
    # (Align<ANSEncodedT, 16>: round word counts to multiples of 8 —
    # GpuANSEncode.cuh:497-509, 792-819).
    aligned = ((nwords + 7) // 8) * 8
    prefix = np.zeros(nb, dtype=np.int64)
    if nb > 0:
        prefix[1:] = np.cumsum(aligned)[:-1]
        total_words = int(prefix[-1] + aligned[-1])
    else:
        total_words = 0

    header = ANSHeader(
        num_blocks=nb,
        total_uncompressed_words=n,
        total_compressed_words=total_words,
        prob_bits=prob_bits,
        use_checksum=use_checksum,
        checksum=csum,
    )

    out = np.zeros(header.total_compressed_size(), dtype=np.uint8)
    out[:32] = header.pack().view(np.uint8)
    out[32 : 32 + 512] = pdf.astype(np.uint16).view(np.uint8)
    if nb > 0:
        so = ANSHeader.states_offset()
        out[so : so + 4 * 32 * nb] = states.astype(U32).view(np.uint8).ravel()
        bo = ANSHeader.block_words_offset(nb)
        last_words = n - (nb - 1) * BLOCK_SIZE
        uncomp_words = np.full(nb, BLOCK_SIZE, dtype=U32)
        uncomp_words[-1] = last_words
        bw = pack_block_words(uncomp_words, nwords.astype(U32), prefix.astype(U32))
        out[bo : bo + 8 * nb] = bw.astype(U32).view(np.uint8).ravel()
        do = ANSHeader.data_offset(nb)
        for b in range(nb):
            w = int(nwords[b])
            s = do + 2 * int(prefix[b])
            out[s : s + 2 * w] = streams[b, :w].view(np.uint8)
    return out


# ---------------------------------------------------------------------------
# ANS decode (reference: GpuANSDecode.cuh)
# ---------------------------------------------------------------------------


def ans_decode(
    archive: np.ndarray, expected_prob_bits: Optional[int] = None
) -> Tuple[np.ndarray, ANSHeader]:
    """Decode a coalesced ANS archive; returns (bytes, header). Archives
    are self-describing: the native row-stream layout (magic 0xDB0D)
    dispatches to ans_decode_native."""
    buf = np.ascontiguousarray(archive, dtype=np.uint8).ravel()
    header = ANSHeader.unpack(buf[:32].view(U32))
    if header.native:
        return ans_decode_native(archive, expected_prob_bits)
    if expected_prob_bits is not None and header.prob_bits != expected_prob_bits:
        raise ValueError(
            f"prob_bits mismatch: archive {header.prob_bits}, "
            f"expected {expected_prob_bits}"
        )
    prob_bits = header.prob_bits
    n = header.total_uncompressed_words
    nb = header.num_blocks
    out = np.zeros(max(n, 1), dtype=np.uint8)
    if n == 0:
        return out[:0], header

    pdf = buf[32 : 32 + 512].view(np.uint16).astype(U32)
    lut = build_decode_table(pdf, prob_bits)
    lut_sym = (lut & U32(0xFF)).astype(np.uint8)
    lut_pdf = (lut >> U32(8)) & U32(0xFFF)
    lut_s_minus_cdf = lut >> U32(20)

    so = ANSHeader.states_offset()
    states = (
        buf[so : so + 4 * 32 * nb].view(U32).reshape(nb, WARP_SIZE).astype(U32)
    )
    bo = ANSHeader.block_words_offset(nb)
    bw = buf[bo : bo + 8 * nb].view(U32).reshape(nb, 2)
    uncomp_words, comp_words, starts = unpack_block_words(bw)
    do = ANSHeader.data_offset(nb)
    data_u16 = buf[do:].view(np.uint16)

    # Per-block stream matrices (gathered into a padded rectangle).
    maxw = int(comp_words.max()) if nb > 0 else 0
    streams = np.zeros((nb, max(maxw, 1)), dtype=np.uint16)
    for b in range(nb):
        w = int(comp_words[b])
        streams[b, :w] = data_u16[int(starts[b]) : int(starts[b]) + w]

    # Uniform reverse schedule (see module docstring of the JAX decoder):
    # iteration k=0 processes the tail partial group (r' = ((U-1)%32)+1 lanes),
    # then full 32-lane groups walking toward position 0
    # (reference: ansDecodeWarpBlock, GpuANSDecode.cuh:161-217).
    u = uncomp_words.astype(np.int64)
    r = ((u - 1) % WARP_SIZE) + 1
    nsteps = (u + WARP_SIZE - 1) // WARP_SIZE
    max_steps = int(nsteps.max())
    ptr = comp_words.astype(np.int64)  # one past last unread word
    lanes = np.arange(WARP_SIZE)

    state_mask = U32((1 << prob_bits) - 1)
    states = states.copy()
    out_padded = np.zeros(nb * BLOCK_SIZE, dtype=np.uint8)
    block_base = np.arange(nb) * BLOCK_SIZE

    for k in range(max_steps):
        active = k < nsteps
        base = u - r - WARP_SIZE * k  # position base for this iteration
        lane_valid = active[:, None] & (
            (k > 0) | (lanes[None, :] < r[:, None])
        )

        s_bar = (states & state_mask).astype(np.int64)
        sym = lut_sym[s_bar]
        pdfv = lut_pdf[s_bar]
        smc = lut_s_minus_cdf[s_bar]

        new_state = pdfv * (states >> U32(prob_bits)) + smc
        states = np.where(lane_valid, new_state, states)

        # write decoded symbols
        pos = block_base[:, None] + base[:, None] + lanes[None, :]
        out_padded[pos[lane_valid]] = sym[lane_valid]

        # renorm reads, highest lane reads closest to the end
        # (GpuANSDecode.cuh:89-104)
        read = lane_valid & (states < U32(ANS_MIN_STATE))
        # prefix = count of reading lanes with index >= l (inclusive)
        suffix = np.cumsum(read[:, ::-1], axis=1)[:, ::-1]
        rd_idx = ptr[:, None] - suffix
        rd_idx_safe = np.clip(rd_idx, 0, streams.shape[1] - 1)
        vals = np.take_along_axis(streams, rd_idx_safe, axis=1).astype(U32)
        states = np.where(read, (states << U32(16)) + vals, states)
        ptr = ptr - read.sum(axis=1)

    out = out_padded[:n].copy()
    return out, header


# ---------------------------------------------------------------------------
# ROW-STREAM layout (magic constants.ANS_MAGIC_NATIVE)
#
# Identical header/probs/states/blockWords sections, but the compressed
# streams of each ROW of 4 consecutive blocks are interleaved per STEP into
# one shared segment (step ascending; within a step, blocks then lanes
# ascending — i.e. the row's 128 encode lanes in order), tightly packed
# with 16-byte alignment per ROW instead of per block. blockWords.y holds
# the ROW segment start, duplicated across the row's blocks. 4x fewer
# stream segments = 4x fewer staging/coalesce pieces, and the
# decoder's reverse reads use ONE cursor per row. Same compression ratio
# (slightly less alignment waste). Versioned via the header's
# magic+version word exactly as the reference's mechanism allows
# (GpuANSUtils.cuh:52-55). This oracle is the executable spec; the JAX
# codec writes it with native=True.
# ---------------------------------------------------------------------------


def ans_encode_native(
    data: np.ndarray,
    prob_bits: int = 10,
    use_checksum: bool = False,
    hist: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Compress a byte array to a ROW-STREAM native archive."""
    data = np.ascontiguousarray(data, dtype=np.uint8).ravel()
    n = data.size
    nb = num_blocks(n)
    nrows = div_up(nb, 4)

    csum = checksum(data) if use_checksum else 0

    if n > 0:
        counts = histogram(data) if hist is None else np.asarray(hist, U32)
        pdf, cdf, magic, shift = normalize_probs(counts, n, prob_bits)
        states, words, mask = _encode_walk(
            data, pdf, cdf, magic, shift, prob_bits
        )
        # per-block word counts (blockWords.x, same as classic)
        nwords = mask.sum(axis=(0, 2)).astype(np.int64)
        # row streams: (step, block-in-row, lane) emission order
        nb4 = nrows * 4
        S = STEPS_PER_BLOCK
        wp = np.zeros((S, nb4, WARP_SIZE), dtype=np.uint16)
        mp = np.zeros((S, nb4, WARP_SIZE), dtype=bool)
        wp[:, :nb] = words
        mp[:, :nb] = mask
        w4 = wp.reshape(S, nrows, 4 * WARP_SIZE).transpose(1, 0, 2)
        m4 = mp.reshape(S, nrows, 4 * WARP_SIZE).transpose(1, 0, 2)
        row_streams = [
            w4[r].reshape(-1)[m4[r].reshape(-1)] for r in range(nrows)
        ]
        row_words = np.array([s.size for s in row_streams], dtype=np.int64)
    else:
        pdf = np.zeros(NUM_SYMBOLS, dtype=U32)
        states = np.zeros((0, WARP_SIZE), dtype=U32)
        nwords = np.zeros(0, dtype=np.int64)
        row_streams = []
        row_words = np.zeros(0, dtype=np.int64)

    # 16B-aligned exclusive prefix per ROW
    aligned = ((row_words + 7) // 8) * 8
    row_prefix = np.zeros(nrows, dtype=np.int64)
    if nrows > 0:
        row_prefix[1:] = np.cumsum(aligned)[:-1]
        total_words = int(row_prefix[-1] + aligned[-1])
    else:
        total_words = 0

    header = ANSHeader(
        num_blocks=nb,
        total_uncompressed_words=n,
        total_compressed_words=total_words,
        prob_bits=prob_bits,
        use_checksum=use_checksum,
        checksum=csum,
        native=True,
    )

    out = np.zeros(header.total_compressed_size(), dtype=np.uint8)
    out[:32] = header.pack().view(np.uint8)
    out[32 : 32 + 512] = pdf.astype(np.uint16).view(np.uint8)
    if nb > 0:
        so = ANSHeader.states_offset()
        out[so : so + 4 * 32 * nb] = states.astype(U32).view(np.uint8).ravel()
        bo = ANSHeader.block_words_offset(nb)
        last_words = n - (nb - 1) * BLOCK_SIZE
        uncomp_words = np.full(nb, BLOCK_SIZE, dtype=U32)
        uncomp_words[-1] = last_words
        blk_start = row_prefix[np.arange(nb) // 4].astype(U32)
        bw = pack_block_words(uncomp_words, nwords.astype(U32), blk_start)
        out[bo : bo + 8 * nb] = bw.astype(U32).view(np.uint8).ravel()
        do = ANSHeader.data_offset(nb)
        for r in range(nrows):
            w = int(row_words[r])
            s = do + 2 * int(row_prefix[r])
            out[s : s + 2 * w] = row_streams[r].view(np.uint8)
    return out


def ans_decode_native(
    archive: np.ndarray, expected_prob_bits: Optional[int] = None
) -> Tuple[np.ndarray, ANSHeader]:
    """Decode a ROW-STREAM native archive; returns (bytes, header)."""
    buf = np.ascontiguousarray(archive, dtype=np.uint8).ravel()
    header = ANSHeader.unpack(buf[:32].view(U32))
    if not header.native:
        raise ValueError("not a native-layout archive")
    if expected_prob_bits is not None and header.prob_bits != expected_prob_bits:
        raise ValueError(
            f"prob_bits mismatch: archive {header.prob_bits}, "
            f"expected {expected_prob_bits}"
        )
    prob_bits = header.prob_bits
    n = header.total_uncompressed_words
    nb = header.num_blocks
    if n == 0:
        return np.zeros(0, dtype=np.uint8), header
    nrows = div_up(nb, 4)
    nb4 = nrows * 4

    pdf = buf[32 : 32 + 512].view(np.uint16).astype(U32)
    lut = build_decode_table(pdf, prob_bits)
    lut_sym = (lut & U32(0xFF)).astype(np.uint8)
    lut_pdf = (lut >> U32(8)) & U32(0xFFF)
    lut_s_minus_cdf = lut >> U32(20)

    so = ANSHeader.states_offset()
    states = (
        buf[so : so + 4 * 32 * nb].view(U32).reshape(nb, WARP_SIZE).astype(U32)
    )
    bo = ANSHeader.block_words_offset(nb)
    bw = buf[bo : bo + 8 * nb].view(U32).reshape(nb, 2)
    uncomp_words, comp_words, blk_start = unpack_block_words(bw)
    do = ANSHeader.data_offset(nb)
    data_u16 = buf[do:].view(np.uint16)

    # per-row streams (start duplicated per block; length = row word sum)
    bs4 = np.zeros(nb4, dtype=np.int64)
    bs4[:nb] = blk_start.astype(np.int64)
    row_start = bs4.reshape(nrows, 4)[:, 0]
    cw4 = np.zeros(nb4, dtype=np.int64)
    cw4[:nb] = comp_words
    row_words = cw4.reshape(nrows, 4).sum(axis=1)
    maxw = int(row_words.max()) if nrows > 0 else 0
    streams = np.zeros((nrows, max(maxw, 1)), dtype=np.uint16)
    for r in range(nrows):
        w = int(row_words[r])
        streams[r, :w] = data_u16[int(row_start[r]) : int(row_start[r]) + w]

    # row-major decode walk: 128 lanes per row = 4 blocks x 32 states,
    # ONE reverse cursor per row; within an iteration, higher (block,lane)
    # positions read closer to the stream end (the reverse of the per-step
    # blocks-then-lanes emission order).
    u4 = np.zeros(nb4, dtype=np.int64)
    u4[:nb] = uncomp_words.astype(np.int64)
    u4r = u4.reshape(nrows, 4)
    r_ = ((u4r - 1) % WARP_SIZE) + 1
    nsteps = (u4r + WARP_SIZE - 1) // WARP_SIZE  # (nrows, 4)
    max_steps = int(nsteps.max())
    ptr = row_words.copy()  # one past last unread u16 of the row
    lanes = np.arange(WARP_SIZE)

    st4 = np.full((nb4, WARP_SIZE), ANS_START_STATE, dtype=U32)
    st4[:nb] = states
    st = st4.reshape(nrows, 4 * WARP_SIZE).copy()

    state_mask = U32((1 << prob_bits) - 1)
    out_padded = np.zeros(nb4 * BLOCK_SIZE, dtype=np.uint8)
    block_base = (np.arange(nb4) * BLOCK_SIZE).reshape(nrows, 4)

    for k in range(max_steps):
        kk = k - (max_steps - nsteps)  # (nrows, 4) per-block iteration
        active = kk >= 0
        base = u4r - r_ - WARP_SIZE * kk
        lane_valid = (
            active[:, :, None]
            & ((kk[:, :, None] > 0) | (lanes[None, None, :] < r_[:, :, None]))
        ).reshape(nrows, 4 * WARP_SIZE)

        s_bar = (st & state_mask).astype(np.int64)
        sym = lut_sym[s_bar]
        pdfv = lut_pdf[s_bar]
        smc = lut_s_minus_cdf[s_bar]
        st = np.where(lane_valid, pdfv * (st >> U32(prob_bits)) + smc, st)

        pos = (block_base[:, :, None] + base[:, :, None] + lanes[None, None, :]
               ).reshape(nrows, 4 * WARP_SIZE)
        out_padded[pos[lane_valid]] = sym[lane_valid]

        read = lane_valid & (st < U32(ANS_MIN_STATE))
        suffix = np.cumsum(read[:, ::-1], axis=1)[:, ::-1]
        rd_idx = ptr[:, None] - suffix
        rd_idx_safe = np.clip(rd_idx, 0, streams.shape[1] - 1)
        vals = np.take_along_axis(streams, rd_idx_safe, axis=1).astype(U32)
        st = np.where(read, (st << U32(16)) + vals, st)
        ptr = ptr - read.sum(axis=1)

    return out_padded[:n].copy(), header


# ---------------------------------------------------------------------------
# Float codec (reference: GpuFloatCompress.cuh / GpuFloatDecompress.cuh)
# ---------------------------------------------------------------------------


def _rotl(x: np.ndarray, k: int, bits: int) -> np.ndarray:
    dt = x.dtype.type
    return (x << dt(k)) | (x >> dt(bits - k))


def _rotr(x: np.ndarray, k: int, bits: int) -> np.ndarray:
    dt = x.dtype.type
    return (x >> dt(k)) | (x << dt(bits - k))


def float_split(words: np.ndarray, float_type: FloatType):
    """Split float words into (comp_planes: list of u8 arrays,
    noncomp_sections: list of arrays). Reference: FloatTypeInfo<FT>::split
    (GpuFloatUtils.cuh:194-382)."""
    ft = FloatType(float_type)
    if ft == FloatType.FLOAT16:
        w = words.astype(np.uint16)
        return [(w >> np.uint16(8)).astype(np.uint8)], [
            (w & np.uint16(0xFF)).astype(np.uint8)
        ]
    if ft == FloatType.BFLOAT16:
        w = _rotl(words.astype(np.uint16), 1, 16)
        return [(w >> np.uint16(8)).astype(np.uint8)], [
            (w & np.uint16(0xFF)).astype(np.uint8)
        ]
    if ft == FloatType.FLOAT32:
        v = _rotl(words.astype(U32), 1, 32)
        comp = (v >> U32(24)).astype(np.uint8)
        nc = v & U32(0xFFFFFF)
        return [comp], [
            (nc & U32(0xFFFF)).astype(np.uint16),
            (nc >> U32(16)).astype(np.uint8),
        ]
    if ft == FloatType.FLOAT64:
        v = _rotl(words.astype(U64), 1, 64)
        comp0 = (v >> U64(56)).astype(np.uint8)
        comp1 = ((v >> U64(48)) & U64(0xFF)).astype(np.uint8)
        nc = v & U64(0xFFFFFFFFFFFF)
        return [comp0, comp1], [
            (nc & U64(0xFFFFFFFF)).astype(U32),
            (nc >> U64(32)).astype(np.uint16),
        ]
    raise ValueError(f"unsupported float type {float_type}")


def float_join(comp_planes, noncomp_sections, float_type: FloatType) -> np.ndarray:
    """Inverse of float_split (reference: FloatTypeInfo<FT>::join)."""
    ft = FloatType(float_type)
    if ft == FloatType.FLOAT16:
        return (
            comp_planes[0].astype(np.uint16) << np.uint16(8)
        ) | noncomp_sections[0].astype(np.uint16)
    if ft == FloatType.BFLOAT16:
        v = (
            comp_planes[0].astype(np.uint16) << np.uint16(8)
        ) | noncomp_sections[0].astype(np.uint16)
        return _rotr(v, 1, 16)
    if ft == FloatType.FLOAT32:
        nc = noncomp_sections[0].astype(U32) | (
            noncomp_sections[1].astype(U32) << U32(16)
        )
        v = (comp_planes[0].astype(U32) << U32(24)) | nc
        return _rotr(v, 1, 32)
    if ft == FloatType.FLOAT64:
        nc = noncomp_sections[0].astype(U64) | (
            noncomp_sections[1].astype(U64) << U64(32)
        )
        v = (
            (comp_planes[0].astype(U64) << U64(56))
            | (comp_planes[1].astype(U64) << U64(48))
            | nc
        )
        return _rotr(v, 1, 64)
    raise ValueError(f"unsupported float type {float_type}")


_FT_DTYPE = {
    FloatType.FLOAT16: np.uint16,
    FloatType.BFLOAT16: np.uint16,
    FloatType.FLOAT32: np.uint32,
    FloatType.FLOAT64: np.uint64,
}


def float_compress(
    words: np.ndarray,
    float_type: FloatType,
    prob_bits: int = 10,
    use_checksum: bool = False,
    native: bool = False,
) -> np.ndarray:
    """Compress an array of float words (as unsigned ints of the right width)
    into a float archive. Returns uint8 bytes of the reported size.

    native=True embeds ROW-STREAM (0xDB0D) ANS segments; the float header
    itself is unchanged and float_decompress auto-dispatches per segment via
    the ANS magic."""
    ft = FloatType(float_type)
    words = np.ascontiguousarray(words).view(_FT_DTYPE[ft]).ravel()
    n = words.size

    csum = checksum(words.view(np.uint8)) if use_checksum else 0
    comp_planes, noncomp = float_split(words, ft)

    # ANS-compress each exponent plane (fp64 has two; each its own archive).
    enc = ans_encode_native if native else ans_encode
    segs = [enc(p, prob_bits=prob_bits, use_checksum=False) for p in comp_planes]

    # native archives with >= FLOAT_ALIGN_MIN floats use the v2 container:
    # raw sections on 512-byte boundaries (constants.FLOAT_VERSION_ALIGNED)
    header = FloatHeader(
        size=n,
        float_type=ft,
        use_checksum=use_checksum,
        checksum=csum,
        first_comp_segment_bytes=(
            round_up(segs[0].size, 16) if len(segs) > 1 else 0
        ),
        aligned=native and n >= FLOAT_ALIGN_MIN,
    )

    off1, off2, offa = header.section_offsets()
    total = offa + sum(
        round_up(s.size, 16) if i + 1 < len(segs) else s.size
        for i, s in enumerate(segs)
    )
    out = np.zeros(total, dtype=np.uint8)
    out[:32] = header.pack().view(np.uint8)

    # Raw (non-compressed) sections, each 16B aligned within the region
    # (GpuFloatUtils.cuh getUncompDataSize; split1 then split2).
    if ft in (FloatType.FLOAT16, FloatType.BFLOAT16):
        out[off1 : off1 + n] = noncomp[0]
    elif ft == FloatType.FLOAT32:
        s1 = noncomp[0].view(np.uint8)
        out[off1 : off1 + 2 * n] = s1
        out[off2 : off2 + n] = noncomp[1]
    else:  # FLOAT64
        s1 = noncomp[0].view(np.uint8)
        out[off1 : off1 + 4 * n] = s1
        out[off2 : off2 + 2 * n] = noncomp[1].view(np.uint8)

    off = offa
    for i, seg in enumerate(segs):
        out[off : off + seg.size] = seg
        off += round_up(seg.size, 16)
    return out


def float_decompress(archive: np.ndarray) -> Tuple[np.ndarray, FloatHeader]:
    """Decompress a float archive; returns (float words, header)."""
    buf = np.ascontiguousarray(archive, dtype=np.uint8).ravel()
    header = FloatHeader.unpack(buf[:32].view(U32))
    ft = header.float_type
    n = header.size
    nseg = FLOAT_NUM_COMP_SEGMENTS[ft]

    comp_planes = []
    off = header.ans_offset(0)
    for i in range(nseg):
        plane, ans_hdr = ans_decode(buf[off:])
        if ans_hdr.total_uncompressed_words != n:
            raise ValueError(
                "ANS plane size mismatch: "
                f"{ans_hdr.total_uncompressed_words} != {n}"
            )
        comp_planes.append(plane)
        off += round_up(ans_hdr.total_compressed_size(), 16)

    uoff, o2, _ = header.section_offsets()
    if ft in (FloatType.FLOAT16, FloatType.BFLOAT16):
        noncomp = [buf[uoff : uoff + n]]
    elif ft == FloatType.FLOAT32:
        s1 = buf[uoff : uoff + 2 * n].view(np.uint16)
        s2 = buf[o2 : o2 + n]
        noncomp = [s1, s2]
    else:
        s1 = buf[uoff : uoff + 4 * n].view(U32)
        s2 = buf[o2 : o2 + 2 * n].view(np.uint16)
        noncomp = [s1, s2]

    words = float_join(comp_planes, noncomp, ft)
    if header.use_checksum:
        got = checksum(words.view(np.uint8))
        if got != header.checksum:
            raise ValueError(
                f"checksum mismatch: expected {header.checksum:#x} got {got:#x}"
            )
    return words, header


# ---------------------------------------------------------------------------
# Sparse float codec (fork addition; reference: GpuSparseFloat*.cuh)
# ---------------------------------------------------------------------------
# NOTE: the reference miscounts nonzeros when the second-to-last element is
# zero (GpuSparseFloatCompress.cuh:170-184 assumes bitmap[size-2] == 1). We
# implement the corrected semantics: the dense sub-archive holds exactly the
# nonzero words in order. Round-trips within this framework are exact; the
# reference's own decompressor mirrors its encoder bug so the two disagree
# only on degenerate inputs (and on the garbage word the reference encodes).


def pack_bitmap(nonzero: np.ndarray) -> np.ndarray:
    """Pack a boolean array into MSB-first bytes
    (reference: GpuSparseFloatCompress.cuh:64-113)."""
    n = nonzero.size
    padded = np.zeros(round_up(max(n, 1), 8), dtype=np.uint8)
    padded[:n] = nonzero.astype(np.uint8)
    groups = padded.reshape(-1, 8)
    weights = (1 << np.arange(7, -1, -1)).astype(np.uint8)
    return (groups * weights[None, :]).sum(axis=1).astype(np.uint8)


def unpack_bitmap(packed: np.ndarray, n: int) -> np.ndarray:
    bits = np.unpackbits(np.asarray(packed, np.uint8))
    return bits[:n].astype(bool)


def sparse_float_compress(
    words: np.ndarray,
    float_type: FloatType,
    prob_bits: int = 10,
    use_checksum: bool = False,
    native: bool = False,
) -> np.ndarray:
    ft = FloatType(float_type)
    words = np.ascontiguousarray(words).view(_FT_DTYPE[ft]).ravel()
    n = words.size
    nonzero = words != 0
    nz_words = words[nonzero]

    dense = float_compress(nz_words, ft, prob_bits, use_checksum, native)

    bitmap_sz = sparse_bitmap_bytes(n)
    out = np.zeros(SPARSE_HEADER_BYTES + bitmap_sz + dense.size, dtype=np.uint8)
    out[:16] = SparseFloatHeader(size=n).pack().view(np.uint8)
    bm = pack_bitmap(nonzero)
    out[16 : 16 + bm.size] = bm
    out[16 + bitmap_sz :] = dense
    return out


def sparse_float_decompress(archive: np.ndarray) -> Tuple[np.ndarray, FloatHeader]:
    buf = np.ascontiguousarray(archive, dtype=np.uint8).ravel()
    sheader = SparseFloatHeader.unpack(buf[:16].view(U32))
    n = sheader.size
    bitmap_sz = sparse_bitmap_bytes(n)
    nonzero = unpack_bitmap(buf[16 : 16 + bitmap_sz], n)
    nz_words, fheader = float_decompress(buf[16 + bitmap_sz :])
    out = np.zeros(n, dtype=_FT_DTYPE[fheader.float_type])
    out[nonzero] = nz_words[: int(nonzero.sum())]
    return out, fheader
