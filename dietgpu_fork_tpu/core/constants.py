"""Core constants of the dietgpu archive format.

These mirror the reference constants bit-for-bit so that archives produced by
this framework are interchangeable with the CUDA reference implementation
(reference: dietgpu/ans/GpuANSUtils.cuh:17-60, dietgpu/ans/GpuANSCodec.h:16-20,
dietgpu/float/GpuFloatUtils.cuh:19-23).
"""

from __future__ import annotations

import enum

# rANS symbol domain: byte-wise coder (ANSDecodedT = uint8).
NUM_SYMBOLS = 256

# Uncompressed bytes handled per independent coding block
# (reference: GpuANSUtils.cuh:37).
BLOCK_SIZE = 4096

# Number of interleaved rANS states per block. The reference uses one CUDA
# warp (32 lanes); the archive format hard-codes 32 states per block so we
# keep the same interleave width (reference: DeviceDefs.cuh:14).
WARP_SIZE = 32

# Symbol positions handled per state per full block.
STEPS_PER_BLOCK = BLOCK_SIZE // WARP_SIZE  # 128

# States are limited to [2^15, 2^31) so the magic-multiply division cannot
# overflow (reference: GpuANSUtils.cuh:39-49).
ANS_STATE_BITS = 31
ANS_ENCODED_BITS = 16  # renormalization emits uint16 words
ANS_ENCODED_MASK = (1 << ANS_ENCODED_BITS) - 1
ANS_START_STATE = 1 << (ANS_STATE_BITS - ANS_ENCODED_BITS)  # 2^15
ANS_MIN_STATE = ANS_START_STATE

# Archive integrity magic / version words.
ANS_MAGIC = 0xD00D
ANS_VERSION = 0x0001
# ROW-STREAM layout (opt-in): identical header/probs/states/
# blockWords sections, but the compressed streams of each row of 4
# consecutive blocks are interleaved per STEP into one shared stream
# (step ascending; within a step, blocks then lanes ascending), tightly
# packed with 16-byte alignment per ROW instead of per block. Versioned
# through the header's magic+version word exactly as the reference's
# mechanism allows (GpuANSUtils.cuh:52-55). 4x fewer stream segments =
# 4x fewer staging/coalesce pieces; same compression ratio.
ANS_MAGIC_NATIVE = 0xDB0D
FLOAT_MAGIC = 0xF00F
FLOAT_VERSION = 0x0001
# Float container version 2 (native archives only, members with
# >= FLOAT_ALIGN_MIN floats): raw sections start on 512-byte boundaries
# (aligned bulk copies in archive assembly and decode staging). Costs at most
# 3*512 B of zero padding per member; self-describing per member through
# the float magic+version word.
FLOAT_VERSION_ALIGNED = 0x0002
FLOAT_ALIGN_MIN = 1 << 20
FLOAT_SECTION_ALIGN_BYTES = 512

# Every compressed block segment is aligned/padded to this many bytes
# (reference: GpuANSUtils.cuh:60).
BLOCK_ALIGNMENT = 16

# Allowed probability resolutions (reference: GpuANSCodec.h:32-34).
VALID_PROB_BITS = (9, 10, 11)
DEFAULT_PROB_BITS = 10

# Minimum alignment (bytes) of raw-ANS input split boundaries
# (reference: GpuANSCodec.h:16).
ANS_REQUIRED_ALIGNMENT = 4

# Struct sizes (bytes).
ANS_HEADER_BYTES = 32       # ANSCoalescedHeader (GpuANSUtils.cuh:229)
FLOAT_HEADER_BYTES = 16     # GpuFloatHeader (GpuFloatUtils.cuh:126)
FLOAT_HEADER2_BYTES = 16    # GpuFloatHeader2 (GpuFloatUtils.cuh:127)
SPARSE_HEADER_BYTES = 16    # GpuSparseFloatHeader (GpuFloatUtils.cuh:128)


class FloatType(enum.IntEnum):
    """Float formats supported by the float split codec
    (reference: GpuFloatCodec.h:18-24)."""

    UNDEFINED = 0
    FLOAT16 = 1
    BFLOAT16 = 2
    FLOAT32 = 3
    FLOAT64 = 4


FLOAT_WORD_SIZE = {
    FloatType.FLOAT16: 2,
    FloatType.BFLOAT16: 2,
    FloatType.FLOAT32: 4,
    FloatType.FLOAT64: 8,
}

# Number of independent ANS datasets (exponent byte planes) per float type
# (reference: GpuFloatUtils.cuh getNumCompSegments).
FLOAT_NUM_COMP_SEGMENTS = {
    FloatType.FLOAT16: 1,
    FloatType.BFLOAT16: 1,
    FloatType.FLOAT32: 1,
    FloatType.FLOAT64: 2,
}


def div_up(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return div_up(a, b) * b


def round_down(a: int, b: int) -> int:
    return (a // b) * b


def num_blocks(uncompressed_bytes: int) -> int:
    return div_up(uncompressed_bytes, BLOCK_SIZE)


def raw_comp_block_max_size(uncompressed_block_bytes: int = BLOCK_SIZE) -> int:
    """Worst-case compressed bytes for one block (zstd-style estimate)
    (reference: GpuANSEncode.cuh:31-36)."""
    return round_up(
        uncompressed_block_bytes + uncompressed_block_bytes // 4, BLOCK_ALIGNMENT
    )


def ans_compressed_overhead(nblocks: int) -> int:
    """Archive bytes before the compressed word stream
    (reference: GpuANSUtils.cuh:68-81)."""
    return (
        ANS_HEADER_BYTES
        + 2 * NUM_SYMBOLS                 # uint16 probs[256]
        + 4 * WARP_SIZE * nblocks         # ANSWarpState states[numBlocks]
        + 8 * round_up(nblocks, 2)        # uint2 blockWords[roundUp(nb, 2)]
    )


def max_compressed_size(uncompressed_bytes: int) -> int:
    """Worst-case ANS archive size for preallocation.

    NOTE: the reference computes the header overhead for a constant 4096
    blocks regardless of the input size (GpuANSEncode.cu:13-25 passes
    kDefaultBlockSize where a block *count* is expected). We replicate the
    exact formula for sizing parity with the reference API.
    """
    blocks = num_blocks(uncompressed_bytes)
    raw = ans_compressed_overhead(BLOCK_SIZE)  # quirk: 4096 "blocks"
    raw += raw_comp_block_max_size(BLOCK_SIZE) * blocks
    return round_up(raw, 16)


def float_uncomp_data_size(float_type: FloatType, size: int) -> int:
    """Bytes of raw (non-ANS) float payload sections, each 16B aligned
    (reference: GpuFloatUtils.cuh getUncompDataSize per type)."""
    ft = FloatType(float_type)
    if ft in (FloatType.FLOAT16, FloatType.BFLOAT16):
        return round_up(size, 16)
    if ft == FloatType.FLOAT32:
        # low-order 2 bytes (u16 section), then high byte (u8 section)
        return 2 * round_up(size, 8) + round_up(size, 16)
    if ft == FloatType.FLOAT64:
        # low-order 4 bytes (u32 section), then high 2 bytes (u16 section)
        return 4 * round_up(size, 4) + 2 * round_up(size, 8)
    raise ValueError(f"unsupported float type {float_type}")


def max_float_compressed_size(float_type: FloatType, size: int) -> int:
    """Worst-case float archive size (reference: GpuFloatCompress.cu:23-48)."""
    ft = FloatType(float_type)
    base = FLOAT_HEADER_BYTES + FLOAT_HEADER2_BYTES + max_compressed_size(size)
    base += float_uncomp_data_size(ft, size)
    if ft == FloatType.FLOAT64:
        base += max_compressed_size(size)
    return base


def sparse_bitmap_bytes(size: int) -> int:
    """Bit-packed nonzero bitmap section size, 16B aligned
    (reference: GpuSparseFloatCompress.cuh:208-222)."""
    return round_up(div_up(size, 8), 16)


def max_sparse_float_compressed_size(float_type: FloatType, size: int) -> int:
    """Reference: GpuSparseFloatCompress.cu:16-24."""
    return (
        SPARSE_HEADER_BYTES
        + sparse_bitmap_bytes(size)
        + max_float_compressed_size(float_type, size)
    )
