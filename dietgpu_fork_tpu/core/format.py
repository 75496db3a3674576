"""Archive format as data: header packing/unpacking and section layout.

All multi-byte fields are little-endian, matching the in-memory struct layout
of the CUDA reference (ANSCoalescedHeader: GpuANSUtils.cuh:199-227,
GpuFloatHeader/GpuFloatHeader2/GpuSparseFloatHeader: GpuFloatUtils.cuh:26-128).

This module is pure NumPy and is shared by the NumPy oracle codec and the
host-side (non-jit) API plumbing. The JAX codec re-implements the same layout
with jnp ops on device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .constants import (
    ANS_HEADER_BYTES,
    ANS_MAGIC,
    ANS_MAGIC_NATIVE,
    ANS_VERSION,
    BLOCK_ALIGNMENT,
    FLOAT_HEADER2_BYTES,
    FLOAT_HEADER_BYTES,
    FLOAT_ALIGN_MIN,
    FLOAT_MAGIC,
    FLOAT_SECTION_ALIGN_BYTES,
    FLOAT_VERSION,
    FLOAT_VERSION_ALIGNED,
    NUM_SYMBOLS,
    SPARSE_HEADER_BYTES,
    WARP_SIZE,
    FloatType,
    ans_compressed_overhead,
    float_uncomp_data_size,
    round_up,
    sparse_bitmap_bytes,
)


# ---------------------------------------------------------------------------
# ANS coalesced archive layout
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ANSHeader:
    num_blocks: int
    total_uncompressed_words: int
    total_compressed_words: int
    prob_bits: int
    use_checksum: bool
    checksum: int = 0
    # ROW-STREAM layout (see constants.ANS_MAGIC_NATIVE): same
    # sections, but the 4 blocks of each row share ONE per-step-interleaved
    # stream segment, 16B-aligned per ROW; blockWords.y holds the ROW
    # segment start for each of its blocks.
    native: bool = False

    @property
    def options(self) -> int:
        return (self.prob_bits & 0xF) | (int(self.use_checksum) << 4)

    def pack(self) -> np.ndarray:
        """Pack to 8 little-endian uint32 words (32 bytes)."""
        magic = ANS_MAGIC_NATIVE if self.native else ANS_MAGIC
        return np.array(
            [
                (magic << 16) | ANS_VERSION,
                self.num_blocks,
                self.total_uncompressed_words,
                self.total_compressed_words,
                self.options,
                self.checksum,
                0,
                0,
            ],
            dtype=np.uint32,
        )

    @staticmethod
    def unpack(words: np.ndarray) -> "ANSHeader":
        words = np.asarray(words, dtype=np.uint32)
        magic_version = int(words[0])
        magic = magic_version >> 16
        if magic not in (ANS_MAGIC, ANS_MAGIC_NATIVE):
            raise ValueError(f"bad ANS magic {magic:#x}")
        if magic_version & 0xFFFF != ANS_VERSION:
            raise ValueError(f"bad ANS version {magic_version & 0xFFFF:#x}")
        options = int(words[4])
        return ANSHeader(
            num_blocks=int(words[1]),
            total_uncompressed_words=int(words[2]),
            total_compressed_words=int(words[3]),
            prob_bits=options & 0xF,
            use_checksum=bool(options & 0x10),
            checksum=int(words[5]),
            native=magic == ANS_MAGIC_NATIVE,
        )

    # Section byte offsets within the archive ------------------------------

    @staticmethod
    def probs_offset() -> int:
        return ANS_HEADER_BYTES

    @staticmethod
    def states_offset() -> int:
        return ANS_HEADER_BYTES + 2 * NUM_SYMBOLS

    @staticmethod
    def block_words_offset(num_blocks: int) -> int:
        return ANSHeader.states_offset() + 4 * WARP_SIZE * num_blocks

    @staticmethod
    def data_offset(num_blocks: int) -> int:
        # blockWords is a uint2 array padded to a 16B multiple of entries
        return ANSHeader.block_words_offset(num_blocks) + 8 * round_up(
            num_blocks, 2
        )

    def total_compressed_size(self) -> int:
        return (
            ans_compressed_overhead(self.num_blocks)
            + 2 * self.total_compressed_words
        )


def pack_block_words(
    uncompressed_words: np.ndarray, compressed_words: np.ndarray, starts: np.ndarray
) -> np.ndarray:
    """Per-block uint2 {x: (uncompWords<<16)|compWords, y: wordStart}
    (reference: GpuANSEncode.cuh:594-604)."""
    x = (uncompressed_words.astype(np.uint32) << 16) | compressed_words.astype(
        np.uint32
    )
    y = starts.astype(np.uint32)
    return np.stack([x, y], axis=-1)


def unpack_block_words(pairs: np.ndarray):
    x = pairs[..., 0]
    y = pairs[..., 1]
    return (x >> 16).astype(np.uint32), (x & 0xFFFF).astype(np.uint32), y


# ---------------------------------------------------------------------------
# Float archive layout
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FloatHeader:
    size: int  # number of float words
    float_type: FloatType
    use_checksum: bool
    checksum: int = 0
    first_comp_segment_bytes: int = 0  # GpuFloatHeader2 field (fp64 only)
    # Version-2 container (FLOAT_VERSION_ALIGNED): raw sections start on
    # FLOAT_SECTION_ALIGN_BYTES boundaries (native archives with
    # size >= FLOAT_ALIGN_MIN)
    aligned: bool = False

    @property
    def options(self) -> int:
        return (int(self.float_type) & 0xF) | (int(self.use_checksum) << 4)

    def pack(self) -> np.ndarray:
        """Pack GpuFloatHeader + GpuFloatHeader2 to 8 uint32 words."""
        version = FLOAT_VERSION_ALIGNED if self.aligned else FLOAT_VERSION
        return np.array(
            [
                (FLOAT_MAGIC << 16) | version,
                self.size,
                self.options,
                self.checksum,
                self.first_comp_segment_bytes,
                0,
                0,
                0,
            ],
            dtype=np.uint32,
        )

    @staticmethod
    def unpack(words: np.ndarray) -> "FloatHeader":
        words = np.asarray(words, dtype=np.uint32)
        magic_version = int(words[0])
        if magic_version >> 16 != FLOAT_MAGIC:
            raise ValueError(f"bad float magic {magic_version >> 16:#x}")
        version = magic_version & 0xFFFF
        if version not in (FLOAT_VERSION, FLOAT_VERSION_ALIGNED):
            raise ValueError(f"bad float version {version:#x}")
        options = int(words[2])
        return FloatHeader(
            size=int(words[1]),
            float_type=FloatType(options & 0xF),
            use_checksum=bool(options & 0x10),
            checksum=int(words[3]),
            first_comp_segment_bytes=int(words[4]),
            aligned=version == FLOAT_VERSION_ALIGNED,
        )

    @staticmethod
    def uncomp_offset() -> int:
        return FLOAT_HEADER_BYTES + FLOAT_HEADER2_BYTES

    def section_offsets(self):
        """Byte offsets (sec1, sec2, ans_segment0) of the payload regions.
        v1: sections packed back to back after the 32-byte headers; v2:
        each region start rounded up to FLOAT_SECTION_ALIGN_BYTES."""
        ft = self.float_type
        n = self.size
        if ft in (FloatType.FLOAT16, FloatType.BFLOAT16):
            s1b, s2b = round_up(n, 16), 0
        elif ft == FloatType.FLOAT32:
            s1b, s2b = 2 * round_up(n, 8), round_up(n, 16)
        else:
            s1b, s2b = 4 * round_up(n, 4), 2 * round_up(n, 8)
        if self.aligned:
            a = FLOAT_SECTION_ALIGN_BYTES
            o1 = a
            o2 = o1 + round_up(s1b, a)
            oa = o2 + round_up(s2b, a)
        else:
            o1 = FloatHeader.uncomp_offset()
            o2 = o1 + s1b
            oa = o2 + s2b
        return o1, o2, oa

    def ans_offset(self, segment: int = 0) -> int:
        """Byte offset of the ANS archive for the given segment."""
        off = self.section_offsets()[2]
        if segment == 1:
            off += self.first_comp_segment_bytes
        return off


@dataclasses.dataclass
class SparseFloatHeader:
    size: int  # total float count, zeros included

    def pack(self) -> np.ndarray:
        return np.array([self.size, 0, 0, 0], dtype=np.uint32)

    @staticmethod
    def unpack(words: np.ndarray) -> "SparseFloatHeader":
        return SparseFloatHeader(size=int(np.asarray(words, np.uint32)[0]))

    @staticmethod
    def dense_offset(size: int) -> int:
        """Offset of the inner dense float archive (past header + bitmap)."""
        return SPARSE_HEADER_BYTES + sparse_bitmap_bytes(size)
