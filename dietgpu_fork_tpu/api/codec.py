"""User-facing batch codec API, mirroring the reference's PyTorch custom ops.

Op-for-op parity with TORCH_LIBRARY(dietgpu) (DietGpu.cpp:921-978):

  max_float_compressed_output_size / max_float_compressed_size
  max_any_compressed_output_size / max_any_compressed_size
  compress_data / compress_data_split_size / compress_data_simple
  decompress_data / decompress_data_split_size / decompress_data_simple

plus the sparse entry points the reference only exposes from C++
(floatCompressSparse / floatDecompressSparse).

Inputs are JAX or NumPy arrays. Lists of unequal-length members are packed
into a padded row matrix (the device codec's native Stride layout); the
split-size variants take one contiguous device array and never leave the
device. Each compress/decompress entry returns the reference's temp-memory
high-water estimate (runtime/stack_memory.py) in place of
StackDeviceMemory::getMaxMemoryUsage.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

import jax
import jax.numpy as jnp
import ml_dtypes

from ..core.constants import (
    DEFAULT_PROB_BITS,
    FLOAT_WORD_SIZE,
    FloatType,
    max_compressed_size,
    max_float_compressed_size,
    max_sparse_float_compressed_size,
)
from ..models.ans import (
    ans_decode_padded,
    ans_encode_padded,
    ans_get_compressed_info,
)
from ..models.float_codec import (
    float_compress_padded,
    float_decompress_core,
    float_get_compressed_info,
)
from ..models.sparse import (
    sparse_float_compress_padded,
    sparse_float_decompress_core,
)
from ..ops.bitops import bitcast_u8_to_u32
from ..runtime import stack_memory as sm

I32 = jnp.int32


_jit_float_compress = jax.jit(
    float_compress_padded,
    static_argnames=(
        "float_type", "prob_bits", "use_checksum", "out_bytes", "native",
    ),
)
_jit_sparse_compress = jax.jit(
    sparse_float_compress_padded,
    static_argnames=(
        "float_type", "prob_bits", "use_checksum", "out_bytes", "native",
    ),
)
_jit_ans_encode = jax.jit(
    ans_encode_padded,
    static_argnames=("prob_bits", "use_checksum", "out_bytes", "native"),
)
_jit_ans_decode = jax.jit(
    ans_decode_padded, static_argnames=("out_capacity", "prob_bits", "native")
)
_jit_float_decompress = jax.jit(
    float_decompress_core,
    static_argnames=(
        "out_floats", "float_type", "prob_bits", "verify_checksum", "native",
    ),
)
_jit_sparse_decompress = jax.jit(
    sparse_float_decompress_core,
    static_argnames=(
        "out_floats", "float_type", "prob_bits", "verify_checksum", "native",
    ),
)

_DTYPE_TO_FT = {
    np.dtype(np.float16): FloatType.FLOAT16,
    np.dtype(ml_dtypes.bfloat16): FloatType.BFLOAT16,
    np.dtype(np.float32): FloatType.FLOAT32,
    np.dtype(np.float64): FloatType.FLOAT64,
}
_FT_TO_DTYPE = {v: k for k, v in _DTYPE_TO_FT.items()}
_FT_TO_UINT = {
    FloatType.FLOAT16: np.uint16,
    FloatType.BFLOAT16: np.uint16,
    FloatType.FLOAT32: np.uint32,
    FloatType.FLOAT64: np.uint64,
}


def _default_native() -> bool:
    """Compression default for the archive layout: the reference's classic
    layout (0xD00D), bit-identical to the CUDA reference's archives, unless
    DIETTPU_NATIVE=1 selects the ROW-STREAM layout (0xDB0D). Override per
    call with ``native=``."""
    import os

    return os.environ.get("DIETTPU_NATIVE") == "1"


import functools as _functools


@_functools.lru_cache(maxsize=None)
def _magic_gather_fn(compress_as_float: bool, sparse: bool, float_type):
    @jax.jit
    def gather_magic(m32):
        B, CW = m32.shape
        if not compress_as_float:
            return m32[:, 0]
        from ..models.float_codec import _section_word_counts

        base = jnp.zeros((B,), I32)
        if sparse:
            from ..models.sparse import _bitmap_words

            total = jnp.clip(m32[:, 0].astype(I32), 0, None)
            base = 4 + _bitmap_words(total)
        hdr0 = jnp.take_along_axis(
            m32, jnp.clip(base[:, None], 0, CW - 1), axis=1
        )[:, 0]
        nf = jnp.take_along_axis(
            m32, jnp.clip(base[:, None] + 1, 0, CW - 1), axis=1
        )[:, 0].astype(I32)
        s1w, s2w = _section_word_counts(jnp.clip(nf, 0, None), float_type)
        # v2 (aligned) float containers place sections on 128-word
        # boundaries; v2 implies native streams either way
        from ..models.float_codec import _FLOAT_MAGIC_VERSION2, _r128

        is_al = hdr0 == jnp.uint32(_FLOAT_MAGIC_VERSION2)
        off = base + jnp.where(
            is_al, 128 + _r128(s1w) + _r128(s2w), 8 + s1w + s2w
        )
        return jnp.take_along_axis(
            m32, jnp.clip(off[:, None], 0, CW - 1), axis=1
        )[:, 0]

    return gather_magic


def detect_native_layout(
    compress_as_float: bool,
    m: jax.Array,
    sparse: bool = False,
    float_type: Optional[FloatType] = None,
) -> bool:
    """Read the (embedded) ANS archive magic of each batch member and decide
    the layout: True = ROW-STREAM native (0xDB0D), False = classic (0xD00D).
    Archives are self-describing (magic+version header word), so decompress
    entry points call this when the caller does not pin ``native=``; the
    read is one tiny D2H of B words. Raises on a batch that mixes layouts
    (one staging shape per call). Unrecognized magics (garbage rows) count
    as classic — decode folds them into per-member failure."""
    m32 = bitcast_u8_to_u32(m) if m.dtype == jnp.uint8 else m
    fn = _magic_gather_fn(bool(compress_as_float), bool(sparse), float_type)
    magic = np.asarray(fn(m32)) >> 16
    is_nat = magic == 0xDB0D
    is_cls = magic == 0xD00D
    if is_nat.any() and is_cls.any():
        raise ValueError(
            "batch mixes classic (0xD00D) and native (0xDB0D) ANS layouts; "
            "decompress them in separate calls or pass native= explicitly"
        )
    return bool(is_nat.any())


def float_type_of(x) -> FloatType:
    try:
        dt = np.dtype(x)  # dtype-like: np.float32, "float32", np.dtype(...)
    except TypeError:
        dt = np.dtype(x.dtype)  # array-like
    if dt == np.dtype(jnp.bfloat16):
        return FloatType.BFLOAT16
    if dt not in _DTYPE_TO_FT:
        raise ValueError(f"unsupported float dtype {dt}")
    return _DTYPE_TO_FT[dt]


def dtype_of(ft: FloatType) -> np.dtype:
    return _FT_TO_DTYPE[FloatType(ft)]


@dataclasses.dataclass
class DecompressStatus:
    """Mirrors ANSDecodeStatus / FloatDecompressStatus
    (GpuANSCodec.h:45-59, GpuFloatCodec.h:85-99)."""

    ok: bool = True
    error: str = "none"
    error_info: List[Tuple[int, str]] = dataclasses.field(default_factory=list)


# ---------------------------------------------------------------------------
# Sizing queries (DietGpu.cpp:128-153)
# ---------------------------------------------------------------------------


def max_float_compressed_output_size(ts: Sequence) -> Tuple[int, int]:
    ft = float_type_of(ts[0])
    max_elems = max((int(np.prod(t.shape)) for t in ts), default=0)
    return len(ts), max_float_compressed_size(ft, max_elems)


def max_any_compressed_output_size(ts: Sequence) -> Tuple[int, int]:
    max_bytes = max(
        (int(np.prod(t.shape)) * np.dtype(t.dtype).itemsize for t in ts),
        default=0,
    )
    return len(ts), max_compressed_size(max_bytes)


max_float_compressed_size = max_float_compressed_size  # re-export
max_any_compressed_size = max_compressed_size


# ---------------------------------------------------------------------------
# Packing helpers
# ---------------------------------------------------------------------------


def _as_bytes_np(t) -> np.ndarray:
    a = np.asarray(t)
    return a.reshape(-1).view(np.uint8)


def _pack_byte_rows(ts: Sequence, row_bytes: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pack a list of arrays into a zero-padded uint8 row matrix. Rows are
    padded to a multiple of 4 bytes for uint32 viewing."""
    row_bytes = max(4, -(-row_bytes // 4) * 4)
    buf = np.zeros((len(ts), row_bytes), np.uint8)
    sizes = np.zeros(len(ts), np.int32)
    for i, t in enumerate(ts):
        b = _as_bytes_np(t)
        buf[i, : b.size] = b
        sizes[i] = b.size
    return buf, sizes


def pack_split_rows(x_flat: jax.Array, split_sizes: Sequence[int]):
    """Device-side ragged-to-padded packing for the SplitSize convention:
    one contiguous array -> (B, S) padded rows, no host round trip."""
    split_sizes = np.asarray(split_sizes, np.int64)
    offs = np.concatenate([[0], np.cumsum(split_sizes)[:-1]])
    S = int(split_sizes.max()) if split_sizes.size else 1
    x_flat = x_flat.reshape(-1)
    idx = jnp.asarray(offs, I32)[:, None] + jnp.arange(S, dtype=I32)[None, :]
    idx = jnp.clip(idx, 0, x_flat.shape[0] - 1)
    rows = jnp.take(x_flat, idx)
    mask = jnp.arange(S, dtype=I32)[None, :] < jnp.asarray(split_sizes, I32)[:, None]
    return jnp.where(mask, rows, jnp.zeros((), rows.dtype)), jnp.asarray(
        split_sizes, I32
    )


def _float_rows_to_u32(ts: Sequence, ft: FloatType):
    ws = FLOAT_WORD_SIZE[ft]
    max_elems = max((int(np.prod(t.shape)) for t in ts), default=1)
    max_elems = max(max_elems, 1)
    buf, _ = _pack_byte_rows(ts, max_elems * ws)
    sizes = np.array([int(np.prod(t.shape)) for t in ts], np.int32)
    return jnp.asarray(buf.view(np.uint32)), jnp.asarray(sizes), max_elems


# ---------------------------------------------------------------------------
# Compress (DietGpu.cpp:161-528)
# ---------------------------------------------------------------------------


def compress_data(
    compress_as_float: bool,
    ts: Sequence,
    checksum: bool = False,
    prob_bits: int = DEFAULT_PROB_BITS,
    sparse: bool = False,
    histogram=None,
    native: Optional[bool] = None,
) -> Tuple[jax.Array, jax.Array, int]:
    """Batch compress. Returns (comp uint8[B, maxCompSize], sizes int[B],
    temp_mem_estimate). Output rows are zero-padded past the reported size.

    histogram: optional uint32[B, 256] caller-supplied byte histograms for
    the raw-ANS path — skips the statistics pass (GpuANSCodec.h:82-84).

    native: archive layout — None (default) picks classic unless
    DIETTPU_NATIVE=1 (_default_native); decompress auto-detects."""
    if native is None:
        native = _default_native()
    if not len(ts):
        raise ValueError("empty batch")
    if histogram is not None and compress_as_float:
        raise ValueError(
            "caller-supplied histograms apply to raw ANS only (the float "
            "codec derives per-plane histograms inside its split)"
        )
    if compress_as_float:
        ft = float_type_of(ts[0])
        for t in ts:
            if float_type_of(t) != ft:
                raise ValueError("all batch members must share a dtype")
        data32, sizes, max_elems = _float_rows_to_u32(ts, ft)
        fn = _jit_sparse_compress if sparse else _jit_float_compress
        comp, comp_bytes = fn(
            data32, sizes, float_type=ft, prob_bits=prob_bits,
            use_checksum=checksum, native=native,
        )
        temp = sm.float_compress_temp_size(len(ts), max_elems, ft)
    else:
        max_bytes = max(
            (int(np.prod(t.shape)) * np.dtype(t.dtype).itemsize for t in ts),
            default=1,
        )
        buf, sizes = _pack_byte_rows(ts, max(max_bytes, 1))
        comp, comp_bytes = _jit_ans_encode(
            jnp.asarray(buf), jnp.asarray(sizes), prob_bits=prob_bits,
            use_checksum=checksum,
            hist=None if histogram is None else jnp.asarray(histogram),
            native=native,
        )
        temp = sm.ans_encode_temp_size(len(ts), max(max_bytes, 1))
    return comp, comp_bytes, temp


def compress_data_split_size(
    compress_as_float: bool,
    t: jax.Array,
    split_sizes: Sequence[int],
    checksum: bool = False,
    prob_bits: int = DEFAULT_PROB_BITS,
    native: Optional[bool] = None,
) -> Tuple[jax.Array, jax.Array, int]:
    """One contiguous input + host split sizes (element counts). Stays on
    device. Interior raw-ANS splits must be 4-byte aligned
    (kANSRequiredAlignment, DietGpu.cpp:376-384)."""
    if native is None:
        native = _default_native()
    split_sizes = [int(s) for s in split_sizes]
    if any(s <= 0 for s in split_sizes):
        raise ValueError("split sizes must be positive")
    if compress_as_float:
        ft = float_type_of(t)
        ws = FLOAT_WORD_SIZE[ft]
        if ft == FloatType.FLOAT64:
            # split at uint32-PAIR granularity: each float64 is a
            # little-endian (lo, hi) uint32 pair, which is exactly the
            # codec's packed row layout — and jnp.asarray on a uint64
            # host array would silently truncate under x64-disabled JAX
            v32 = jnp.asarray(
                np.ascontiguousarray(np.asarray(t)).reshape(-1).view(
                    np.uint32
                )
            )
            data32, _ = pack_split_rows(v32, [2 * s for s in split_sizes])
            sizes = jnp.asarray(split_sizes, I32)
        else:
            u = _FT_TO_UINT[ft]
            v = jnp.asarray(np.ascontiguousarray(np.asarray(t)).view(u))
            rows, sizes = pack_split_rows(v.reshape(-1), split_sizes)
            if ws == 2:
                B, S = rows.shape
                pad = (-S) % 2
                if pad:
                    rows = jnp.pad(rows, ((0, 0), (0, pad)))
                r = rows.astype(jnp.uint32).reshape(B, -1, 2)
                data32 = r[..., 0] | (r[..., 1] << jnp.uint32(16))
            else:
                data32 = rows
        comp, comp_bytes = _jit_float_compress(
            data32, sizes, float_type=ft, prob_bits=prob_bits,
            use_checksum=checksum, native=native,
        )
        temp = sm.float_compress_temp_size(len(split_sizes), max(split_sizes), ft)
    else:
        for s in split_sizes[:-1]:
            if s % 4 != 0:
                raise ValueError(
                    "interior raw-ANS splits must be 4-byte aligned"
                )
        flat = jnp.asarray(t).reshape(-1)
        flat_u8 = jax.lax.bitcast_convert_type(flat, jnp.uint8).reshape(-1)
        item = np.dtype(t.dtype).itemsize
        byte_sizes = [s * item for s in split_sizes]
        rows, sizes = pack_split_rows(flat_u8, byte_sizes)
        pad = (-rows.shape[1]) % 4
        if pad:
            rows = jnp.pad(rows, ((0, 0), (0, pad)))
        comp, comp_bytes = _jit_ans_encode(
            rows, sizes, prob_bits=prob_bits, use_checksum=checksum,
            native=native,
        )
        temp = sm.ans_encode_temp_size(len(split_sizes), max(byte_sizes))
    return comp, comp_bytes, temp


def compress_data_simple(
    compress_as_float: bool,
    ts: Sequence,
    checksum: bool = False,
    prob_bits: int = DEFAULT_PROB_BITS,
    sparse: bool = False,
    native: Optional[bool] = None,
) -> List[np.ndarray]:
    """Synchronous convenience: returns exact-size archives
    (DietGpu.cpp:474-528)."""
    comp, comp_bytes, _ = compress_data(
        compress_as_float, ts, checksum, prob_bits, sparse, native=native
    )
    comp = np.asarray(comp)
    comp_bytes = np.asarray(comp_bytes)
    return [comp[i, : int(comp_bytes[i])].copy() for i in range(len(ts))]


# ---------------------------------------------------------------------------
# Decompress (DietGpu.cpp:536-917)
# ---------------------------------------------------------------------------


def _comp_matrix(comps: Union[Sequence, jax.Array]) -> jax.Array:
    if hasattr(comps, "ndim") and comps.ndim == 2:
        m = jnp.asarray(comps)
        pad = (-m.shape[1]) % 4
        return jnp.pad(m, ((0, 0), (0, pad))) if pad else m
    buf, _ = _pack_byte_rows(list(comps), max(c.shape[0] for c in comps))
    return jnp.asarray(buf)


def _checksum_status(ok_arr, arch, got) -> DecompressStatus:
    status = DecompressStatus()
    ok_arr = np.asarray(ok_arr)
    arch = np.asarray(arch)
    got = np.asarray(got)
    for i in range(arch.shape[0]):
        if not ok_arr[i]:
            # decode itself failed; its computed checksum is meaningless
            status.ok = False
            status.error = "decode_failed"
            status.error_info.append((i, "member failed to decompress"))
        elif arch[i] != got[i]:
            status.ok = False
            status.error = "checksum_mismatch"
            status.error_info.append(
                (i, f"expected checksum {int(arch[i]):#x} got {int(got[i]):#x}")
            )
    return status


def decompress_data(
    compress_as_float: bool,
    comps: Union[Sequence, jax.Array],
    out_capacities: Sequence[int],
    dtype=None,
    checksum: bool = False,
    prob_bits: int = DEFAULT_PROB_BITS,
    sparse: bool = False,
    native: Optional[bool] = None,
):
    """Batch decompress into capacity-bounded outputs.

    Returns (list of arrays sliced to the decoded size, sizes int[B],
    success bool[B], status, temp_mem_estimate). Raises on checksum mismatch
    when checksum=True, like the torch binding (DietGpu.cpp:623-626).

    native: archive layout; None (default) auto-detects from the archive's
    self-describing ANS magic (detect_native_layout).
    """
    m = _comp_matrix(comps)
    B = m.shape[0]
    caps = np.asarray(list(out_capacities), np.int32)
    cap = int(caps.max()) if caps.size else 1

    if compress_as_float:
        ft = float_type_of(dtype) if dtype is not None else FloatType(
            int(np.asarray(float_get_compressed_info(m)[1])[0])
        )
        if native is None:
            native = detect_native_layout(True, m, sparse, ft)
        if sparse:
            words32, success, sizes, ca, cg = _jit_sparse_decompress(
                bitcast_u8_to_u32(m), out_floats=max(cap, 1), float_type=ft,
                prob_bits=prob_bits, capacities=jnp.asarray(caps),
                verify_checksum=checksum, native=native)
        else:
            words32, success, sizes, ca, cg = _jit_float_decompress(
                bitcast_u8_to_u32(m), jnp.zeros((B,), I32),
                out_floats=max(cap, 1), float_type=ft, prob_bits=prob_bits,
                capacities=jnp.asarray(caps), verify_checksum=checksum,
                native=native)
        out_np = np.asarray(words32).view(np.uint8)
        sizes_np = np.asarray(sizes)
        dt = dtype_of(ft)
        ws = FLOAT_WORD_SIZE[ft]
        outs = [
            out_np[i, : min(int(sizes_np[i]), caps[i]) * ws].view(dt).copy()
            for i in range(B)
        ]
        status = (
            _checksum_status(success, ca, cg) if checksum else DecompressStatus()
        )
        temp = sm.float_decompress_temp_size(B, cap, ft, prob_bits)
    else:
        if native is None:
            native = detect_native_layout(False, m)
        out, success, sizes, arch_csum = _jit_ans_decode(
            m, out_capacity=max(cap, 1), prob_bits=prob_bits,
            capacities=jnp.asarray(caps), native=native)
        out_np = np.asarray(out)
        sizes_np = np.asarray(sizes)
        outs = [
            out_np[i, : min(int(sizes_np[i]), caps[i])].copy() for i in range(B)
        ]
        if checksum:
            from ..ops.checksum import checksum_batched

            got = checksum_batched(out, sizes.astype(I32))
            status = _checksum_status(success, arch_csum, got)
        else:
            status = DecompressStatus()
        temp = sm.ans_decode_temp_size(B, prob_bits)

    if checksum and not status.ok:
        raise RuntimeError(f"decompression checksum mismatch: {status.error_info}")
    return outs, sizes_np, np.asarray(success), status, temp


def decompress_data_device(
    compress_as_float: bool,
    comps: Union[Sequence, jax.Array],
    out_capacity: int,
    dtype=None,
    prob_bits: int = DEFAULT_PROB_BITS,
    sparse: bool = False,
    native: Optional[bool] = None,
):
    """Fully-on-device decompress: returns padded DEVICE rows + per-member
    sizes with no host round trip, preserving the reference's zero-sync
    contract (README.md:114) for pipeline composition — callers keep the
    result on device (e.g. feed it straight into a training step) and
    consult `sizes`/`success` lazily.

    Returns (words jax.Array[B, W] uint32-packed rows zero-padded past each
    member's decoded bytes, sizes uint32[B] device array, success bool[B]
    device array). ``out_capacity`` is one capacity (elements) for all
    members, as a static padded-row bound.
    """
    m = _comp_matrix(comps)
    B = m.shape[0]
    if compress_as_float:
        ft = float_type_of(dtype) if dtype is not None else FloatType(
            int(np.asarray(float_get_compressed_info(m)[1])[0])
        )
        if native is None:
            native = detect_native_layout(True, m, sparse, ft)
        if sparse:
            words32, success, sizes, _, _ = _jit_sparse_decompress(
                bitcast_u8_to_u32(m), out_floats=max(out_capacity, 1),
                float_type=ft, prob_bits=prob_bits, capacities=None,
                verify_checksum=False, native=native)
        else:
            words32, success, sizes, _, _ = _jit_float_decompress(
                bitcast_u8_to_u32(m), jnp.zeros((B,), I32),
                out_floats=max(out_capacity, 1), float_type=ft,
                prob_bits=prob_bits, capacities=None, verify_checksum=False,
                native=native)
        return words32, sizes, success
    if native is None:
        native = detect_native_layout(False, m)
    out, success, sizes, _ = _jit_ans_decode(
        m, out_capacity=max(out_capacity, 1), prob_bits=prob_bits,
        capacities=None, native=native)
    return out, sizes, success


@_functools.lru_cache(maxsize=256)
def _ragged_concat_fn(byte_lens: tuple, Wcap: int):
    """Device ragged concatenation of per-member byte streams.

    Input: uint32-packed rows (B, Wcap), member i's bytes at the row start,
    zero beyond. Output: one contiguous uint32[ceil(total/4)] device array
    holding the byte concatenation. Byte lengths are host metadata (the
    split-size convention), so the run list is precomputed here and the
    data path is ONE runs_merge — no host round trip, the device analogue
    of DietGpu.cpp:685-825 writing a single device tensor.

    All destination byte offsets are even (float words are >= 2 B; raw-ANS
    interior splits are 4 B aligned), so every word of the output is either
    (a) interior to one member — a word-aligned run from the member's row
    (offset % 4 == 0) or from a 16-bit-shifted copy of it (offset % 4 == 2),
    or (b) a SEAM word straddling two members, assembled as a 1-word run
    from a tiny gathered blob."""
    lens = np.asarray(byte_lens, np.int64)
    B = lens.size
    offs = np.zeros(B + 1, np.int64)
    offs[1:] = np.cumsum(lens)
    total = int(offs[-1])
    OW = max(-(-total // 4), 1)
    a = offs[:-1] % 4  # 0 or 2 by the alignment argument above
    w_start = -(-offs[:-1] // 4)
    w_end = offs[1:] // 4
    w_end[-1] = OW  # the tail partial word reads the row's zero padding
    body_len = np.maximum(w_end - w_start, 0)
    rows_b = np.arange(B, dtype=np.int64) * Wcap
    src_body = np.where(a == 0, rows_b, B * Wcap + rows_b)
    seam_i = np.nonzero(a == 2)[0]  # member starts mid-word (never i = 0)
    seam_dst = offs[seam_i] // 4
    nseam = int(seam_i.size)
    seam_base = 2 * B * Wcap
    dst = np.concatenate([w_start, seam_dst])
    src = np.concatenate([src_body, seam_base + np.arange(nseam)])
    ln = np.concatenate([body_len, np.ones(nseam, np.int64)])
    order = np.argsort(dst, kind="stable")
    dst_d = jnp.asarray(dst[order], I32)
    src_d = jnp.asarray(src[order], I32)
    ln_d = jnp.asarray(ln[order], I32)
    # seam value = last uint16 of member i-1 | first uint16 of member i
    prev_last_u16 = (seam_i - 1) * (2 * Wcap) + (lens[seam_i - 1] // 2 - 1)
    lw_idx = jnp.asarray(prev_last_u16 >> 1, I32)
    lw_half = jnp.asarray(prev_last_u16 & 1, I32)
    fw_idx = jnp.asarray(seam_i * Wcap, I32)

    @jax.jit
    def concat(rows32):
        from ..ops.merge import runs_merge

        flat = rows32.reshape(-1)
        shifted = (rows32 >> jnp.uint32(16)) | (
            jnp.pad(rows32[:, 1:], ((0, 0), (0, 1))) << jnp.uint32(16)
        )
        parts = [flat, shifted.reshape(-1)]
        if nseam:
            lw = jnp.take(flat, lw_idx)
            lo = jnp.where(
                lw_half == 1, lw >> jnp.uint32(16), lw & jnp.uint32(0xFFFF)
            )
            hi = jnp.take(flat, fw_idx) & jnp.uint32(0xFFFF)
            parts.append(lo | (hi << jnp.uint32(16)))
        return runs_merge(
            jnp.concatenate(parts), dst_d, src_d, ln_d, OW
        )

    return concat


def as_float64(out) -> np.ndarray:
    """Host float64 view of an fp64 decompress output.

    fp64-capable entry points that return DEVICE arrays
    (decompress_data_split_size, decompress_data_device) represent each
    float64 as a little-endian (lo, hi) uint32 pair when ``jax_enable_x64``
    is off, because jnp has no float64 dtype in that mode. This helper
    produces np.float64 from either representation (a float64 array passes
    through)."""
    a = np.asarray(out)
    if a.dtype == np.float64:
        return a
    if a.dtype != np.uint32 or a.size % 2:
        raise ValueError(
            f"expected float64 or an even-length uint32 pair array, got "
            f"{a.dtype}[{a.shape}]"
        )
    return np.ascontiguousarray(a).reshape(-1).view(np.float64)


def decompress_data_split_size(
    compress_as_float: bool,
    comps: Union[Sequence, jax.Array],
    out_split_sizes: Sequence[int],
    dtype=None,
    checksum: bool = False,
    prob_bits: int = DEFAULT_PROB_BITS,
    native: Optional[bool] = None,
):
    """Decompress into ONE contiguous DEVICE array with per-member split
    sizes (element counts). Decoded sizes must match exactly; parity with
    DietGpu.cpp:685-825, which writes a single device tensor — the data
    path here is jit decode + one device runs-merge, no host round trip
    (sizes/success/checksums are D2H'd as metadata only).

    float64 archives: with ``jax_enable_x64`` on, the output is a float64
    device array; with it off (JAX's default), the same device bytes are
    returned as a uint32[total, 2] array of little-endian (lo, hi) word
    pairs — pass it to :func:`as_float64` for a host float64 view."""
    m = _comp_matrix(comps)
    B = m.shape[0]
    split = [int(s) for s in out_split_sizes]
    if len(split) != B:
        raise ValueError("split count != batch size")
    if any(s <= 0 for s in split):
        raise ValueError("split sizes must be positive")
    cap = max(split)

    if compress_as_float:
        ft = float_type_of(dtype) if dtype is not None else FloatType(
            int(np.asarray(float_get_compressed_info(m)[1])[0])
        )
        if native is None:
            native = detect_native_layout(True, m, False, ft)
        words32, success, sizes, ca, cg = _jit_float_decompress(
            bitcast_u8_to_u32(m), jnp.zeros((B,), I32),
            out_floats=max(cap, 1), float_type=ft, prob_bits=prob_bits,
            capacities=jnp.asarray(split, I32), verify_checksum=checksum,
            native=native,
        )
        ws = FLOAT_WORD_SIZE[ft]
        byte_lens = tuple(s * ws for s in split)
        flat32 = _ragged_concat_fn(byte_lens, words32.shape[1])(words32)
        n_elems = sum(split)
        if ws == 2:
            out = jax.lax.bitcast_convert_type(flat32, jnp.uint16)
            out = out.reshape(-1)[:n_elems]
            out = jax.lax.bitcast_convert_type(
                out,
                jnp.bfloat16 if ft == FloatType.BFLOAT16 else jnp.float16,
            )
        elif ws == 4:
            out = jax.lax.bitcast_convert_type(flat32, jnp.float32)
        else:
            # float64 exists as a JAX dtype only under x64; otherwise
            # return the raw uint32 (lo, hi) pairs — same device bytes,
            # as_float64() gives the host float64 view
            pairs = flat32.reshape(-1, 2)[:n_elems]
            out = (
                jax.lax.bitcast_convert_type(pairs, jnp.float64)
                if jax.config.jax_enable_x64
                else pairs
            )
        status = (
            _checksum_status(success, ca, cg) if checksum else DecompressStatus()
        )
        temp = sm.float_decompress_temp_size(B, cap, ft, prob_bits)
    else:
        for s in split[:-1]:
            if s % 4 != 0:
                raise ValueError(
                    "interior raw-ANS splits must be 4-byte aligned"
                )
        if native is None:
            native = detect_native_layout(False, m)
        rows, success, sizes, arch_csum = _jit_ans_decode(
            m, out_capacity=max(cap, 1), prob_bits=prob_bits,
            capacities=jnp.asarray(split, I32), native=native,
        )
        byte_lens = tuple(split)
        rows32 = bitcast_u8_to_u32(rows)
        flat32 = _ragged_concat_fn(byte_lens, rows32.shape[1])(rows32)
        total = sum(split)
        out = jax.lax.bitcast_convert_type(flat32, jnp.uint8).reshape(-1)[
            :total
        ]
        if checksum:
            from ..ops.checksum import checksum_batched

            got = checksum_batched(rows, sizes.astype(I32))
            status = _checksum_status(success, arch_csum, got)
        else:
            status = DecompressStatus()
        temp = sm.ans_decode_temp_size(B, prob_bits)

    sizes_np = np.asarray(sizes)
    success_np = np.asarray(success)
    for i, s in enumerate(split):
        if not bool(success_np[i]):
            raise RuntimeError(f"member {i}: decompression failed")
        if int(sizes_np[i]) != s:
            raise RuntimeError(
                f"member {i}: decoded size {int(sizes_np[i])} != expected {s}"
            )
    if checksum and not status.ok:
        raise RuntimeError(
            f"decompression checksum mismatch: {status.error_info}"
        )
    return out, sizes_np, success_np, status, temp


def decompress_data_simple(
    compress_as_float: bool,
    comps: Sequence,
    checksum: bool = False,
    prob_bits: int = DEFAULT_PROB_BITS,
    sparse: bool = False,
):
    """Reads archive headers to learn sizes/dtypes, allocates outputs,
    decompresses (DietGpu.cpp:827-917)."""
    m = _comp_matrix(comps)
    if compress_as_float:
        if sparse:
            m32 = bitcast_u8_to_u32(m)
            total = np.asarray(m32[:, 0])
            # the dense header sits after the sparse header + bitmap, whose
            # size depends on each member's own float count — compute the
            # offset per member (mirrors DietGpu.cpp:827-917 semantics)
            from ..core.constants import sparse_bitmap_bytes

            hdrs = np.stack(
                [
                    m[i, off : off + 16]
                    for i, off in enumerate(
                        16 + sparse_bitmap_bytes(int(t)) for t in total
                    )
                ]
            )
            ftypes = np.asarray(float_get_compressed_info(hdrs)[1])
            sizes = total
        else:
            sizes, ftypes, _ = (
                np.asarray(x) for x in float_get_compressed_info(m)
            )
        ft = FloatType(int(ftypes[0]))
        outs, _, success, status, _ = decompress_data(
            True, m, [int(s) for s in sizes], dtype_of(ft), checksum,
            prob_bits, sparse,
        )
    else:
        sizes, _ = ans_get_compressed_info(m)
        outs, _, success, status, _ = decompress_data(
            False, m, [int(s) for s in np.asarray(sizes)], None, checksum,
            prob_bits,
        )
    if not np.all(success):
        raise RuntimeError("decompression failed")
    return outs
