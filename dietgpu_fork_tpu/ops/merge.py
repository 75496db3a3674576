"""Ragged runs-merge: the data-movement primitive of archive assembly.

The codec's layouts (ANS coalescing GpuANSEncode.cuh:511-624, float archive
GpuFloatCompress.cuh:506-551, sparse framing, and the decode-side inverse
staging) all reduce to ONE primitive:

    out[dst[r] + i] = src_flat[src[r] + i]   for i < len[r], r = 0..R-1
    out[j] = 0 elsewhere

with destination intervals sorted and non-overlapping (source offsets are
arbitrary). It is expressed as a gather: each output word finds its run by
binary search over the sorted run starts.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

I32 = jnp.int32
U32 = jnp.uint32

# Multi-source offsets carry their source index in the bits above _RSH;
# each source is limited to 2^28 words (1 GiB), which covers the reference
# benchmark maximum (100M fp64 floats -> ~0.9 GiB archive,
# FloatBenchmark.cu:402-428), and a call to 7 sources (offsets stay
# positive int32).
_RSH = 28


@functools.partial(jax.jit, static_argnames=("out_len", "rsh"))
def _runs_merge_ref(srcs, dst_off, src_off, lens, *, out_len: int,
                    rsh: int = _RSH):
    """Gather formulation: for each output word, locate its run by binary
    search on the sorted dst intervals. Multi-source offsets are resolved
    by flattening the sources end to end."""
    bases = []
    acc = 0
    flats = []
    for s in srcs:
        bases.append(acc)
        flats.append(s.reshape(-1))
        acc += flats[-1].shape[0]
    src_flat = flats[0] if len(flats) == 1 else jnp.concatenate(flats)
    bases_d = jnp.asarray(bases, I32)

    dst_off = dst_off.astype(I32)
    src_off = src_off.astype(I32)
    rid = jnp.clip(
        jax.lax.shift_right_logical(src_off, I32(rsh)), 0, len(srcs) - 1
    )
    src_off = (src_off & jnp.int32((1 << rsh) - 1)) + bases_d[rid]
    lens = lens.astype(I32)
    j = jnp.arange(out_len, dtype=I32)
    r = jnp.clip(
        jnp.searchsorted(dst_off, j, side="right").astype(I32) - 1,
        0,
        dst_off.shape[0] - 1,
    )
    inside = (j >= dst_off[r]) & (j < dst_off[r] + lens[r])
    src_idx = jnp.clip(src_off[r] + (j - dst_off[r]), 0, src_flat.shape[0] - 1)
    return jnp.where(inside, src_flat.astype(U32)[src_idx], U32(0))


def runs_merge(
    src_flat: jax.Array,
    dst_off: jax.Array,
    src_off: jax.Array,
    lens: jax.Array,
    out_len: int,
) -> jax.Array:
    """out[dst_off[r]+i] = src_flat[src_off[r]+i] for i < lens[r]; 0 elsewhere.

    Requirements: destination intervals sorted by dst_off and
    non-overlapping; source offsets arbitrary; uint32-word granular.
    Zero-length runs are allowed.
    """
    # single-source calls carry no source index in the offsets, so they
    # get the full 30-bit word range (4 GiB source) instead of _RSH's 1 GiB
    return _runs_merge_ref(
        (src_flat,), dst_off, src_off, lens, out_len=out_len, rsh=30
    )


def runs_merge_multi(
    srcs,
    dst_off: jax.Array,
    src_off: jax.Array,
    lens: jax.Array,
    out_len: int,
) -> jax.Array:
    """Multi-source runs merge: like runs_merge, but over several uint32
    sources; src_off[r] encodes (source_index << _RSH) | word_offset."""
    return _runs_merge_ref(
        tuple(srcs), dst_off, src_off, lens, out_len=out_len
    )
