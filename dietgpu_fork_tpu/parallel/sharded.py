"""Mesh-sharded codec: data-parallel batch compression over device meshes.

The reference is strictly single-GPU (SURVEY.md §2.8); its enabling property
— a batch of independently decodable archives with per-member statistics
(README.md:110) — is exactly what makes the codec embarrassingly SPMD. This
module shards batch members across a `jax.sharding.Mesh` axis with
`shard_map`, so each device runs the full codec on its shard with zero
communication; collectives only appear where semantics require them
(size/offset exchange, compressed collectives in parallel/collectives.py).

Works identically on a real multi-chip mesh and on the CPU-simulated 8-device
mesh used in tests.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from functools import partial as _partial

from jax import shard_map as _shard_map

# codec scans carry constants created inside the mapped function, which the
# varying-manual-axes checker rejects; disable the check (semantics unchanged)
shard_map = _partial(_shard_map, check_vma=False)

from ..core.constants import FloatType
from ..models.ans import ans_decode_padded, ans_encode_padded
from ..models.float_codec import float_compress_padded, float_decompress_core
from ..ops.bitops import bitcast_u8_to_u32

I32 = jnp.int32


def data_mesh(devices=None, axis: str = "data") -> Mesh:
    """A 1-D data-parallel mesh over all (or given) devices."""
    import numpy as np

    devices = jax.devices() if devices is None else devices
    return Mesh(np.array(devices), (axis,))


def shard_batch(mesh: Mesh, x: jax.Array, axis: str = "data") -> jax.Array:
    """Place a (B, ...) array with B sharded over the mesh axis."""
    return jax.device_put(x, NamedSharding(mesh, P(axis)))


def float_compress_sharded(
    mesh: Mesh,
    data32: jax.Array,
    sizes: jax.Array,
    float_type: FloatType,
    prob_bits: int = 10,
    use_checksum: bool = False,
    axis: str = "data",
) -> Tuple[jax.Array, jax.Array]:
    """Compress a batch sharded over `axis`. Each device compresses its
    members independently; outputs keep the same sharding. Returns
    (comp uint8[B, CB] sharded, comp_bytes uint32[B] sharded)."""
    fn = partial(
        float_compress_padded,
        float_type=FloatType(float_type),
        prob_bits=prob_bits,
        use_checksum=use_checksum,
    )
    spec = P(axis, None)
    sharded = shard_map(
        fn, mesh=mesh, in_specs=(spec, P(axis)), out_specs=(spec, P(axis))
    )
    return jax.jit(sharded)(data32, sizes)


def float_decompress_sharded(
    mesh: Mesh,
    comp_u8: jax.Array,
    out_floats: int,
    float_type: FloatType,
    prob_bits: int = 10,
    axis: str = "data",
):
    """Decompress a sharded batch of archives; outputs sharded alike."""

    def fn(comp, caps):
        return float_decompress_core(
            bitcast_u8_to_u32(comp),
            jnp.zeros((comp.shape[0],), I32),
            out_floats,
            FloatType(float_type),
            prob_bits,
            caps,
        )

    spec = P(axis, None)
    sharded = shard_map(
        fn,
        mesh=mesh,
        in_specs=(spec, P(axis)),
        out_specs=(spec, P(axis), P(axis), P(axis), P(axis)),
    )
    caps = jnp.full((comp_u8.shape[0],), out_floats, I32)
    return jax.jit(sharded)(comp_u8, caps)


def ans_encode_sharded(
    mesh: Mesh,
    x_u8: jax.Array,
    sizes: jax.Array,
    prob_bits: int = 10,
    use_checksum: bool = False,
    axis: str = "data",
):
    fn = partial(
        ans_encode_padded, prob_bits=prob_bits, use_checksum=use_checksum
    )
    spec = P(axis, None)
    sharded = shard_map(
        fn, mesh=mesh, in_specs=(spec, P(axis)), out_specs=(spec, P(axis))
    )
    return jax.jit(sharded)(x_u8, sizes)


def ans_decode_sharded(
    mesh: Mesh,
    comp_u8: jax.Array,
    out_capacity: int,
    prob_bits: int = 10,
    axis: str = "data",
):
    fn = partial(
        ans_decode_padded, out_capacity=out_capacity, prob_bits=prob_bits
    )
    spec = P(axis, None)
    sharded = shard_map(
        fn,
        mesh=mesh,
        in_specs=(spec,),
        out_specs=(spec, P(axis), P(axis), P(axis)),
    )
    return jax.jit(sharded)(comp_u8)


def ans_encode_shared_table(
    mesh: Mesh,
    x_u8: jax.Array,
    sizes: jax.Array,
    prob_bits: int = 10,
    use_checksum: bool = False,
    axis: str = "data",
):
    """Shared-frequency-table encode (SURVEY §2.8): one byte histogram is
    all-reduced over the mesh axis and every shard encodes against the
    identical broadcast table.

    This is the distributed use of the reference's caller-supplied-histogram
    hook (GpuANSCodec.h:82-84): one `psum` replaces B independent statistics
    passes, every member's archive embeds the *same* table (so gathered
    streams can be decoded against one table), and archives remain fully
    self-describing — any member decodes bit-exact through the normal path.
    Normalization uses the global byte total on every shard so the quantized
    tables agree everywhere (global total must fit int32 ~2.1 GB).

    Returns (comp uint8[B, CB] sharded, comp_bytes uint32[B] sharded).
    """
    from ..ops.checksum import mask_packed_bytes
    from ..ops.histogram import histogram_packed

    def fn(x, sz):
        sz = sz.astype(I32)
        pad = (-x.shape[1]) % 4
        xp = jnp.pad(x, ((0, 0), (0, pad))) if pad else x
        x32 = mask_packed_bytes(bitcast_u8_to_u32(xp), sz)
        h = histogram_packed(x32, sz)
        gh = jax.lax.psum(h.sum(axis=0, dtype=jnp.uint32), axis)
        gtot = jax.lax.psum(sz.sum(), axis)
        B = x.shape[0]
        hist = jnp.broadcast_to(gh[None, :], (B, 256))
        tots = jnp.full((B,), 1, I32) * gtot
        return ans_encode_padded(
            x, sz, prob_bits, use_checksum, hist=hist, hist_totals=tots
        )

    spec = P(axis, None)
    sharded = shard_map(
        fn, mesh=mesh, in_specs=(spec, P(axis)), out_specs=(spec, P(axis))
    )
    return jax.jit(sharded)(x_u8, sizes)


def global_compressed_sizes(comp_bytes: jax.Array, mesh: Mesh,
                            axis: str = "data") -> jax.Array:
    """All-gather per-member compressed sizes so every host can assemble
    outputs in submission order (the cross-chip analogue of the reference's
    outSize_dev array)."""

    def fn(local):
        return jax.lax.all_gather(local, axis, tiled=True)

    return jax.jit(
        shard_map(fn, mesh=mesh, in_specs=(P(axis),), out_specs=P(None))
    )(comp_bytes)
