"""dietgpu_fork_tpu: lossless compression for numerical data, in JAX.

A from-scratch JAX/XLA re-design, with CUDA kernels for the rANS walks on
the GPU, of the capabilities of
NSagan271/dietgpu_fork (a DietGPU fork): batched byte-wise rANS entropy
coding, float split codecs for fp16/bf16/fp32/fp64, a sparse float codec,
self-describing archives with optional checksums, and a mesh-sharded
distributed layer for compressed collectives.

Layers (bottom to top — compare SURVEY.md §1):

  core/      archive format + NumPy oracle codec (the executable spec)
  ops/       device ops: rANS coder (plain + CUDA), tables, histograms,
             split/join, runs-merge
  models/    assembled codec pipelines (ANS, float, sparse), jit-friendly
  api/       torch-ops-compatible batch API + interop
  parallel/  jax.sharding mesh integration, compressed collectives
  runtime/   native host codec (C++), temp-memory accounting
"""

from .core.constants import (  # noqa: F401
    BLOCK_SIZE,
    DEFAULT_PROB_BITS,
    FloatType,
    max_compressed_size,
    max_float_compressed_size,
    max_sparse_float_compressed_size,
)
from .api import codec  # noqa: F401
from .api.codec import (  # noqa: F401
    DecompressStatus,
    compress_data,
    compress_data_simple,
    compress_data_split_size,
    decompress_data,
    decompress_data_simple,
    decompress_data_split_size,
    max_any_compressed_output_size,
    max_float_compressed_output_size,
)
from .models.ans import (  # noqa: F401
    ans_decode_padded,
    ans_encode_padded,
    ans_get_compressed_info,
)
from .models.float_codec import (  # noqa: F401
    float_compress_core,
    float_compress_padded,
    float_decompress_core,
    float_get_compressed_info,
)
from .models.sparse import (  # noqa: F401
    sparse_float_compress_core,
    sparse_float_compress_padded,
    sparse_float_decompress_core,
)

__version__ = "0.1.0"
