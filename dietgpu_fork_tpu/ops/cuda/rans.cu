// Interleaved 32-state rANS block walks for Hopper (sm_90a), called from
// JAX through the XLA FFI (ops/rans_cuda.py).
//
// Both kernels follow the reference's layout (GpuANSEncode.cuh:50-211,
// GpuANSDecode.cuh:56-297): one warp walks one 4 KiB block with its 32
// interleaved states in registers, several blocks share a CTA, and the
// member's table lives in shared memory. Emission slots and reverse reads
// are ranked with __ballot_sync + __popc. Each kernel has the exact
// contract of the plain jax.numpy function it shadows
// (ops/rans_encode.py:encode_blocks, ops/rans_decode.py:decode_blocks),
// which stays the CPU path and the reference the kernels are tested
// against.

#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlockBytes = 4096;
constexpr int kBlockWords = kBlockBytes / 4;  // 1024
constexpr int kMaxWords16 = 2560;  // raw_comp_block_max_size(4096) / 2
constexpr int kMaxWords32 = kMaxWords16 / 2;  // 1280
constexpr int kStageWords32 = kMaxWords32 + 8;  // decode staging stride
constexpr int kStateBits = 31;
constexpr uint32_t kStartState = 1u << 15;  // == ANS_MIN_STATE
constexpr int kMaxProbBits = 11;

// Warps (= 4 KiB blocks) per CTA. Static shared memory stays under 48 KiB:
// encode 2 KiB tables + 4 x (4 KiB input + 5 KiB output) = 38 KiB,
// decode 8 KiB LUT + 4 x (5.03 KiB stream + 4 KiB output) = 44.1 KiB.
constexpr int kEncWarps = 4;
constexpr int kDecWarps = 4;

__global__ void __launch_bounds__(kEncWarps * kWarp)
    rans_encode_kernel(const uint32_t* __restrict__ x32,
                       const int32_t* __restrict__ sizes,
                       const uint32_t* __restrict__ ptab,
                       const uint32_t* __restrict__ mtab,
                       uint32_t* __restrict__ states,
                       uint32_t* __restrict__ streams,
                       int32_t* __restrict__ num_words, int nb, int groups,
                       int prob_bits) {
  __shared__ uint32_t s_tab[256];
  __shared__ uint32_t s_mag[256];
  __shared__ uint4 s_in[kEncWarps][kBlockBytes / 16];
  __shared__ uint4 s_out[kEncWarps][kMaxWords32 / 4];

  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int64_t b = blockIdx.x / groups;
  const int blk = (blockIdx.x % groups) * kEncWarps + warp;

  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    s_tab[i] = ptab[b * 256 + i];
    s_mag[i] = mtab[b * 256 + i];
  }
  __syncthreads();
  if (blk >= nb) return;

  const int64_t g = b * nb + blk;
  const int64_t rest = static_cast<int64_t>(sizes[b]) -
                       static_cast<int64_t>(blk) * kBlockBytes;
  const int valid = static_cast<int>(
      rest < 0 ? 0 : (rest > kBlockBytes ? kBlockBytes : rest));

  uint32_t state = kStartState;
  int nw = 0;
  if (valid > 0) {
    const uint4* src = reinterpret_cast<const uint4*>(x32 + g * kBlockWords);
    for (int i = lane; i < kBlockBytes / 16; i += kWarp) {
      s_in[warp][i] = src[i];
    }
    __syncwarp();
    const uint8_t* in8 = reinterpret_cast<const uint8_t*>(s_in[warp]);
    uint16_t* out16 = reinterpret_cast<uint16_t*>(s_out[warp]);
    const uint32_t check_shift = kStateBits - prob_bits;
    const unsigned below = (1u << lane) - 1u;
    const int steps = (valid + kWarp - 1) / kWarp;
    for (int s = 0; s < steps; ++s) {
      const int p = s * kWarp + lane;
      const bool live = p < valid;
      const uint32_t sym = in8[p];
      const uint32_t t = s_tab[sym];
      const uint32_t magic = s_mag[sym];
      const uint32_t pdf = t & 0xFFFu;
      const uint32_t cdf = (t >> 12) & 0x7FFu;
      const uint32_t shift = min(t >> 23, 31u);

      const bool write = live && state >= (pdf << check_shift);
      const unsigned ballot = __ballot_sync(kFull, write);
      if (write) {
        const int pos = nw + __popc(ballot & below);
        if (pos < kMaxWords16) out16[pos] = static_cast<uint16_t>(state);
        state >>= 16;
      }
      nw += __popc(ballot);
      if (live) {
        // exact (state / pdf, state % pdf) by magic multiply
        // (GpuANSEncode.cuh:79-86); the sum wraps in 32 bits as there
        const uint32_t q = (__umulhi(state, magic) + state) >> shift;
        state = q * (1u << prob_bits) + (state - q * pdf) + cdf;
      }
    }
    __syncwarp();
  }

  states[g * kWarp + lane] = state;
  if (lane == 0) num_words[g] = nw;

  // Staged words, zero past the emitted count, with 16-byte stores.
  const int kept = nw < kMaxWords16 ? nw : kMaxWords16;
  uint4* dst = reinterpret_cast<uint4*>(streams + g * kMaxWords32);
  for (int i = lane; i < kMaxWords32 / 4; i += kWarp) {
    uint4 v = make_uint4(0, 0, 0, 0);
    const int h = 8 * i;  // first u16 slot of this uint4
    if (h < kept) {
      v = s_out[warp][i];
      uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int lo = h + 2 * k;
        if (lo >= kept) {
          w[k] = 0;
        } else if (lo + 1 >= kept) {
          w[k] &= 0xFFFFu;
        }
      }
    }
    dst[i] = v;
  }
}

__global__ void __launch_bounds__(kDecWarps * kWarp)
    rans_decode_kernel(const uint32_t* __restrict__ streams, int sw,
                       const int32_t* __restrict__ comp_words,
                       const int32_t* __restrict__ uncomp_words,
                       const uint32_t* __restrict__ states,
                       const uint32_t* __restrict__ lut,
                       uint32_t* __restrict__ out, int nb, int groups,
                       int prob_bits) {
  __shared__ uint32_t s_lut[1 << kMaxProbBits];
  __shared__ uint32_t s_str[kDecWarps][kStageWords32];
  __shared__ uint4 s_out[kDecWarps][kBlockBytes / 16];

  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int64_t b = blockIdx.x / groups;
  const int blk = (blockIdx.x % groups) * kDecWarps + warp;
  const int nlut = 1 << prob_bits;

  for (int i = threadIdx.x; i < nlut; i += blockDim.x) {
    s_lut[i] = lut[b * nlut + i];
  }
  __syncthreads();
  if (blk >= nb) return;

  const int64_t g = b * nb + blk;
  const uint32_t* gstream = streams + g * sw;
  int uw = uncomp_words[g];
  uw = uw < 0 ? 0 : (uw > kBlockBytes ? kBlockBytes : uw);
  uint8_t* out8 = reinterpret_cast<uint8_t*>(s_out[warp]);

  if (uw > 0) {
    const int cw = comp_words[g];
    int staged = (cw + 1) >> 1;
    staged = staged < 0 ? 0 : (staged > sw ? sw : staged);
    for (int i = lane; i < staged; i += kWarp) s_str[warp][i] = gstream[i];
    __syncwarp();

    uint32_t state = states[g * kWarp + lane];
    const int r = ((uw - 1) & (kWarp - 1)) + 1;  // tail group width
    const int nsteps = (uw + kWarp - 1) / kWarp;
    const uint32_t slot_mask = static_cast<uint32_t>(nlut - 1);
    int ptr = cw;
    for (int k = 0; k < nsteps; ++k) {
      // step 0 decodes the block's tail group of r lanes, later steps
      // full groups walking toward position 0
      const bool live = k > 0 || lane < r;
      const uint32_t ent = s_lut[state & slot_mask];
      if (live) {
        state = ((ent >> 8) & 0xFFFu) * (state >> prob_bits) + (ent >> 20);
      }
      const bool read = live && state < kStartState;
      const unsigned ballot = __ballot_sync(kFull, read);
      if (read) {
        // the reference's reverse ballot (GpuANSDecode.cuh:89-104): lanes
        // read renorm words in descending lane order
        const int idx16 = ptr - __popc(ballot >> lane);
        int i32 = idx16 >> 1;
        i32 = i32 < 0 ? 0 : (i32 > sw - 1 ? sw - 1 : i32);
        const uint32_t w = i32 < staged ? s_str[warp][i32] : gstream[i32];
        state = (state << 16) + ((idx16 & 1) ? (w >> 16) : (w & 0xFFFFu));
      }
      ptr -= __popc(ballot);
      if (live) out8[uw - r - kWarp * k + lane] = static_cast<uint8_t>(ent);
    }
    __syncwarp();
  }

  // Decoded bytes, zero past uw, with 16-byte stores.
  uint4* dst = reinterpret_cast<uint4*>(out + g * kBlockWords);
  for (int i = lane; i < kBlockBytes / 16; i += kWarp) {
    uint4 v = make_uint4(0, 0, 0, 0);
    const int p = 16 * i;  // first byte of this uint4
    if (p < uw) {
      v = s_out[warp][i];
      uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int keep = uw - (p + 4 * k);
        if (keep <= 0) {
          w[k] = 0;
        } else if (keep < 4) {
          w[k] &= (1u << (8 * keep)) - 1u;
        }
      }
    }
    dst[i] = v;
  }
}

ffi::Error launch_status(const char* what) {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string(what) + ": " +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

// Leading dimensions are all batch: vmap (ffi_call's broadcast_all) adds
// one in front of the wrapper's (B, ...) shapes.
int64_t leading(const ffi::Span<const int64_t>& dims, size_t trailing) {
  int64_t n = 1;
  for (size_t i = 0; i + trailing < dims.size(); ++i) n *= dims[i];
  return n;
}

ffi::Error check_prob_bits(int32_t prob_bits) {
  if (prob_bits < 9 || prob_bits > kMaxProbBits) {
    return ffi::Error::InvalidArgument("prob_bits must be 9, 10 or 11");
  }
  return ffi::Error::Success();
}

ffi::Error RansEncodeImpl(cudaStream_t stream, ffi::Buffer<ffi::U32> x32,
                          ffi::Buffer<ffi::S32> sizes,
                          ffi::Buffer<ffi::U32> ptab,
                          ffi::Buffer<ffi::U32> mtab,
                          ffi::ResultBuffer<ffi::U32> states,
                          ffi::ResultBuffer<ffi::U32> streams,
                          ffi::ResultBuffer<ffi::S32> num_words,
                          int32_t prob_bits) {
  ffi::Error pb = check_prob_bits(prob_bits);
  if (pb.failure()) return pb;
  const auto sd = streams->dimensions();
  if (sd.size() < 3 || sd[sd.size() - 1] != kMaxWords32) {
    return ffi::Error::InvalidArgument("rans encode: bad stream shape");
  }
  const int64_t batch = leading(sd, 2);
  const int64_t nb64 = sd[sd.size() - 2];
  const size_t rows = static_cast<size_t>(batch);
  if (x32.element_count() != rows * nb64 * kBlockWords ||
      sizes.element_count() != rows || ptab.element_count() != rows * 256 ||
      mtab.element_count() != rows * 256) {
    return ffi::Error::InvalidArgument("rans encode: inconsistent shapes");
  }
  const int nb = static_cast<int>(nb64);
  if (batch == 0 || nb == 0) return ffi::Error::Success();
  const int groups = (nb + kEncWarps - 1) / kEncWarps;
  rans_encode_kernel<<<static_cast<unsigned>(batch * groups),
                       kEncWarps * kWarp, 0, stream>>>(
      x32.typed_data(), sizes.typed_data(), ptab.typed_data(),
      mtab.typed_data(), states->typed_data(), streams->typed_data(),
      num_words->typed_data(), nb, groups, prob_bits);
  return launch_status("rans encode launch");
}

ffi::Error RansDecodeImpl(cudaStream_t stream, ffi::Buffer<ffi::U32> streams,
                          ffi::Buffer<ffi::S32> comp_words,
                          ffi::Buffer<ffi::S32> uncomp_words,
                          ffi::Buffer<ffi::U32> states,
                          ffi::Buffer<ffi::U32> lut,
                          ffi::ResultBuffer<ffi::U32> out,
                          int32_t prob_bits) {
  ffi::Error pb = check_prob_bits(prob_bits);
  if (pb.failure()) return pb;
  const auto sd = streams.dimensions();
  if (sd.size() < 3 || sd[sd.size() - 1] < 1 ||
      sd[sd.size() - 1] > kStageWords32) {
    return ffi::Error::InvalidArgument("rans decode: bad stream shape");
  }
  const int64_t batch = leading(sd, 2);
  const int64_t nb64 = sd[sd.size() - 2];
  const size_t blocks = static_cast<size_t>(batch * nb64);
  if (out->element_count() != blocks * kBlockWords ||
      comp_words.element_count() != blocks ||
      uncomp_words.element_count() != blocks ||
      states.element_count() != blocks * kWarp ||
      lut.element_count() != static_cast<size_t>(batch) << prob_bits) {
    return ffi::Error::InvalidArgument("rans decode: inconsistent shapes");
  }
  const int nb = static_cast<int>(nb64);
  if (batch == 0 || nb == 0) return ffi::Error::Success();
  const int groups = (nb + kDecWarps - 1) / kDecWarps;
  rans_decode_kernel<<<static_cast<unsigned>(batch * groups),
                       kDecWarps * kWarp, 0, stream>>>(
      streams.typed_data(), static_cast<int>(sd[sd.size() - 1]),
      comp_words.typed_data(),
      uncomp_words.typed_data(), states.typed_data(), lut.typed_data(),
      out->typed_data(), nb, groups, prob_bits);
  return launch_status("rans decode launch");
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(DietgpuRansEncode, RansEncodeImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Attr<int32_t>("prob_bits"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(DietgpuRansDecode, RansDecodeImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Attr<int32_t>("prob_bits"));
