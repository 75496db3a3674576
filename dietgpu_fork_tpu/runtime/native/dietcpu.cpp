// dietcpu: native host codec for the dietgpu archive format.
//
// A from-scratch multithreaded C++ implementation of the same archive
// format as the JAX codec (see core/constants.py and core/reference.py for
// the format specification; format origin: dietgpu/ans/GpuANSUtils.cuh).
// Role in the framework: host-side IO path (compress/decompress straight
// from storage without a device round trip), a fast test oracle for large
// corpora, and the native-runtime counterpart of the reference's C++ host
// layer. No CUDA/GPU concepts; parallelism is std::thread over blocks and
// batch members.
//
// Build: make -C dietgpu_fork_tpu/runtime/native
// ABI: plain C functions (ctypes-friendly), see dgt_* below.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kNumSymbols = 256;
constexpr uint32_t kBlockSize = 4096;
constexpr uint32_t kWarp = 32;
constexpr uint32_t kStateBits = 31;
constexpr uint32_t kMinState = 1u << 15;
constexpr uint32_t kAnsMagicVersion = (0xD00Du << 16) | 1u;
constexpr uint32_t kFloatMagicVersion = (0xF00Fu << 16) | 1u;

inline uint32_t divUp(uint32_t a, uint32_t b) { return (a + b - 1) / b; }
inline uint32_t roundUp(uint32_t a, uint32_t b) { return divUp(a, b) * b; }

struct SymbolTable {
  uint32_t pdf[kNumSymbols];
  uint32_t cdf[kNumSymbols];
  uint32_t magic[kNumSymbols];
  uint32_t shift[kNumSymbols];
};

// ---------------------------------------------------------------------------
// statistics
// ---------------------------------------------------------------------------

void histogram(const uint8_t* data, size_t n, uint32_t* counts, int nthreads) {
  std::memset(counts, 0, kNumSymbols * sizeof(uint32_t));
  if (nthreads <= 1 || n < (1u << 20)) {
    for (size_t i = 0; i < n; ++i) counts[data[i]]++;
    return;
  }
  std::vector<std::vector<uint32_t>> part(nthreads,
                                          std::vector<uint32_t>(kNumSymbols));
  std::vector<std::thread> ts;
  size_t chunk = (n + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    ts.emplace_back([&, t] {
      size_t lo = t * chunk, hi = std::min(n, lo + chunk);
      auto& h = part[t];
      for (size_t i = lo; i < hi; ++i) h[data[i]]++;
    });
  }
  for (auto& th : ts) th.join();
  for (int t = 0; t < nthreads; ++t)
    for (uint32_t s = 0; s < kNumSymbols; ++s) counts[s] += part[t][s];
}

// Exact replica of the quantization semantics (see
// core/reference.py::normalize_probs; format origin
// GpuANSStatistics.cuh:178-367, including the symbol-id distribution quirk).
void normalize(const uint32_t* counts, uint32_t total, int probBits,
               SymbolTable& tab) {
  const uint32_t target = 1u << probBits;
  uint32_t q[kNumSymbols];
  int64_t qsum = 0;
  for (uint32_t s = 0; s < kNumSymbols; ++s) {
    float f = (float)target * ((float)counts[s] / (float)total);
    q[s] = (uint32_t)f;  // truncation
    if (counts[s] > 0 && q[s] == 0) q[s] = 1;
    qsum += q[s];
  }
  // descending sort of (q << 16 | sym)
  uint32_t packed[kNumSymbols];
  for (uint32_t s = 0; s < kNumSymbols; ++s) packed[s] = (q[s] << 16) | s;
  std::sort(packed, packed + kNumSymbols, std::greater<uint32_t>());

  int64_t diff = (int64_t)target - qsum;
  uint32_t sortedSym[kNumSymbols], sortedProb[kNumSymbols];
  for (uint32_t i = 0; i < kNumSymbols; ++i) {
    sortedSym[i] = packed[i] & 0xFFFF;
    sortedProb[i] = packed[i] >> 16;
  }
  if (diff > 0) {
    while (diff > 0) {
      int64_t it = std::min<int64_t>(diff, kNumSymbols);
      for (uint32_t i = 0; i < kNumSymbols; ++i)
        if (sortedSym[i] < (uint32_t)it) sortedProb[i]++;
      diff -= it;
    }
  } else if (diff < 0) {
    diff = -diff;
    while (diff > 0) {
      int64_t gt1 = 0;
      for (uint32_t i = 0; i < kNumSymbols; ++i) gt1 += sortedProb[i] > 1;
      int64_t it = std::min(diff, gt1);
      int64_t start = gt1 - it;
      for (int64_t i = start; i < gt1; ++i) sortedProb[i]--;
      diff -= it;
    }
  }
  for (uint32_t i = 0; i < kNumSymbols; ++i)
    tab.pdf[sortedSym[i]] = sortedProb[i];
  uint32_t c = 0;
  for (uint32_t s = 0; s < kNumSymbols; ++s) {
    tab.cdf[s] = c;
    c += tab.pdf[s];
    uint32_t p = tab.pdf[s];
    if (p == 0) {
      tab.magic[s] = 0;
      tab.shift[s] = 0;
      continue;
    }
    uint32_t sh = 0;
    while ((1u << sh) < p) sh++;  // ceil(log2(p)); p==1 -> 0
    tab.shift[s] = sh;
    uint64_t m = ((((uint64_t)1 << sh) - p) << 32) / p + 1;
    tab.magic[s] = (uint32_t)m;
  }
}

// ---------------------------------------------------------------------------
// rANS block coder (32 interleaved states; lane order defines the stream)
// ---------------------------------------------------------------------------

uint32_t encodeBlock(const uint8_t* in, uint32_t n, const SymbolTable& tab,
                     int probBits, uint16_t* out, uint32_t* statesOut) {
  uint32_t state[kWarp];
  for (uint32_t l = 0; l < kWarp; ++l) state[l] = kMinState;
  uint32_t o = 0;
  const uint32_t checkShift = kStateBits - probBits;
  for (uint32_t base = 0; base < n; base += kWarp) {
    for (uint32_t l = 0; l < kWarp; ++l) {
      uint32_t i = base + l;
      if (i >= n) break;  // lanes ascending; invalid lanes never emit
      uint8_t sym = in[i];
      uint32_t pdf = tab.pdf[sym];
      uint32_t& st = state[l];
      if (st >= (pdf << checkShift)) {
        out[o++] = (uint16_t)st;
        st >>= 16;
      }
      uint32_t t = (uint32_t)(((uint64_t)st * tab.magic[sym]) >> 32);
      uint32_t div = (t + st) >> tab.shift[sym];
      uint32_t mod = st - div * pdf;
      st = (div << probBits) + mod + tab.cdf[sym];
    }
  }
  std::memcpy(statesOut, state, sizeof(state));
  return o;  // uint16 words written
}

void decodeBlock(const uint32_t* statesIn, const uint16_t* words,
                 uint32_t numWords, uint32_t n, const uint32_t* lutSym,
                 const uint32_t* lutPdf, const uint32_t* lutSmc, int probBits,
                 uint8_t* out) {
  uint32_t state[kWarp];
  std::memcpy(state, statesIn, sizeof(state));
  uint32_t ptr = numWords;
  const uint32_t mask = (1u << probBits) - 1;
  uint32_t rem = n % kWarp;
  int64_t base = (int64_t)n - rem;
  // tail partial group first, then full groups walking to position 0
  if (rem) {
    for (int64_t l = rem - 1; l >= 0; --l) {
      uint32_t& st = state[l];
      uint32_t slot = st & mask;
      out[base + l] = (uint8_t)lutSym[slot];
      st = lutPdf[slot] * (st >> probBits) + lutSmc[slot];
      if (st < kMinState) st = (st << 16) | words[--ptr];
    }
  }
  for (base -= kWarp; base >= 0; base -= kWarp) {
    for (int64_t l = kWarp - 1; l >= 0; --l) {
      uint32_t& st = state[l];
      uint32_t slot = st & mask;
      out[base + l] = (uint8_t)lutSym[slot];
      st = lutPdf[slot] * (st >> probBits) + lutSmc[slot];
      if (st < kMinState) st = (st << 16) | words[--ptr];
    }
  }
}

uint8_t checksum8(const uint8_t* p, size_t n) {
  uint8_t c = 0;
  for (size_t i = 0; i < n; ++i) c ^= p[i];
  return c;
}

// ---------------------------------------------------------------------------
// archive assembly / parsing
// ---------------------------------------------------------------------------

uint32_t ansOverhead(uint32_t nb) {
  return 32 + 2 * kNumSymbols + 4 * kWarp * nb + 8 * roundUp(nb, 2);
}

uint32_t ansEncode(const uint8_t* in, uint32_t n, int probBits, int useChecksum,
                   const uint32_t* extHist, uint8_t* out, int nthreads) {
  uint32_t nb = divUp(n, kBlockSize);
  SymbolTable tab{};
  if (n > 0) {
    uint32_t counts[kNumSymbols];
    if (extHist)
      std::memcpy(counts, extHist, sizeof(counts));
    else
      histogram(in, n, counts, nthreads);
    normalize(counts, n, probBits, tab);
  } else {
    std::memset(&tab, 0, sizeof(tab));
  }

  const uint32_t maxW = 2560;
  std::vector<uint16_t> words((size_t)nb * maxW);
  std::vector<uint32_t> states((size_t)nb * kWarp);
  std::vector<uint32_t> numWords(nb ? nb : 1);

  auto encodeRange = [&](uint32_t b0, uint32_t b1) {
    for (uint32_t b = b0; b < b1; ++b) {
      uint32_t start = b * kBlockSize;
      uint32_t len = std::min(kBlockSize, n - start);
      numWords[b] = encodeBlock(in + start, len, tab, probBits,
                                words.data() + (size_t)b * maxW,
                                states.data() + (size_t)b * kWarp);
    }
  };
  if (nthreads > 1 && nb > 8) {
    std::vector<std::thread> ts;
    uint32_t chunk = divUp(nb, nthreads);
    for (int t = 0; t < nthreads; ++t) {
      uint32_t b0 = t * chunk, b1 = std::min(nb, b0 + chunk);
      if (b0 < b1) ts.emplace_back(encodeRange, b0, b1);
    }
    for (auto& th : ts) th.join();
  } else {
    encodeRange(0, nb);
  }

  // aligned prefix (16B = 8 uint16 words)
  std::vector<uint32_t> prefix(nb ? nb : 1);
  uint32_t acc = 0;
  for (uint32_t b = 0; b < nb; ++b) {
    prefix[b] = acc;
    acc += roundUp(numWords[b], 8);
  }
  uint32_t totalWords = acc;

  uint32_t* h = (uint32_t*)out;
  h[0] = kAnsMagicVersion;
  h[1] = nb;
  h[2] = n;
  h[3] = totalWords;
  h[4] = (uint32_t)probBits | ((uint32_t)(useChecksum ? 1 : 0) << 4);
  h[5] = useChecksum ? checksum8(in, n) : 0;
  h[6] = h[7] = 0;
  uint16_t* probs = (uint16_t*)(out + 32);
  for (uint32_t s = 0; s < kNumSymbols; ++s) probs[s] = (uint16_t)tab.pdf[s];
  uint32_t* st = (uint32_t*)(out + 32 + 512);
  std::memcpy(st, states.data(), (size_t)nb * kWarp * 4);
  uint32_t* bw = st + (size_t)nb * kWarp;
  for (uint32_t b = 0; b < nb; ++b) {
    uint32_t uw = (b == nb - 1) ? (n - b * kBlockSize) : kBlockSize;
    bw[2 * b] = (uw << 16) | numWords[b];
    bw[2 * b + 1] = prefix[b];
  }
  if (nb % 2) bw[2 * nb] = bw[2 * nb + 1] = 0;
  uint16_t* dataOut = (uint16_t*)(out + ansOverhead(nb));
  std::memset(dataOut, 0, (size_t)totalWords * 2);
  for (uint32_t b = 0; b < nb; ++b)
    std::memcpy(dataOut + prefix[b], words.data() + (size_t)b * maxW,
                (size_t)numWords[b] * 2);
  return ansOverhead(nb) + totalWords * 2;
}

// returns 0 ok, negative error; *sizeOut = decoded bytes
int ansDecode(const uint8_t* in, uint8_t* out, uint32_t cap, uint32_t* sizeOut,
              uint32_t* checksumOut, int nthreads) {
  const uint32_t* h = (const uint32_t*)in;
  if (h[0] != kAnsMagicVersion) return -1;
  uint32_t nb = h[1], n = h[2];
  int probBits = h[4] & 0xF;
  if (checksumOut) *checksumOut = h[5];
  if (sizeOut) *sizeOut = n;
  if (n > cap) return -2;
  if (n == 0) return 0;

  const uint16_t* probs = (const uint16_t*)(in + 32);
  uint32_t nbuckets = 1u << probBits;
  std::vector<uint32_t> lutSym(nbuckets), lutPdf(nbuckets), lutSmc(nbuckets);
  uint32_t c = 0;
  for (uint32_t s = 0; s < kNumSymbols; ++s) {
    uint32_t p = probs[s];
    for (uint32_t k = 0; k < p; ++k) {
      lutSym[c + k] = s;
      lutPdf[c + k] = p;
      lutSmc[c + k] = k;
    }
    c += p;
  }
  if (c != nbuckets) return -3;

  const uint32_t* st = (const uint32_t*)(in + 32 + 512);
  const uint32_t* bw = st + (size_t)nb * kWarp;
  const uint16_t* data = (const uint16_t*)(in + ansOverhead(nb));

  auto decodeRange = [&](uint32_t b0, uint32_t b1) {
    for (uint32_t b = b0; b < b1; ++b) {
      uint32_t uw = bw[2 * b] >> 16;
      uint32_t cw = bw[2 * b] & 0xFFFF;
      uint32_t startW = bw[2 * b + 1];
      decodeBlock(st + (size_t)b * kWarp, data + startW, cw, uw,
                  lutSym.data(), lutPdf.data(), lutSmc.data(), probBits,
                  out + (size_t)b * kBlockSize);
    }
  };
  if (nthreads > 1 && nb > 8) {
    std::vector<std::thread> ts;
    uint32_t chunk = divUp(nb, nthreads);
    for (int t = 0; t < nthreads; ++t) {
      uint32_t b0 = t * chunk, b1 = std::min(nb, b0 + chunk);
      if (b0 < b1) ts.emplace_back(decodeRange, b0, b1);
    }
    for (auto& th : ts) th.join();
  } else {
    decodeRange(0, nb);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// float codec
// ---------------------------------------------------------------------------

enum FloatType : uint32_t { kF16 = 1, kBF16 = 2, kF32 = 3, kF64 = 4 };

uint32_t floatWordSize(uint32_t ft) {
  return ft == kF16 || ft == kBF16 ? 2 : (ft == kF32 ? 4 : 8);
}
uint32_t numSegments(uint32_t ft) { return ft == kF64 ? 2 : 1; }

uint32_t uncompDataSize(uint32_t ft, uint32_t n) {
  switch (ft) {
    case kF16:
    case kBF16:
      return roundUp(n, 16);
    case kF32:
      return 2 * roundUp(n, 8) + roundUp(n, 16);
    case kF64:
      return 4 * roundUp(n, 4) + 2 * roundUp(n, 8);
  }
  return 0;
}

// split one float word into exponent byte(s) + raw section parts
// (rotate-left-1 tricks; format origin GpuFloatUtils.cuh:194-382)
void splitAll(const uint8_t* words, uint32_t n, uint32_t ft, uint8_t* comp0,
              uint8_t* comp1, uint8_t* sec1, uint8_t* sec2, int nthreads) {
  auto run = [&](uint32_t i0, uint32_t i1) {
    switch (ft) {
      case kF16: {
        const uint16_t* w = (const uint16_t*)words;
        for (uint32_t i = i0; i < i1; ++i) {
          comp0[i] = w[i] >> 8;
          sec1[i] = (uint8_t)w[i];
        }
        break;
      }
      case kBF16: {
        const uint16_t* w = (const uint16_t*)words;
        for (uint32_t i = i0; i < i1; ++i) {
          uint16_t r = (uint16_t)((w[i] << 1) | (w[i] >> 15));
          comp0[i] = r >> 8;
          sec1[i] = (uint8_t)r;
        }
        break;
      }
      case kF32: {
        const uint32_t* w = (const uint32_t*)words;
        uint16_t* lo = (uint16_t*)sec1;
        for (uint32_t i = i0; i < i1; ++i) {
          uint32_t r = (w[i] << 1) | (w[i] >> 31);
          comp0[i] = r >> 24;
          lo[i] = (uint16_t)r;
          sec2[i] = (uint8_t)(r >> 16);
        }
        break;
      }
      case kF64: {
        const uint64_t* w = (const uint64_t*)words;
        uint32_t* lo = (uint32_t*)sec1;
        uint16_t* mid = (uint16_t*)sec2;
        for (uint32_t i = i0; i < i1; ++i) {
          uint64_t r = (w[i] << 1) | (w[i] >> 63);
          comp0[i] = (uint8_t)(r >> 56);
          comp1[i] = (uint8_t)(r >> 48);
          lo[i] = (uint32_t)r;
          mid[i] = (uint16_t)(r >> 32);
        }
        break;
      }
    }
  };
  if (nthreads > 1 && n > (1u << 20)) {
    std::vector<std::thread> ts;
    uint32_t chunk = divUp(n, nthreads);
    for (int t = 0; t < nthreads; ++t) {
      uint32_t a = t * chunk, b = std::min(n, a + chunk);
      if (a < b) ts.emplace_back(run, a, b);
    }
    for (auto& th : ts) th.join();
  } else {
    run(0, n);
  }
}

void joinAll(const uint8_t* comp0, const uint8_t* comp1, const uint8_t* sec1,
             const uint8_t* sec2, uint32_t n, uint32_t ft, uint8_t* words,
             int nthreads) {
  auto run = [&](uint32_t i0, uint32_t i1) {
    switch (ft) {
      case kF16: {
        uint16_t* w = (uint16_t*)words;
        for (uint32_t i = i0; i < i1; ++i)
          w[i] = ((uint16_t)comp0[i] << 8) | sec1[i];
        break;
      }
      case kBF16: {
        uint16_t* w = (uint16_t*)words;
        for (uint32_t i = i0; i < i1; ++i) {
          uint16_t v = ((uint16_t)comp0[i] << 8) | sec1[i];
          w[i] = (uint16_t)((v >> 1) | (v << 15));
        }
        break;
      }
      case kF32: {
        uint32_t* w = (uint32_t*)words;
        const uint16_t* lo = (const uint16_t*)sec1;
        for (uint32_t i = i0; i < i1; ++i) {
          uint32_t v = ((uint32_t)comp0[i] << 24) | ((uint32_t)sec2[i] << 16) |
                       lo[i];
          w[i] = (v >> 1) | (v << 31);
        }
        break;
      }
      case kF64: {
        uint64_t* w = (uint64_t*)words;
        const uint32_t* lo = (const uint32_t*)sec1;
        const uint16_t* mid = (const uint16_t*)sec2;
        for (uint32_t i = i0; i < i1; ++i) {
          uint64_t v = ((uint64_t)comp0[i] << 56) | ((uint64_t)comp1[i] << 48) |
                       ((uint64_t)mid[i] << 32) | lo[i];
          w[i] = (v >> 1) | (v << 63);
        }
        break;
      }
    }
  };
  if (nthreads > 1 && n > (1u << 20)) {
    std::vector<std::thread> ts;
    uint32_t chunk = divUp(n, nthreads);
    for (int t = 0; t < nthreads; ++t) {
      uint32_t a = t * chunk, b = std::min(n, a + chunk);
      if (a < b) ts.emplace_back(run, a, b);
    }
    for (auto& th : ts) th.join();
  } else {
    run(0, n);
  }
}

}  // namespace

extern "C" {

uint32_t dgt_max_compressed_size(uint32_t bytes) {
  uint32_t blocks = divUp(bytes, kBlockSize);
  // replicate the reference's formula, including the 4096-"blocks" overhead
  // quirk (GpuANSEncode.cu:13-25)
  uint64_t raw = ansOverhead(kBlockSize);
  raw += (uint64_t)roundUp(kBlockSize + kBlockSize / 4, 16) * blocks;
  return (uint32_t)roundUp((uint32_t)raw, 16);
}

uint32_t dgt_max_float_compressed_size(uint32_t ft, uint32_t n) {
  uint32_t base = 32 + dgt_max_compressed_size(n) + uncompDataSize(ft, n);
  if (ft == kF64) base += dgt_max_compressed_size(n);
  return base;
}

uint32_t dgt_ans_encode(const uint8_t* in, uint32_t n, int probBits,
                        int useChecksum, uint8_t* out, int nthreads) {
  return ansEncode(in, n, probBits, useChecksum, nullptr, out, nthreads);
}

int dgt_ans_decode(const uint8_t* in, uint8_t* out, uint32_t cap,
                   uint32_t* sizeOut, int nthreads) {
  uint32_t csum = 0;
  int rc = ansDecode(in, out, cap, sizeOut, &csum, nthreads);
  if (rc != 0) return rc;
  const uint32_t* h = (const uint32_t*)in;
  if ((h[4] >> 4) & 1) {
    if (checksum8(out, h[2]) != (uint8_t)csum) return -4;
  }
  return 0;
}

uint32_t dgt_float_compress(const uint8_t* words, uint32_t n, uint32_t ft,
                            int probBits, int useChecksum, uint8_t* out,
                            int nthreads) {
  uint32_t ws = floatWordSize(ft);
  uint32_t nseg = numSegments(ft);
  uint32_t uncomp = uncompDataSize(ft, n);

  std::vector<uint8_t> comp0(n ? n : 1), comp1(nseg > 1 ? (n ? n : 1) : 1);
  uint32_t* h = (uint32_t*)out;
  std::memset(out + 16, 0, 16 + uncomp);  // header2 + aligned section pads

  uint8_t* sec1 = out + 32;
  uint8_t* sec2 = sec1;
  if (ft == kF32) sec2 = sec1 + 2 * roundUp(n, 8);
  if (ft == kF64) sec2 = sec1 + 4 * roundUp(n, 4);
  splitAll(words, n, ft, comp0.data(), comp1.data(), sec1, sec2, nthreads);

  uint8_t* ans0 = out + 32 + uncomp;
  uint32_t s0 = ansEncode(comp0.data(), n, probBits, 0, nullptr, ans0, nthreads);
  uint32_t s0a = roundUp(s0, 16);
  std::memset(ans0 + s0, 0, s0a - s0);
  uint32_t s1 = 0;
  if (nseg > 1) {
    s1 = ansEncode(comp1.data(), n, probBits, 0, nullptr, ans0 + s0a, nthreads);
  }

  h[0] = kFloatMagicVersion;
  h[1] = n;
  h[2] = ft | ((useChecksum ? 1u : 0u) << 4);
  h[3] = useChecksum ? checksum8(words, (size_t)n * ws) : 0;
  h[4] = nseg > 1 ? s0a : 0;  // GpuFloatHeader2.firstCompSegmentBytes
  h[5] = h[6] = h[7] = 0;
  return 32 + uncomp + (nseg > 1 ? s0a + s1 : s0);
}

int dgt_float_decompress(const uint8_t* in, uint8_t* out, uint32_t capFloats,
                         uint32_t* nOut, uint32_t* ftOut, int nthreads) {
  const uint32_t* h = (const uint32_t*)in;
  if (h[0] != kFloatMagicVersion) return -1;
  uint32_t n = h[1], ft = h[2] & 0xF;
  if (nOut) *nOut = n;
  if (ftOut) *ftOut = ft;
  if (n > capFloats) return -2;
  uint32_t nseg = numSegments(ft);
  uint32_t uncomp = uncompDataSize(ft, n);

  std::vector<uint8_t> comp0(n ? n : 1), comp1(nseg > 1 ? (n ? n : 1) : 1);
  const uint8_t* ans0 = in + 32 + uncomp;
  uint32_t sz = 0;
  int rc = ansDecode(ans0, comp0.data(), n, &sz, nullptr, nthreads);
  if (rc != 0 || sz != n) return rc ? rc : -5;
  if (nseg > 1) {
    rc = ansDecode(ans0 + h[4], comp1.data(), n, &sz, nullptr, nthreads);
    if (rc != 0 || sz != n) return rc ? rc : -5;
  }

  const uint8_t* sec1 = in + 32;
  const uint8_t* sec2 = sec1;
  if (ft == kF32) sec2 = sec1 + 2 * roundUp(n, 8);
  if (ft == kF64) sec2 = sec1 + 4 * roundUp(n, 4);
  joinAll(comp0.data(), comp1.data(), sec1, sec2, n, ft, out, nthreads);

  if ((h[2] >> 4) & 1) {
    if (checksum8(out, (size_t)n * floatWordSize(ft)) != (uint8_t)h[3])
      return -4;
  }
  return 0;
}

// batched wrappers: members are rows of a padded matrix (Stride convention)
void dgt_float_compress_batch(const uint8_t* data, uint32_t rowBytes,
                              const uint32_t* sizes, uint32_t numInBatch,
                              uint32_t ft, int probBits, int useChecksum,
                              uint8_t* out, uint32_t outRowBytes,
                              uint32_t* outSizes, int nthreads) {
  std::atomic<uint32_t> next{0};
  auto worker = [&] {
    for (;;) {
      uint32_t i = next.fetch_add(1);
      if (i >= numInBatch) return;
      outSizes[i] = dgt_float_compress(data + (size_t)i * rowBytes, sizes[i],
                                       ft, probBits, useChecksum,
                                       out + (size_t)i * outRowBytes, 1);
    }
  };
  int nt = std::min<uint32_t>(nthreads, numInBatch);
  if (nt <= 1) {
    worker();
    return;
  }
  std::vector<std::thread> ts;
  for (int t = 0; t < nt; ++t) ts.emplace_back(worker);
  for (auto& th : ts) th.join();
}

void dgt_float_decompress_batch(const uint8_t* comp, uint32_t compRowBytes,
                                uint32_t numInBatch, uint8_t* out,
                                uint32_t outRowBytes, uint32_t capFloats,
                                int* status, uint32_t* nOut, int nthreads) {
  std::atomic<uint32_t> next{0};
  auto worker = [&] {
    for (;;) {
      uint32_t i = next.fetch_add(1);
      if (i >= numInBatch) return;
      uint32_t ftv = 0;
      status[i] = dgt_float_decompress(comp + (size_t)i * compRowBytes,
                                       out + (size_t)i * outRowBytes, capFloats,
                                       &nOut[i], &ftv, 1);
    }
  };
  int nt = std::min<uint32_t>(nthreads, numInBatch);
  if (nt <= 1) {
    worker();
    return;
  }
  std::vector<std::thread> ts;
  for (int t = 0; t < nt; ++t) ts.emplace_back(worker);
  for (auto& th : ts) th.join();
}

}  // extern "C"
