// LOG2 activation quantizer (QeiHaN paper Eqs. 2-4, Fig. 5 comparator) for
// Hopper, sm_90a: one launch codes a whole list of tensors.
//
// Replaces the Pallas kernel src/repro/kernels/log2quant/kernel.py:65
// (_log2quant_kernel, launched by log2_quantize_kernel and wrapped by
// ops.py::log2_quantize_pallas).  Same function, elementwise:
//   exp  = IEEE exponent field - 127 + (mantissa field >= 3474676), clipped
//          to [-(2^(n-1)), 2^(n-1) - 1]; exponent field 0 (zero, subnormal)
//          and NaN -> the sentinel -(2^(n-1)); +-Inf -> 2^(n-1) - 1
//   sign = -1 iff x < 0 (so -0.0 and NaN give +1)
// bf16 and f16 inputs widen to f32 exactly first, so the field logic is the
// f32 one.  The rule itself lives in ../../include/log2_rule.cuh, shared
// with the bit-plane GEMM, which applies it in its prologue.
//
// What bounds it on an H100: bytes.  It reads each input once and writes
// two int8 codes (6 bytes per f32 element, 4 per bf16/f16) and does a few
// integer operations per element, far below the card's integer rate.
//
// The first version (one launch per tensor) was bound by launches instead:
// the paper evaluation codes 203 recorded tensors of 1.08 MB on average,
// and each launch paid 2.29 us of launch, ramp-up and tail for 0.32 us of
// bytes.  This one takes a list.  A table of up to kMaxEntries entries
// travels by value in the kernel parameters (no copy to the device, so a
// launch stays capturable in a CUDA graph): each entry's input pointer,
// element count, offset into the flat output buffers, and the prefix of
// the entries' chunk counts.  The list is cut into chunks of 16 KB of input
// (4096 f32 or 8192 bf16/f16 elements; an entry's last chunk may be
// shorter); a grid of at most (SMs x resident blocks) blocks strides over
// the chunks and finds a chunk's entry by binary search on the prefix.
// Each thread issues kLoads 16-byte loads before it codes any of them, so
// enough bytes are in flight to keep HBM busy, and stores 4- or 8-byte
// words of codes.  Alignment is decided per entry: 16-byte loads where the
// input pointer is 16-byte aligned (else 2- or 4-byte loads), word stores
// where the entry's output offset is a multiple of the vector width (else
// byte stores).  The outputs hold the entries' codes back to back, with no
// gaps.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "log2_rule.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLoads = 4;          // 16-byte loads in flight per thread
constexpr int kMinBlocks = 4;      // resident a SM: at most 64 registers
constexpr int kMaxEntries = 128;   // the table stays under 4 KB of params

enum InputKind { kF32 = 0, kBF16 = 1, kF16 = 2 };

// entry i codes n[i] elements of x[i] into exp/sign[out[i] ...]; its chunks
// of kChunk elements are chunk[i] .. chunk[i + 1] - 1 of the launch
struct Table {
  const void* x[kMaxEntries];
  int64_t n[kMaxEntries];
  int64_t out[kMaxEntries];
  int32_t chunk[kMaxEntries + 1];
  int32_t count;
};
static_assert(sizeof(Table) + 2 * sizeof(void*) + sizeof(int) <= 4096,
              "the table must fit the 4 KB of classic kernel parameters");

template <int KIND>
constexpr int kVec = KIND == kF32 ? 4 : 8;  // elements per 16 B

// elements of a chunk: kLoads vectors a thread, 16 KB of input
template <int KIND>
constexpr int kChunk = kThreads * kLoads * kVec<KIND>;

template <int KIND>
__device__ __forceinline__ uint32_t f32_bits(uint32_t raw) {
  if constexpr (KIND == kBF16) {
    return raw << 16;
  } else if constexpr (KIND == kF16) {
    return __float_as_uint(__half2float(__ushort_as_half(
        static_cast<unsigned short>(raw))));
  } else {
    return raw;
  }
}

template <int KIND>
__device__ __forceinline__ uint32_t load_one(const void* x, int64_t i) {
  if constexpr (KIND == kF32) {
    return __ldg(static_cast<const uint32_t*>(x) + i);
  } else {
    return __ldg(static_cast<const unsigned short*>(x) + i);
  }
}

__device__ __forceinline__ void code_one(uint32_t bits, int sentinel,
                                         int emax, int8_t& e_out,
                                         int8_t& s_out) {
  int e, s;
  qh::log2_code(bits, sentinel, emax, e, s);
  e_out = static_cast<int8_t>(e);
  s_out = static_cast<int8_t>(s);
}

template <int KIND>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
log2quant_kernel(const __grid_constant__ Table t, int8_t* __restrict__ exp,
                 int8_t* __restrict__ sign, int n_bits) {
  constexpr int VEC = kVec<KIND>;
  constexpr int chunk_len = kChunk<KIND>;
  const int sentinel = -(1 << (n_bits - 1));
  const int emax = (1 << (n_bits - 1)) - 1;
  const int chunks = t.chunk[t.count];
  int entry = 0;
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    // the entry holding chunk c: the last one whose first chunk is <= c
    // (chunks only grow, so the search starts at the previous entry)
    int hi = t.count - 1;
    while (entry < hi) {
      const int mid = (entry + hi + 1) >> 1;
      if (t.chunk[mid] <= c) {
        entry = mid;
      } else {
        hi = mid - 1;
      }
    }
    const void* x = t.x[entry];
    const int64_t base =
        static_cast<int64_t>(c - t.chunk[entry]) * chunk_len;
    const int64_t left = t.n[entry] - base;
    const int len = left < chunk_len ? static_cast<int>(left) : chunk_len;
    int8_t* e_out = exp + t.out[entry] + base;
    int8_t* s_out = sign + t.out[entry] + base;
    // chunk_len is a multiple of VEC, so every chunk of an entry keeps the
    // entry's alignment
    const bool vec_in = (reinterpret_cast<uintptr_t>(x) % 16) == 0;
    const bool vec_out = t.out[entry] % VEC == 0;

    if (vec_in) {
      const uint4* src = reinterpret_cast<const uint4*>(x) + base / VEC;
      const int nvec = len / VEC;  // at most kLoads a thread
      uint4 raw[kLoads];
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const int v = threadIdx.x + k * kThreads;
        if (v < nvec) raw[k] = __ldg(src + v);
      }
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const int v = threadIdx.x + k * kThreads;
        if (v >= nvec) continue;
        const uint32_t words[4] = {raw[k].x, raw[k].y, raw[k].z, raw[k].w};
        alignas(8) int8_t e[VEC];
        alignas(8) int8_t s[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          uint32_t bits;
          if constexpr (KIND == kF32) {
            bits = words[j];
          } else {  // little endian: element 2w in the low half of word w
            bits = f32_bits<KIND>((words[j / 2] >> (16 * (j % 2))) & 0xFFFFu);
          }
          code_one(bits, sentinel, emax, e[j], s[j]);
        }
        if (vec_out) {
          if constexpr (VEC == 4) {
            reinterpret_cast<uint32_t*>(e_out)[v] =
                *reinterpret_cast<const uint32_t*>(e);
            reinterpret_cast<uint32_t*>(s_out)[v] =
                *reinterpret_cast<const uint32_t*>(s);
          } else {
            reinterpret_cast<uint2*>(e_out)[v] =
                *reinterpret_cast<const uint2*>(e);
            reinterpret_cast<uint2*>(s_out)[v] =
                *reinterpret_cast<const uint2*>(s);
          }
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            e_out[v * VEC + j] = e[j];
            s_out[v * VEC + j] = s[j];
          }
        }
      }
      // the entry's ragged end: fewer than VEC elements
      const int i = nvec * VEC + threadIdx.x;
      if (i < len) {
        code_one(f32_bits<KIND>(load_one<KIND>(x, base + i)), sentinel, emax,
                 e_out[i], s_out[i]);
      }
    } else {
      // a misaligned view: element loads, kScalarLoads in flight a thread
      constexpr int kScalarLoads = 8;
      for (int k0 = 0; k0 < chunk_len / kThreads; k0 += kScalarLoads) {
        uint32_t raw[kScalarLoads];
#pragma unroll
        for (int k = 0; k < kScalarLoads; ++k) {
          const int i = threadIdx.x + (k0 + k) * kThreads;
          if (i < len) raw[k] = load_one<KIND>(x, base + i);
        }
#pragma unroll
        for (int k = 0; k < kScalarLoads; ++k) {
          const int i = threadIdx.x + (k0 + k) * kThreads;
          if (i < len) {
            code_one(f32_bits<KIND>(raw[k]), sentinel, emax, e_out[i],
                     s_out[i]);
          }
        }
      }
    }
  }
}

// blocks of the kernel resident on all SMs of the current device, looked
// up once per device and kind; a failed query returns its error
template <int KIND>
cudaError_t resident_blocks(int& blocks) {
  constexpr int kDevices = 64;
  static int cached[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kDevices) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, log2quant_kernel<KIND>, kThreads, 0);
    if (err != cudaSuccess) return err;
    if (sms < 1 || per_sm < 1) return cudaErrorInvalidConfiguration;
    cached[dev] = sms * per_sm;
  }
  blocks = cached[dev];
  return cudaSuccess;
}

template <int KIND>
int launch(const void* const* xs, const int64_t* ns, const int64_t* outs,
           int count, int8_t* exp, int8_t* sign, int n_bits,
           cudaStream_t stream) {
  for (int i = 0; i < count; ++i) {
    if (ns[i] <= 0 || outs[i] < 0) return cudaErrorInvalidValue;
  }
  int most = 0;
  const cudaError_t err = resident_blocks<KIND>(most);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int64_t chunk_len = kChunk<KIND>;
  int64_t chunks = 0;
  for (int i = 0; i < count; ++i) chunks += (ns[i] + chunk_len - 1) / chunk_len;
  if (chunks > INT32_MAX) return cudaErrorInvalidValue;
  Table t;
  int64_t first = 0;
  for (int i = 0; i < count; ++i) {
    t.x[i] = xs[i];
    t.n[i] = ns[i];
    t.out[i] = outs[i];
    t.chunk[i] = static_cast<int32_t>(first);
    first += (ns[i] + chunk_len - 1) / chunk_len;
  }
  t.chunk[count] = static_cast<int32_t>(chunks);
  t.count = count;
  const int blocks = chunks < most ? static_cast<int>(chunks) : most;
  log2quant_kernel<KIND><<<blocks, kThreads, 0, stream>>>(t, exp, sign,
                                                          n_bits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int qh_log2quant_max_entries() { return kMaxEntries; }

// One launch over `count` (1..kMaxEntries) entries of one kind: entry i is
// ns[i] > 0 contiguous elements at xs[i] of kind 0 (f32), 1 (bf16) or
// 2 (f16), coded into exp[outs[i] .. outs[i] + ns[i]) and the same span of
// sign (int8 each).  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue (nothing launched) for arguments it does not take.
extern "C" int qh_log2quant_many(const void* const* xs, const int64_t* ns,
                                 const int64_t* outs, int count, void* exp,
                                 void* sign, int kind, int n_bits,
                                 void* stream) {
  if (count < 1 || count > kMaxEntries || n_bits < 2 || n_bits > 8) {
    return cudaErrorInvalidValue;
  }
  auto* e = static_cast<int8_t*>(exp);
  auto* s = static_cast<int8_t*>(sign);
  auto st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kF32:
      return launch<kF32>(xs, ns, outs, count, e, s, n_bits, st);
    case kBF16:
      return launch<kBF16>(xs, ns, outs, count, e, s, n_bits, st);
    case kF16:
      return launch<kF16>(xs, ns, outs, count, e, s, n_bits, st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* qh_log2quant_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
