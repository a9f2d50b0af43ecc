// LOG2 activation quantizer (QeiHaN paper Eqs. 2-4, Fig. 5 comparator) for
// Hopper, sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/log2quant/kernel.py
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
// Design for that: one pass, each thread converts a 16-byte vector of
// inputs per step (4 f32 or 8 bf16/f16) and stores its codes as one 4- or
// 8-byte word per output, so loads and stores are full-width and
// coalesced; a grid-stride loop covers any size and a scalar tail masks
// the ragged end itself (the TPU wrapper pads to the block instead).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "log2_rule.cuh"

namespace {

constexpr int kThreads = 256;

enum InputKind { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ uint32_t widen(uint32_t raw, int kind) {
  if (kind == kBF16) return raw << 16;
  if (kind == kF16) return __float_as_uint(__half2float(__ushort_as_half(
      static_cast<unsigned short>(raw))));
  return raw;
}

__device__ __forceinline__ void quantize(uint32_t bits, int sentinel,
                                         int emax, int8_t& e_out,
                                         int8_t& s_out) {
  int e, s;
  qh::log2_code(bits, sentinel, emax, e, s);
  e_out = static_cast<int8_t>(e);
  s_out = static_cast<int8_t>(s);
}

// VEC elements per 16-byte load: 4 f32 or 8 bf16/f16.
template <int KIND>
__global__ void __launch_bounds__(kThreads)
log2quant_kernel(const void* __restrict__ x, int8_t* __restrict__ exp,
                 int8_t* __restrict__ sign, int64_t n, int n_bits,
                 bool vector_ok) {
  constexpr int VEC = KIND == kF32 ? 4 : 8;
  const int sentinel = -(1 << (n_bits - 1));
  const int emax = (1 << (n_bits - 1)) - 1;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t n_vec = vector_ok ? n / VEC : 0;

  for (int64_t i = start; i < n_vec; i += stride) {
    const uint4 raw = reinterpret_cast<const uint4*>(x)[i];
    const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
    alignas(8) int8_t e[VEC];
    alignas(8) int8_t s[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      uint32_t bits;
      if constexpr (KIND == kF32) {
        bits = words[j];
      } else {  // little endian: element 2w in the low half of word w
        bits = widen((words[j / 2] >> (16 * (j % 2))) & 0xFFFFu, KIND);
      }
      quantize(bits, sentinel, emax, e[j], s[j]);
    }
    if constexpr (VEC == 4) {
      reinterpret_cast<uint32_t*>(exp)[i] =
          *reinterpret_cast<const uint32_t*>(e);
      reinterpret_cast<uint32_t*>(sign)[i] =
          *reinterpret_cast<const uint32_t*>(s);
    } else {
      reinterpret_cast<uint2*>(exp)[i] = *reinterpret_cast<const uint2*>(e);
      reinterpret_cast<uint2*>(sign)[i] = *reinterpret_cast<const uint2*>(s);
    }
  }
  for (int64_t i = n_vec * VEC + start; i < n; i += stride) {
    uint32_t bits;
    if constexpr (KIND == kF32) {
      bits = reinterpret_cast<const uint32_t*>(x)[i];
    } else {
      bits = widen(reinterpret_cast<const uint16_t*>(x)[i], KIND);
    }
    quantize(bits, sentinel, emax, exp[i], sign[i]);
  }
}

template <int KIND>
void launch(const void* x, int8_t* exp, int8_t* sign, int64_t n, int n_bits,
            cudaStream_t stream) {
  constexpr int VEC = KIND == kF32 ? 4 : 8;
  // full-width vectors need a 16-byte aligned input; the outputs are fresh
  // allocations (256-byte aligned)
  const bool vector_ok = (reinterpret_cast<uintptr_t>(x) % 16) == 0;
  const int64_t items = vector_ok ? (n + VEC - 1) / VEC : n;
  const int64_t want = (items + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  log2quant_kernel<KIND><<<blocks, kThreads, 0, stream>>>(
      x, exp, sign, n, n_bits, vector_ok);
}

}  // namespace

// x: n contiguous elements of kind 0 (f32), 1 (bf16) or 2 (f16);
// exp, sign: n int8 each.  Returns cudaGetLastError() after the launch.
extern "C" int qh_log2quant(const void* x, void* exp, void* sign, int64_t n,
                            int kind, int n_bits, void* stream) {
  auto* e = static_cast<int8_t*>(exp);
  auto* s = static_cast<int8_t*>(sign);
  auto st = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    if (kind == kBF16) {
      launch<kBF16>(x, e, s, n, n_bits, st);
    } else if (kind == kF16) {
      launch<kF16>(x, e, s, n, n_bits, st);
    } else {
      launch<kF32>(x, e, s, n, n_bits, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* qh_log2quant_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
