// Paged-attention decode over the log2-quantized KV page pool, split-KV
// partials (GQA), for Hopper, sm_90a (K4).
//
// Replaces the Pallas kernel src/repro/kernels/paged_attention/kernel.py
// (_paged_attn_quant_kernel, launched by paged_attention_quant_kernel and
// wrapped by ops.py::paged_decode_attention_quant).  Same function: per
// (slot b, kv-head g, split) an online softmax over that split's pages of
// the page table, each page read as packed log2 wire codes plus one scale
// exponent per (page, head) and dequantized in registers,
//   exp = code >> 1 (arithmetic), neg = code & 1
//   k   = 0 at the sentinel exp == -2^(n_bits-1), else
//         (-1)^neg * 2^clamp(exp + se, -126, 127)   (built from IEEE bits)
//   s   = (q . k) / sqrt(D), masked to pos < length with NEG_INF = -1e30
//   m'  = max(m, max s);  p = pos < length ? exp(s - m') : 0;  corr = ...
//   l   = l * corr + sum p;  acc = acc * corr + p . v
// with q widened to f32, m, l, acc and p in f32 (unlike the dense kernel, p
// is not rounded to a cache dtype), and the unnormalised (o = acc, m, l)
// partials written out.  The page walk is paged_walk.cuh's, shared with
// the dense kernel; this file gives it a loader that decodes int8 (n_bits
// 2..7) or int16 (n_bits 8) codes under the page's scale.  The explicit
// zero of masked p matters: garbage codes decode to up to 2^127, and p =
// exp(0) = 1 on a warp that has seen no valid token yet would overflow acc
// to inf, which the merge's zero weight turns into NaN.  The wrapper passes
// lengths floored to full pages and merges the newest page from the dense
// tail ring as one more split.
//
// Inputs: q (B, G, R, D) f32 or bf16; code pools (P, page_len, G, D) int8
// or int16; scale pools (P, G) int32; table (B, NB) int32 with page 0 the
// trash page and NB a multiple of splits; lengths (B,) int32.  Outputs: o
// (B, G, splits, R, D) f32, m and l (B, G, splits, R) f32.
//
// Pages wholly past a row's length are not loaded, so the kernel reads
// exactly the full pages the floored length covers.  A split (or a warp)
// with no valid token keeps m = NEG_INF, l = 0, acc = 0, as the
// reference's does; the merges weigh it by 0.  Trash-page codes, scales
// and the ring's dead rows reach no live row.
//
// What bounds it on an H100: bytes, at decode, as for the dense kernel,
// with 1-byte codes instead of 2-byte bf16 (2 bytes at 8 bits) and one
// scale per page and head: per (b, g) it reads the touched pages' codes
// once and does 4 * R * D flops per key.  At the serving path's sizes (30
// launches per decode step, under a megabyte each) a launch costs its
// launch latency plus the latency of the page loads and page math one warp
// does one after another.  So paged_walk.cuh spreads the split's pages
// over 16 warps, copies the next page's codes 16 bytes (16 codes at 4
// bits; a D = 64 code row is 4 copies) per cp.async while the current
// page's math runs, dequantizes each code as it is read from shared
// memory, and does the softmax by warp shuffles.
#include "paged_walk.cuh"

namespace {

enum QueryKind { kF32 = 0, kBF16 = 1 };
enum CodeKind { kInt8 = 0, kInt16 = 1 };

// sign * 2^clamp(exp + se, -126, 127), the sentinel to +0; the sum wraps
// like the reference's int32 arithmetic (only garbage scales reach that)
__device__ __forceinline__ float dequant(int code, int se, int sentinel) {
  const int e = code >> 1;
  if (e == sentinel) return 0.f;
  int ee = static_cast<int>(static_cast<unsigned>(e)
                            + static_cast<unsigned>(se));
  ee = min(max(ee, -126), 127);
  const unsigned bits = (static_cast<unsigned>(code & 1) << 31)
                        | (static_cast<unsigned>(ee + 127) << 23);
  return __uint_as_float(bits);
}

template <typename C>
struct QuantLoader {
  using Raw = C;
  const C* k;
  const C* v;
  const int* k_scale;
  const int* v_scale;
  int sentinel;
  __device__ __forceinline__ int2 scales(int page, int g, int G) const {
    const size_t i = static_cast<size_t>(page) * G + g;
    return make_int2(k_scale[i], v_scale[i]);
  }
  __device__ __forceinline__ float k_at(C x, int2 s) const {
    return dequant(x, s.x, sentinel);
  }
  __device__ __forceinline__ float v_at(C x, int2 s) const {
    return dequant(x, s.y, sentinel);
  }
  __device__ __forceinline__ float round_p(float p) const { return p; }
};

template <typename Q, typename C>
cudaError_t launch(const void* q, const void* kc, const int* ks,
                   const void* vc, const int* vs, const int* table,
                   const int* lengths, float* o, float* m, float* l, int B,
                   int G, int R, int D, int page_len, int nb, int splits,
                   int n_pages, int sentinel, cudaStream_t stream) {
  const QuantLoader<C> ld{static_cast<const C*>(kc),
                          static_cast<const C*>(vc), ks, vs, sentinel};
  return paged_walk::launch_walk(static_cast<const Q*>(q), ld, table,
                                 lengths, o, m, l, B, G, R, D, page_len, nb,
                                 splits, n_pages, stream);
}

template <typename Q>
cudaError_t launch_codes(int code_kind, const void* q, const void* kc,
                         const int* ks, const void* vc, const int* vs,
                         const int* table, const int* lengths, float* o,
                         float* m, float* l, int B, int G, int R, int D,
                         int page_len, int nb, int splits, int n_pages,
                         int sentinel, cudaStream_t stream) {
  if (code_kind == kInt16) {
    return launch<Q, int16_t>(q, kc, ks, vc, vs, table, lengths, o, m, l, B,
                              G, R, D, page_len, nb, splits, n_pages,
                              sentinel, stream);
  }
  return launch<Q, int8_t>(q, kc, ks, vc, vs, table, lengths, o, m, l, B, G,
                           R, D, page_len, nb, splits, n_pages, sentinel,
                           stream);
}

}  // namespace

// q (B, G, R, D) of kind 0 (f32) or 1 (bf16); code pools (n_pages,
// page_len, G, D) of code kind 0 (int8) or 1 (int16); scale pools
// (n_pages, G) int32; table (B, nb) int32, nb a multiple of splits;
// lengths (B,) int32; o (B, G, splits, R, D), m and l (B, G, splits, R)
// f32.  Returns the CUDA error code of the launch (0 on success).
extern "C" int qh_paged_attention_quant(
    const void* q, const void* k_codes, const void* k_scale,
    const void* v_codes, const void* v_scale, const void* table,
    const void* lengths, void* o, void* m, void* l, int B, int G, int R,
    int D, int page_len, int nb, int splits, int n_pages, int n_bits,
    int q_kind, int code_kind, void* stream) {
  const auto* ks = static_cast<const int*>(k_scale);
  const auto* vs = static_cast<const int*>(v_scale);
  const auto* t = static_cast<const int*>(table);
  const auto* len = static_cast<const int*>(lengths);
  auto* of = static_cast<float*>(o);
  auto* mf = static_cast<float*>(m);
  auto* lf = static_cast<float*>(l);
  auto st = static_cast<cudaStream_t>(stream);
  const int sentinel = -(1 << (n_bits - 1));
  cudaError_t rc;
  if (q_kind == kBF16) {
    rc = launch_codes<__nv_bfloat16>(code_kind, q, k_codes, ks, v_codes, vs,
                                     t, len, of, mf, lf, B, G, R, D, page_len,
                                     nb, splits, n_pages, sentinel, st);
  } else {
    rc = launch_codes<float>(code_kind, q, k_codes, ks, v_codes, vs, t, len,
                             of, mf, lf, B, G, R, D, page_len, nb, splits,
                             n_pages, sentinel, st);
  }
  return static_cast<int>(rc);
}

extern "C" const char* qh_paged_attention_quant_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
