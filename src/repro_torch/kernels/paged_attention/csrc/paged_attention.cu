// Paged-attention decode with split-KV partials (GQA) for Hopper, sm_90a:
// the dense page pool (K3).
//
// Replaces the Pallas kernel src/repro/kernels/paged_attention/kernel.py
// (_paged_attn_kernel, launched by paged_attention_kernel and wrapped by
// ops.py::paged_decode_attention).  Same function: per (slot b, kv-head g,
// split) an online softmax over that split's pages of the page table,
//   s    = (q . k) / sqrt(D), masked to pos < length with the finite
//          NEG_INF = -1e30
//   m'   = max(m, max s);  p = pos < length ? exp(s - m') : 0
//   l    = l * corr + sum p;  acc = acc * corr + cast_V(p) . v
// with m, l, acc in f32, p rounded to the V dtype before the PV product as
// the reference does, and the unnormalised (o = acc, m, l) partials written
// out; the split merge is ops.py::merge_split_softmax.  The page walk is
// paged_walk.cuh's, shared with the quantized kernel; this file gives it a
// loader that widens f32 or bf16 K/V elements.
//
// Inputs: q (B, G, R, D); K/V pools (P, page_len, G, D), all f32 or bf16
// (one dtype); table (B, NB) int32 with page 0 the trash page and NB a
// multiple of splits (the wrapper pads with trash columns); lengths (B,)
// int32.  Outputs: o (B, G, splits, R, D) f32, m and l (B, G, splits, R)
// f32.
//
// Pages wholly past a row's length are not loaded, so the kernel reads
// exactly the pages ops.py::gather_traffic_counts counts as touched (and,
// of the last one, only the rows below the length).  Masked p is set to
// exactly 0.  A split with no valid token keeps m = NEG_INF, l = 0, acc =
// 0 (the reference accumulates junk there), and the merge weighs it by
// exp(NEG_INF - M) = 0 either way; a row of length 0 merges to 0.  Live
// rows are bitwise independent of trash pages.  Each warp rounds p to the
// V dtype relative to the max that warp holds, and the warps are merged at
// the end: in bf16 that moves results within the reference's atol = 2e-2
// against the plain version, which rounds relative to the split's max.
//
// What bounds it on an H100: bytes, at decode.  Per (b, g) it reads the
// touched pages' K and V once and does 4 * R * D flops per key, R = 3 on
// smollm-135m: under one flop per byte in bf16.  At the serving path's
// sizes (8 slots, a few hundred tokens each, 30 launches per decode step)
// a launch moves about 1.5 MB, under half a microsecond at 3.35 TB/s, so
// in practice a launch costs its launch latency plus the latency of the
// page loads and page math that one warp does one after another.  So the
// walk spreads a split's pages over the block's 16 warps (one page per
// warp on the serving path: at most 16 pages per split), keeps the next
// page's 16-byte cp.async copies in flight during the current page's math,
// and does the softmax with warp shuffles, so a launch costs about its
// latency plus the load and the math of one page.
#include "paged_walk.cuh"

namespace {

enum InputKind { kF32 = 0, kBF16 = 1 };

// p rounded to the V dtype (round to nearest even) and widened back
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T>
struct DenseLoader {
  using Raw = T;
  const T* k;
  const T* v;
  __device__ __forceinline__ int2 scales(int, int, int) const {
    return make_int2(0, 0);
  }
  __device__ __forceinline__ float k_at(T x, int2) const {
    return paged_walk::to_f32(x);
  }
  __device__ __forceinline__ float v_at(T x, int2) const {
    return paged_walk::to_f32(x);
  }
  __device__ __forceinline__ float round_p(float p) const {
    return round_to(p, v);
  }
};

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* table, const int* lengths, float* o, float* m,
                   float* l, int B, int G, int R, int D, int page_len, int nb,
                   int splits, int n_pages, cudaStream_t stream) {
  const DenseLoader<T> ld{static_cast<const T*>(k), static_cast<const T*>(v)};
  return paged_walk::launch_walk(static_cast<const T*>(q), ld, table,
                                 lengths, o, m, l, B, G, R, D, page_len, nb,
                                 splits, n_pages, stream);
}

}  // namespace

// q (B, G, R, D), k/v (n_pages, page_len, G, D) of kind 0 (f32) or 1
// (bf16); table (B, nb) int32, nb a multiple of splits; lengths (B,)
// int32; o (B, G, splits, R, D), m and l (B, G, splits, R) f32.  Returns
// the CUDA error code of the launch (0 on success).
extern "C" int qh_paged_attention(const void* q, const void* k, const void* v,
                                  const void* table, const void* lengths,
                                  void* o, void* m, void* l, int B, int G,
                                  int R, int D, int page_len, int nb,
                                  int splits, int n_pages, int kind,
                                  void* stream) {
  const auto* t = static_cast<const int*>(table);
  const auto* len = static_cast<const int*>(lengths);
  auto* of = static_cast<float*>(o);
  auto* mf = static_cast<float*>(m);
  auto* lf = static_cast<float*>(l);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (kind == kBF16) {
    rc = launch<__nv_bfloat16>(q, k, v, t, len, of, mf, lf, B, G, R, D,
                               page_len, nb, splits, n_pages, st);
  } else {
    rc = launch<float>(q, k, v, t, len, of, mf, lf, B, G, R, D, page_len, nb,
                       splits, n_pages, st);
  }
  return static_cast<int>(rc);
}

extern "C" const char* qh_paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
