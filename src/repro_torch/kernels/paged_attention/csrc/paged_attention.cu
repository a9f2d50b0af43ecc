// Paged-attention decode with split-KV partials (GQA) for Hopper, sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/paged_attention/kernel.py
// (_paged_attn_kernel, launched by paged_attention_kernel and wrapped by
// ops.py::paged_decode_attention).  Same function: per (slot b, kv-head g,
// split) an online softmax over that split's pages of the page table,
//   s    = (q . k) / sqrt(D), masked to pos < length with the finite
//          NEG_INF = -1e30
//   m'   = max(m, max s);  p = exp(s - m');  corr = exp(m - m')
//   l    = l * corr + sum p;  acc = acc * corr + cast_V(p) . v
// with m, l, acc in f32, p rounded to the V dtype before the PV product as
// the reference does, and the unnormalised (o = acc, m, l) partials written
// out; the split merge is ops.py::merge_split_softmax.
//
// Inputs: q (B, G, R, D); K/V pools (P, page_len, G, D), all f32 or bf16
// (one dtype); table (B, NB) int32 with page 0 the trash page and NB a
// multiple of splits (the wrapper pads with trash columns); lengths (B,)
// int32.  Outputs: o (B, G, splits, R, D) f32, m and l (B, G, splits, R)
// f32.
//
// Pages wholly past a row's length are not loaded: the page loop stops at
// ceil(length / page_len), so the kernel reads exactly the pages that
// ops.py::gather_traffic_counts counts as touched.  Where a split holds a
// valid token the result is the reference's bit for bit in structure (a
// skipped page would add p = exp(NEG_INF - m) = 0 exactly and corr = 1); a
// split with no valid token keeps m = NEG_INF, l = 0, acc = 0 (the
// reference accumulates junk there), and the merge weighs it by
// exp(NEG_INF - M) = 0 either way.  A row of length 0 merges to 0: finite.
// Trash-page contents reach only masked positions, whose p is exactly 0,
// so live rows are bitwise independent of them.
//
// What bounds it on an H100: bytes, at decode.  Per (b, g) it reads the
// touched pages' K and V (2 * page_len * D elements per page) once and does
// 4 * R * D flops per key, R = 3 on smollm-135m: about 0.75 flop per byte
// in bf16, far below the card's ratio.  At the serving path's sizes (8
// slots, a few hundred tokens each) a launch moves about 1.5 MB, under
// half a microsecond at 3.35 TB/s, so in practice a launch is bound by
// latency: each block walks its pages one after another.  Design for a
// first, simple kernel: one block of 128 threads per (b, g, split); each
// page's page_len x D K and V tiles are staged in shared memory as f32
// (the K tile with a padded row stride, so the score loop's threads, which
// walk different keys, hit different banks); the R query rows' m, l and
// acc stay in shared memory in f32.  Loads are one element per thread per
// step, contiguous in D within a row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

enum InputKind { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// p rounded to the V dtype (round to nearest even) and widened back
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int* __restrict__ table,
                       const int* __restrict__ lengths,
                       float* __restrict__ o, float* __restrict__ m_out,
                       float* __restrict__ l_out, int G, int R, int D,
                       int page_len, int nb, int splits, int n_pages) {
  extern __shared__ float smem[];
  const int split = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int bps = nb / splits;
  const int kstride = D + 1;

  float* qs = smem;                           // R * D
  float* ks = qs + R * D;                     // page_len * (D + 1)
  float* vs = ks + page_len * kstride;        // page_len * D
  float* sc = vs + page_len * D;              // R * page_len
  float* acc = sc + R * page_len;             // R * D
  float* ms = acc + R * D;                    // R
  float* ls = ms + R;                         // R
  float* cs = ls + R;                         // R

  const T* qb = q + static_cast<size_t>(b * G + g) * R * D;
  for (int i = tid; i < R * D; i += blockDim.x) {
    qs[i] = to_f32(qb[i]);
    acc[i] = 0.f;
  }
  for (int i = tid; i < R; i += blockDim.x) {
    ms[i] = kNegInf;
    ls[i] = 0.f;
  }

  const int len = lengths[b];
  const float scale = sqrtf(static_cast<float>(D));
  const int live_pages = len > 0 ? (len + page_len - 1) / page_len : 0;
  const int j0 = split * bps;
  const int j1 = min(j0 + bps, live_pages);
  const size_t row_stride = static_cast<size_t>(G) * D;
  __syncthreads();

  for (int j = j0; j < j1; ++j) {
    int page = table[static_cast<size_t>(b) * nb + j];
    page = min(max(page, 0), n_pages - 1);
    const size_t base = static_cast<size_t>(page) * page_len * row_stride
                        + static_cast<size_t>(g) * D;
    for (int i = tid; i < page_len * D; i += blockDim.x) {
      const int t = i / D;
      const int d = i - t * D;
      const size_t off = base + t * row_stride + d;
      ks[t * kstride + d] = to_f32(k_pool[off]);
      vs[i] = to_f32(v_pool[off]);
    }
    __syncthreads();

    const int pos0 = j * page_len;
    for (int i = tid; i < R * page_len; i += blockDim.x) {
      const int r = i / page_len;
      const int t = i - r * page_len;
      const float* qr = qs + r * D;
      const float* kt = ks + t * kstride;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kt[d], dot);
      sc[i] = (pos0 + t < len) ? dot / scale : kNegInf;
    }
    __syncthreads();

    for (int r = tid; r < R; r += blockDim.x) {
      float* sr = sc + r * page_len;
      float mx = kNegInf;
      for (int t = 0; t < page_len; ++t) mx = fmaxf(mx, sr[t]);
      const float m_prev = ms[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = 0; t < page_len; ++t) {
        const float p = expf(sr[t] - m_new);
        sum += p;
        sr[t] = round_to(p, v_pool);
      }
      const float corr = expf(m_prev - m_new);
      ls[r] = ls[r] * corr + sum;
      cs[r] = corr;
      ms[r] = m_new;
    }
    __syncthreads();

    for (int i = tid; i < R * D; i += blockDim.x) {
      const int r = i / D;
      const int d = i - r * D;
      const float* pr = sc + r * page_len;
      float pv = 0.f;
      for (int t = 0; t < page_len; ++t) pv = fmaf(pr[t], vs[t * D + d], pv);
      acc[i] = acc[i] * cs[r] + pv;
    }
    __syncthreads();
  }

  const size_t ob = (static_cast<size_t>(b * G + g) * splits + split) * R;
  for (int i = tid; i < R * D; i += blockDim.x) o[ob * D + i] = acc[i];
  for (int i = tid; i < R; i += blockDim.x) {
    m_out[ob + i] = ms[i];
    l_out[ob + i] = ls[i];
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* table, const int* lengths, float* o, float* m,
                   float* l, int B, int G, int R, int D, int page_len, int nb,
                   int splits, int n_pages, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (
      static_cast<size_t>(R) * D * 2 + static_cast<size_t>(page_len) * (D + 1)
      + static_cast<size_t>(page_len) * D
      + static_cast<size_t>(R) * page_len + 3 * static_cast<size_t>(R));
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        paged_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  const dim3 grid(splits, G, B);
  paged_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), table, lengths, o, m, l, G, R, D, page_len,
      nb, splits, n_pages);
  return cudaGetLastError();
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
