// Paged-attention decode over the log2-quantized KV page pool, split-KV
// partials (GQA), for Hopper, sm_90a.
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
// partials written out.  The explicit zero of masked p matters: garbage
// codes decode to up to 2^127, and p = exp(0) = 1 on a split that has seen
// no valid token yet would overflow acc to inf, which the merge's zero
// weight turns into NaN.  The wrapper passes lengths floored to full pages
// and merges the newest page from the dense tail ring as one more split.
//
// Inputs: q (B, G, R, D) f32 or bf16; code pools (P, page_len, G, D) int8
// (n_bits 2..7) or int16 (n_bits 8); scale pools (P, G) int32; table (B, NB)
// int32 with page 0 the trash page and NB a multiple of splits; lengths
// (B,) int32.  Outputs: o (B, G, splits, R, D) f32, m and l (B, G, splits,
// R) f32.
//
// Pages wholly past a row's length are not loaded, so the kernel reads
// exactly the full pages the floored length covers.  A split with no valid
// token keeps m = NEG_INF, l = 0, acc = 0, as the reference's does (its
// masked p is zero too); the merge weighs it by 0.  Trash-page codes,
// scales and the ring's dead rows reach no live row: a page the kernel
// loads holds at least one valid position, so m' is finite, and masked p
// is 0.
//
// What bounds it on an H100: bytes, at decode, as for the dense kernel,
// with 1-byte codes instead of 2-byte bf16 (2 bytes at 8 bits): per (b, g)
// it reads the touched pages' K and V codes once, one scale each, and does
// 4 * R * D flops per key.  At the serving path's sizes a launch moves
// under a megabyte, so it is bound by latency in practice: each block
// walks its pages one after another.  Design for a first, simple kernel,
// the dense kernel's: one block of 128 threads per (b, g, split); each
// page's page_len x D K and V tiles are dequantized while staged into
// shared memory as f32 (the K tile with a padded row stride against bank
// conflicts in the score loop); the R query rows' m, l and acc stay in
// shared memory in f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

enum QueryKind { kF32 = 0, kBF16 = 1 };
enum CodeKind { kInt8 = 0, kInt16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

template <typename Q, typename C>
__global__ void __launch_bounds__(kThreads)
paged_attention_quant_kernel(const Q* __restrict__ q,
                             const C* __restrict__ k_codes,
                             const int* __restrict__ k_scale,
                             const C* __restrict__ v_codes,
                             const int* __restrict__ v_scale,
                             const int* __restrict__ table,
                             const int* __restrict__ lengths,
                             float* __restrict__ o, float* __restrict__ m_out,
                             float* __restrict__ l_out, int G, int R, int D,
                             int page_len, int nb, int splits, int n_pages,
                             int sentinel) {
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

  const Q* qb = q + static_cast<size_t>(b * G + g) * R * D;
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
    const int kse = k_scale[static_cast<size_t>(page) * G + g];
    const int vse = v_scale[static_cast<size_t>(page) * G + g];
    const size_t base = static_cast<size_t>(page) * page_len * row_stride
                        + static_cast<size_t>(g) * D;
    for (int i = tid; i < page_len * D; i += blockDim.x) {
      const int t = i / D;
      const int d = i - t * D;
      const size_t off = base + t * row_stride + d;
      ks[t * kstride + d] = dequant(k_codes[off], kse, sentinel);
      vs[i] = dequant(v_codes[off], vse, sentinel);
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
        const float p = (pos0 + t < len) ? expf(sr[t] - m_new) : 0.f;
        sum += p;
        sr[t] = p;
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

template <typename Q, typename C>
cudaError_t launch(const void* q, const void* kc, const int* ks,
                   const void* vc, const int* vs, const int* table,
                   const int* lengths, float* o, float* m, float* l, int B,
                   int G, int R, int D, int page_len, int nb, int splits,
                   int n_pages, int sentinel, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (
      static_cast<size_t>(R) * D * 2 + static_cast<size_t>(page_len) * (D + 1)
      + static_cast<size_t>(page_len) * D
      + static_cast<size_t>(R) * page_len + 3 * static_cast<size_t>(R));
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        paged_attention_quant_kernel<Q, C>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  const dim3 grid(splits, G, B);
  paged_attention_quant_kernel<Q, C><<<grid, kThreads, smem, stream>>>(
      static_cast<const Q*>(q), static_cast<const C*>(kc), ks,
      static_cast<const C*>(vc), vs, table, lengths, o, m, l, G, R, D,
      page_len, nb, splits, n_pages, sentinel);
  return cudaGetLastError();
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
