// Plane-skipping bit-plane shift-add GEMM (QeiHaN paper Eq. 5, §IV-B) for
// Hopper, sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/bitplane_matmul/kernel.py
// (_bitplane_matmul_kernel, launched by bitplane_matmul_kernel and wrapped
// by ops.py::bitplane_matmul_pallas).  Same function, exactly, in int32:
//   y[m,n] = sum_b sgn_b * sum_k A_b[m,k] * P_b[k,n],
//   A_b = sign * 2^(b + exp) where b + exp >= 0 (else 0), sentinel -> 0,
//   sgn_b = -1 for the two's-complement sign plane b = 7,
// with planes b < min_plane skipped per 128x128 (m, k) tile of exp, where
// min_plane = clip(-max live exp, 0, 8), or 8 if every code in the tile is
// the sentinel (the reference's _skip_table geometry, padding = sentinel).
//
// How it is evaluated: for one (m, k), the planes a row needs are exactly
// b >= -exp, and min_plane <= -exp for every live exp of the tile, so the
// planes b >= min_plane of column n, OR-ed together at their bit positions,
// give the int8 weight with its low min_plane bits cleared, w_t.  Then
// sum_{b >= min_plane} sgn_b * A_b * P_b = sign * ArithShift(w_t, exp):
// w_t << exp for exp >= 0 (min_plane is 0 there), the arithmetic right
// shift w_t >> -exp for -8 < exp < 0 (the cleared bits shift out), and 0
// for exp <= -8, where no plane has b + exp >= 0.  Integer arithmetic is
// exact, and int32 addition is associative, so the order of the sums does
// not matter.
//
// What bounds it on an H100: at decode (M = batch) it is bytes.  Each
// plane byte fetched is used by at most 4 rows, so the work per byte is a
// few integer operations, far below the card's rate; the unpacked uint8
// planes are 8 bytes per weight.  Design for that:
// * plane skipping is a skipped load, not a masked multiply: a fully
//   pruned or deeply negative tile fetches fewer planes;
// * one block owns a 4 x 32 output tile for ONE 128-deep K tile (split-K),
//   so even the N = 192 projections spread over N/32 x K/128 blocks, and
//   each block issues all of its plane loads at once: 2 threads per k row,
//   16 contiguous bytes of each plane row per load, 8 planes x 16 bytes
//   in flight per thread (on the TPU a sequential K grid axis carried the
//   sum in VMEM instead);
// * the block's min_plane comes from one pass of 16-byte loads over its
//   (m, k) tile of exp: the sentinel is the smallest code, so the tile's
//   byte-wise max is the largest live exponent, or the sentinel when the
//   tile is fully pruned;
// * the 128 k rows' partial sums meet in warp shuffles and a 4 KB shared
//   pass; the K tiles' int32 partials are summed by a second small kernel
//   (int32 addition is exact in any order).
// Tensor cores, TMA and packed planes are later work.
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 4;        // output rows per block
constexpr int kCols = 32;       // output columns per block
constexpr int kTile = 128;      // skip geometry: 128 rows x 128 K columns
constexpr int kThreads = 256;   // 128 k rows x 2 column halves
constexpr int kWarps = kThreads / 32;
constexpr int kBits = 8;

// Largest code of exp[r0:r1, c0:c1] (the sentinel is the smallest code, so
// this is the largest live exponent, or INT_MIN when the range is empty).
__device__ int tile_max_code(const int8_t* __restrict__ exp, int K, int r0,
                             int r1, int c0, int c1, bool vector_ok) {
  const int tid = threadIdx.x;
  int mx = INT_MIN;
  const int width = c1 - c0;
  if (vector_ok && width % 16 == 0) {
    const int chunks = width / 16;
    for (int i = tid; i < (r1 - r0) * chunks; i += kThreads) {
      const int r = r0 + i / chunks;
      const uint4 q = *reinterpret_cast<const uint4*>(
          exp + static_cast<size_t>(r) * K + c0 + 16 * (i % chunks));
      const unsigned w = __vmaxs4(__vmaxs4(q.x, q.y), __vmaxs4(q.z, q.w));
      const int b0 = static_cast<int8_t>(w & 0xFFu);
      const int b1 = static_cast<int8_t>((w >> 8) & 0xFFu);
      const int b2 = static_cast<int8_t>((w >> 16) & 0xFFu);
      const int b3 = static_cast<int8_t>(w >> 24);
      mx = max(mx, max(max(b0, b1), max(b2, b3)));
    }
  } else {
    for (int i = tid; i < (r1 - r0) * width; i += kThreads) {
      const int r = r0 + i / width;
      mx = max(mx, static_cast<int>(
                       exp[static_cast<size_t>(r) * K + c0 + i % width]));
    }
  }
  return mx;
}

__global__ void __launch_bounds__(kThreads)
bitplane_matmul_kernel(const int8_t* __restrict__ exp,
                       const int8_t* __restrict__ sign,
                       const uint8_t* __restrict__ planes,
                       int32_t* __restrict__ out, int M, int K, int N,
                       int sentinel, bool vector_ok) {
  __shared__ int warp_max[kWarps];
  __shared__ int partial[kWarps][kRows][kCols];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kr = tid >> 1;     // k offset inside the K tile
  const int half = tid & 1;    // which 16 of the block's 32 columns
  const int n0 = blockIdx.x * kCols + half * 16;
  const int t = blockIdx.y;    // this block's K tile
  const int m0 = blockIdx.z * kRows;
  const int k = t * kTile + kr;

  // 1. min_plane of this (128-row M tile, K tile), as _skip_table has it
  const int r0 = (m0 / kTile) * kTile;
  int mx = tile_max_code(exp, K, r0, min(r0 + kTile, M), t * kTile,
                         min(t * kTile + kTile, K), vector_ok);
  mx = __reduce_max_sync(0xffffffffu, mx);
  if (lane == 0) warp_max[warp] = mx;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = max(mx, warp_max[w]);
  const int min_plane =
      mx <= sentinel ? kBits : min(max(-mx, 0), kBits);

  // 2. this thread's k row: planes >= min_plane, OR-ed into w_t bytes of
  //    columns n0..n0+15 (plane b lands on bit b of each byte), then
  //    sign * ArithShift(w_t, exp) into 4 x 16 int32 sums
  int acc[kRows][16];
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[m][j] = 0;
  }
  if (min_plane < kBits && k < K) {
    int e[kRows];
    bool negative[kRows];
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      const int r = m0 + m;
      e[m] = r < M ? exp[static_cast<size_t>(r) * K + k] : sentinel;
      negative[m] = r < M && sign[static_cast<size_t>(r) * K + k] < 0;
    }
    uint32_t wt[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int b = 0; b < kBits; ++b) {
      if (b < min_plane) continue;            // skipped plane: never loaded
      const uint8_t* row = planes + (static_cast<size_t>(b) * K + k) * N + n0;
      uint32_t v[4];
      if (vector_ok && n0 + 16 <= N) {
        const uint4 q = *reinterpret_cast<const uint4*>(row);
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
      } else {
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          uint32_t word = 0u;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (n0 + 4 * w + j < N) {
              word |= static_cast<uint32_t>(row[4 * w + j]) << (8 * j);
            }
          }
          v[w] = word;
        }
      }
#pragma unroll
      for (int w = 0; w < 4; ++w) wt[w] |= v[w] << b;
    }
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      if (e[m] == sentinel || e[m] <= -kBits) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int w = static_cast<int8_t>((wt[j >> 2] >> (8 * (j & 3))) &
                                          0xFFu);
        const int v = e[m] >= 0 ? w * (1 << e[m]) : (w >> -e[m]);
        acc[m][j] += negative[m] ? -v : v;
      }
    }
  }

  // 3. sum the 128 k rows: 16 per warp by shuffles, then 8 warps in smem
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      int v = acc[m][j];
#pragma unroll
      for (int off = 2; off < 32; off <<= 1) {
        v += __shfl_xor_sync(0xffffffffu, v, off);
      }
      if (lane < 2) partial[warp][m][half * 16 + j] = v;
    }
  }
  __syncthreads();
  if (tid < kRows * kCols) {
    const int m = tid / kCols;
    const int c = tid % kCols;
    const int r = m0 + m;
    const int n = blockIdx.x * kCols + c;
    if (r < M && n < N) {
      int total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) total += partial[w][m][c];
      // one (M, N) slice per K tile; with one K tile it is the output
      out[(static_cast<size_t>(t) * M + r) * N + n] = total;
    }
  }
}

// out[i] = sum over the K tiles' int32 partials[s][i]
__global__ void sum_partials_kernel(const int32_t* __restrict__ partials,
                                    int32_t* __restrict__ out, int64_t size,
                                    int slices) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= size) return;
  int total = 0;
  for (int s = 0; s < slices; ++s) total += partials[s * size + i];
  out[i] = total;
}

}  // namespace

// exp, sign: (M, K) int8; planes: (8, K, N) uint8 {0,1}; out: (M, N)
// int32; scratch: (ceil(K / 128), M, N) int32 when K > 128, else unused.
// All contiguous.  Returns cudaGetLastError() after the launches.
extern "C" int qh_bitplane_matmul(const void* exp, const void* sign,
                                  const void* planes, void* out,
                                  void* scratch, int M, int K, int N,
                                  int n_bits, void* stream) {
  if (M > 0 && N > 0) {
    const int k_tiles = K > 0 ? (K + kTile - 1) / kTile : 1;
    const bool vector_ok =
        N % 16 == 0 && K % 16 == 0 &&
        reinterpret_cast<uintptr_t>(planes) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(exp) % 16 == 0;
    auto st = static_cast<cudaStream_t>(stream);
    auto* target = static_cast<int32_t*>(k_tiles > 1 ? scratch : out);
    const dim3 grid((N + kCols - 1) / kCols, k_tiles,
                    (M + kRows - 1) / kRows);
    bitplane_matmul_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const int8_t*>(exp), static_cast<const int8_t*>(sign),
        static_cast<const uint8_t*>(planes), target, M, K, N,
        -(1 << (n_bits - 1)), vector_ok);
    if (k_tiles > 1) {
      const int64_t size = static_cast<int64_t>(M) * N;
      sum_partials_kernel<<<static_cast<unsigned>((size + 255) / 256), 256,
                            0, st>>>(target, static_cast<int32_t*>(out),
                                     size, k_tiles);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* qh_bitplane_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
