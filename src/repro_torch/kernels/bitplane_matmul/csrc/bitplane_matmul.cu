// LOG2 quantizer + plane-skipping bit-plane shift-add GEMM in one launch
// (QeiHaN paper Eqs. 2-5, §IV-B) for Hopper, sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/bitplane_matmul/kernel.py
// (_bitplane_matmul_kernel, launched by bitplane_matmul_kernel) and, in its
// prologue, src/repro/kernels/log2quant/kernel.py (_log2quant_kernel),
// whose codes are the GEMM's only input.  Same function, exactly, in int32:
//   xs   = float32(x) / act_scale        (IEEE division, __fdiv_rn)
//   code = the LOG2 rule of ../../include/log2_rule.cuh on xs
//   y[m,n] = sum_k sign * ArithShift(w[k,n], exp)
//          = sum_b sgn_b * sum_k A_b[m,k] * P_b[k,n],
//   A_b = sign * 2^(b + exp) where b + exp >= 0 (else 0), sentinel -> 0,
//   sgn_b = -1 for the two's-complement sign plane b = 7,
// with planes b < min_plane skipped per 128x128 (m, k) tile of the codes,
// min_plane = clip(-max live exp, 0, 8), or 8 if every code in the tile is
// the sentinel (the reference's _skip_table; padding counts as sentinel).
// A third input kind takes the codes themselves (exp, sign) and skips the
// division and the rule.  The planes come in either layout the model
// stores: uint8 {0,1} (8, K, N), or packed along K (8, K/8, N) with bit j
// of byte g holding k = 8g + j.  The layout is a loader type on one body.
//
// Why skipping planes is exact: for one (m, k) the planes a row needs are
// b >= -exp, and min_plane <= -exp for every live exp of the tile, so the
// planes b >= min_plane of column n at their bit positions give the int8
// weight with its low min_plane bits cleared, w_t, and
//   sum_{b >= min_plane} sgn_b * A_b * P_b = sign * ArithShift(w_t, exp):
// w_t << exp for exp >= 0 (min_plane is 0 there), the arithmetic right
// shift w_t >> -exp for -8 < exp < 0 (the cleared bits shift out), and 0
// for exp <= -8.
//
// Two bodies, chosen by the wrapper from M and N (bit-equal to each other;
// the wrapper takes the tensor cores from 128 rows and 128 x 384 outputs,
// where they start to win):
//
// * Integer (decode, M = 4..8 on the serving paths; the only body for
//   n_bits = 5): bound by bytes and by latency.  A decode step reads each
//   plane byte once for a handful of rows, so the work per byte is a few
//   integer operations and a launch is a chain of dependent round trips.
//   The prologue issues all of a thread's activation loads (4 k at a time)
//   before it divides any, so the chain is one L2 round trip, the block's
//   min_plane, then the plane loads.  For the packed layout each thread
//   owns one 8-k group of 8 columns: it issues the 8 planes' 8-byte loads
//   at once (skipped planes are skipped loads), and an 8x8 bit transpose
//   in registers, run on 4 columns per 32-bit word, turns the planes'
//   bytes into the 8 int8 weights w_t.  For the unpacked layout (8x the
//   bytes) two threads share a group, 4 k each, so that a thread's 32
//   byte-plane loads are all in flight before they are combined.  Up to 4
//   bits a row then costs 3 integer operations per (4 k, n): the weight
//   bytes masked
//   to clear their low -exp bits and two dp2a against 16-bit factors
//   sign * 2^(exp + 7), exact because every such product is a multiple of
//   2^7 below 2^21 in magnitude, 8 of them below 2^24 (the sum is shifted
//   back by 7 per thread).  At 5 bits the factors do not fit 16 bits, and
//   a row costs 3 operations per (k, n): extract the signed byte, shift it
//   right by -exp, multiply-add sign * 2^max(exp, 0).
//   On an H100 (chip_smoke.py phase 5, a smollm-135m decode step's 210
//   launches, packed planes) the step takes about 1.24 ms, 1.20 ms with
//   the codes fed in and 0.21 ms for an empty kernel of the same launch
//   shapes: neither the launch nor the division bounds it, the chain of
//   round trips in the body does (38x the bytes bound).
// * Tensor cores (prefill and chunk rows, n_bits <= 4): mma.sync m16n8k16
//   in bf16 on the plane form, y = sum_b (A' @ (sgn_b 2^b P_b)) with
//   A' = sign * 2^exp masked to 0 where b + exp < 0.  Both factors are
//   powers of two or 0 and exact in bf16; every product is an integer of
//   at most 2^14.  Per k the plane sum is below 2^7 * 255 < 2^15, so an
//   f32 accumulator is exact over 512 k (every partial sum stays below
//   2^24); it is flushed to int32 after every 128-deep K tile.  (n_bits = 5
//   reaches 2^22 per product and takes the integer body.)  A block of 8
//   warps owns 128 rows x 64 columns; its w_t tile (the same loader) sits
//   in shared memory as bytes; each warp builds its B fragments from them
//   and its A fragments from one 16-bit code per (m, k) (A' with the plane
//   threshold in its zero mantissa bits), 3 integer operations per
//   fragment register and plane.  The w_t tile is stored by plain loads,
//   not staged by cp.async or TMA: at the serving K (576 and 1536 for
//   smollm-135m, 1536 and 3072 for mamba2-780m) a cluster rank owns one
//   to three K tiles, so a double buffer across K tiles would have at most
//   two loads to hide.  On an H100 (chip_smoke.py phase 5, the
//   smollm-135m prefill's 256 rows) a launch takes 25-65 us packed, 15-55x
//   its bound: an empty kernel of its launch shape takes about 1 us,
//   feeding the codes in (no division) saves 3-13%, and the unpacked
//   layout's 8x bytes add 15-32%; the rest is the block's serial chain
//   (the code tile and its max, the w_t tile, then up to 8 planes of
//   fragment building and mma.sync per 16-deep k step, the cluster sum).
//
// Split K inside the one launch: a thread-block cluster of up to 8 blocks
// along K, each rank a run of whole 128-deep K tiles, so even the N = 192
// projections spread over the SMs.  The ranks' int32 tiles meet through
// distributed shared memory: in the integer body every rank but 0 stores
// its tile into rank 0's shared memory, one cluster barrier, and rank 0
// sums and stores (the latency of a decode launch is what counts there);
// in the tensor-core body each rank sums and stores a slice of the output.
// No memset and no second kernel; int32 addition is exact in any order, so
// the result does not depend on the split.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "log2_rule.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBits = 8;
constexpr int kTile = 128;           // skip tile: 128 rows x 128 k
constexpr int kGroups = kTile / 8;   // 8-k groups (packed rows) per K tile
constexpr int kCols = 8;             // columns per thread: one 8-byte load
constexpr int kMaxCluster = 8;

// integer body: 16 rows x 64 columns per block, up to 2 K tiles at once
constexpr int kDecRows = 16;
constexpr int kDecCg = 8;                       // column groups of 8
constexpr int kDecN = kDecCg * kCols;           // 64
constexpr int kDecTiles = 2;
constexpr int kDecMaxThreads = kDecTiles * kGroups * 2 * kDecCg;   // 512

// tensor-core body: 128 rows x 64 columns per block, 8 warps of 32 x 32
constexpr int kTcRows = 128;
constexpr int kTcN = 64;
constexpr int kTcThreads = 256;
constexpr int kTcMi = 2;                 // m16 blocks per warp
constexpr int kCodeLd = kTile + 8;       // u16 stride of the code tile
constexpr int kRedLd = kTcN + 4;         // int32 stride of the output tile
constexpr int kWtLd = kTcN + 16;         // byte stride of the w_t tile

enum Input { kF32 = 0, kBF16 = 1, kCodes = 2 };

struct Params {
  const void* x;              // (M, K) f32 or bf16 (kF32, kBF16)
  const float* act_scale;     // device scalar (kF32, kBF16)
  const int8_t* exp_in;       // (M, K) codes (kCodes)
  const int8_t* sign_in;
  const uint8_t* planes;      // (8, K, N) or (8, K / 8, N)
  int32_t* out;               // (M, N)
  int8_t* exp_out;            // (M, K) or null
  int8_t* sign_out;
  int M, K, N;
  int sentinel, emax;
  int k_tiles, tiles_per_rank;
  int vec;                    // 8-byte plane loads are aligned
  int xvec;                   // 4-wide input loads are aligned
};

// prmt.b32 with the sign-replicating selectors (a selector nibble of 8 + i
// copies the sign of byte i into the whole output byte); __byte_perm keeps
// only 3 bits of each nibble
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// ---------------------------------------------------------------------------
// the prologue: one code
// ---------------------------------------------------------------------------

// The raw input of k .. k + 3 of one row (n valid): f32 bits, bf16 bits
// widened to f32 (exact), or the codes as exp | sign << 8.  Loads only, so
// that a batch of them is in flight before any division.
template <int IN>
__device__ __forceinline__ void load4(const Params& p, size_t at, int n,
                                      uint32_t (&raw)[4]) {
  if constexpr (IN == kF32) {
    const uint32_t* x = static_cast<const uint32_t*>(p.x) + at;
    if (p.xvec) {
      const uint4 v = *reinterpret_cast<const uint4*>(x);
      raw[0] = v.x; raw[1] = v.y; raw[2] = v.z; raw[3] = v.w;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) raw[q] = q < n ? x[q] : 0u;
    }
  } else if constexpr (IN == kBF16) {
    const uint16_t* x = static_cast<const uint16_t*>(p.x) + at;
    if (p.xvec) {
      const uint2 v = *reinterpret_cast<const uint2*>(x);
      raw[0] = v.x << 16; raw[1] = v.x & 0xFFFF0000u;
      raw[2] = v.y << 16; raw[3] = v.y & 0xFFFF0000u;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        raw[q] = q < n ? static_cast<uint32_t>(x[q]) << 16 : 0u;
      }
    }
  } else {
    const uint8_t* e = reinterpret_cast<const uint8_t*>(p.exp_in) + at;
    const uint8_t* s = reinterpret_cast<const uint8_t*>(p.sign_in) + at;
    if (p.xvec) {
      const uint32_t e4 = *reinterpret_cast<const uint32_t*>(e);
      const uint32_t s4 = *reinterpret_cast<const uint32_t*>(s);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        raw[q] = ((e4 >> (8 * q)) & 0xFFu) | (((s4 >> (8 * q)) & 0xFFu) << 8);
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        raw[q] = q < n ? e[q] | (static_cast<uint32_t>(s[q]) << 8) : 0u;
      }
    }
  }
}

template <int IN>
__device__ __forceinline__ void decode_raw(const Params& p, float scale,
                                           uint32_t raw, int& e, int& s) {
  if constexpr (IN == kCodes) {
    e = static_cast<int8_t>(raw & 0xFFu);
    s = static_cast<int8_t>(raw >> 8);
  } else {
    const float xs = __fdiv_rn(__uint_as_float(raw), scale);
    qh::log2_code(__float_as_uint(xs), p.sentinel, p.emax, e, s);
  }
}

// The codes of rows [r0, r1) x k [kbase, kbase + 128): visit(m, kk, e, s)
// for each (k >= K gives the sentinel) and the largest code.  A thread
// takes 4 consecutive k at a time and issues BATCH such loads before it
// decodes any.
template <int IN, int BATCH, class Visit>
__device__ __forceinline__ int tile_codes(const Params& p, float scale,
                                          int r0, int r1, int kbase,
                                          Visit visit) {
  constexpr int kQuads = kTile / 4;
  const int quads = (r1 - r0) * kQuads;
  const int step = static_cast<int>(blockDim.x);
  int mx = p.sentinel;
  for (int i0 = threadIdx.x; i0 < quads; i0 += BATCH * step) {
    uint32_t raw[BATCH][4];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int i = i0 + b * step;
      const int k = kbase + (i % kQuads) * 4;
      raw[b][0] = raw[b][1] = raw[b][2] = raw[b][3] = 0u;
      if (i < quads && k < p.K) {
        load4<IN>(p, static_cast<size_t>(r0 + i / kQuads) * p.K + k,
                  p.K - k, raw[b]);
      }
    }
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int i = i0 + b * step;
      if (i >= quads) break;
      const int m = r0 + i / kQuads;
      const int kk = (i % kQuads) * 4;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        int e = p.sentinel, s = 1;
        if (kbase + kk + q < p.K) {
          decode_raw<IN>(p, scale, raw[b][q], e, s);
          mx = max(mx, e);
        }
        visit(m, kk + q, e, s);
      }
    }
  }
  return mx;
}

template <int IN>
__device__ __forceinline__ float load_scale(const Params& p) {
  if constexpr (IN == kCodes) {
    return 1.0f;
  } else {
    return *p.act_scale;
  }
}

// Largest code of the block (the sentinel is the smallest code, so this is
// the largest live exponent, or the sentinel when every code is); returns
// the tile's min_plane to every thread.
__device__ int block_min_plane(int mx, int sentinel, int* scratch) {
  mx = __reduce_max_sync(0xffffffffu, mx);
  const int warp = threadIdx.x >> 5;
  const int warps = (blockDim.x + 31) >> 5;
  if ((threadIdx.x & 31) == 0) scratch[warp] = mx;
  __syncthreads();
  mx = sentinel;
  for (int w = 0; w < warps; ++w) mx = max(mx, scratch[w]);
  __syncthreads();
  return mx <= sentinel ? kBits : min(max(-mx, 0), kBits);
}

// ---------------------------------------------------------------------------
// plane loaders: the int8 weights w_t (low min_plane planes cleared) of NK
// consecutive k from k0 and 8 columns, as w[j][h] = bytes of k = k0 + j,
// columns col0 + 4h .. col0 + 4h + 3; zero outside (K, N).  kK is the k an
// integer-body thread takes at once.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint2 load8(const uint8_t* row, int col0, int N,
                                       bool vec) {
  if (vec && col0 + kCols <= N) {
    return *reinterpret_cast<const uint2*>(row + col0);
  }
  uint32_t v[2] = {0u, 0u};
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    if (col0 + c < N) v[c >> 2] |= static_cast<uint32_t>(row[col0 + c])
                                   << (8 * (c & 3));
  }
  return make_uint2(v[0], v[1]);
}

struct PackedPlanes {
  // byte g of plane b holds bit j for k = 8g + j: one 8-byte load per
  // plane, then an 8x8 bit transpose per byte lane (4 columns per word)
  static constexpr int kK = 8;
  template <int NK>
  static __device__ __forceinline__ void load(const Params& p, int k0,
                                              int col0, int min_plane,
                                              uint32_t (&w)[NK][2]) {
    static_assert(NK == 8, "a packed byte holds 8 k");
    const int kp = p.K / 8;
    const int g = k0 / 8;
    uint32_t r[2][8];
#pragma unroll
    for (int b = 0; b < kBits; ++b) {
      uint2 v = make_uint2(0u, 0u);
      if (b >= min_plane) {      // a skipped plane is a skipped load
        v = load8(p.planes + (static_cast<size_t>(b) * kp + g) * p.N, col0,
                  p.N, p.vec);
      }
      r[0][b] = v.x;
      r[1][b] = v.y;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // rows b, columns j -> rows j, columns b, in every byte lane
#pragma unroll
      for (int s = 4; s >= 1; s >>= 1) {
        const uint32_t mask = s == 4 ? 0x0F0F0F0Fu
                              : s == 2 ? 0x33333333u : 0x55555555u;
#pragma unroll
        for (int a = 0; a < kBits; ++a) {
          if (a & s) continue;
          const uint32_t t = ((r[h][a] >> s) ^ r[h][a + s]) & mask;
          r[h][a + s] ^= t;
          r[h][a] ^= t << s;
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) w[j][h] = r[h][j];
    }
  }
};

struct UnpackedPlanes {
  // one {0,1} byte per (plane, k, n): all NK x 8 loads issued first, then
  // plane b lands on bit b of each byte.  An integer-body thread takes 4 k
  // (32 loads in flight; 64 would not fit its registers)
  static constexpr int kK = 4;
  template <int NK>
  static __device__ __forceinline__ void load(const Params& p, int k0,
                                              int col0, int min_plane,
                                              uint32_t (&w)[NK][2]) {
    uint2 v[NK][kBits];
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const int k = k0 + j;
#pragma unroll
      for (int b = 0; b < kBits; ++b) {
        v[j][b] = make_uint2(0u, 0u);
        if (k < p.K && b >= min_plane) {
          v[j][b] = load8(
              p.planes + (static_cast<size_t>(b) * p.K + k) * p.N, col0,
              p.N, p.vec);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      w[j][0] = w[j][1] = 0u;
#pragma unroll
      for (int b = 0; b < kBits; ++b) {
        w[j][0] |= v[j][b].x << b;
        w[j][1] |= v[j][b].y << b;
      }
    }
  }
};

// ---------------------------------------------------------------------------
// split K: the cluster's ranks sum their (rows x cols) int32 tiles through
// distributed shared memory; rank r stores the r-th slice
// ---------------------------------------------------------------------------

// barrier.cluster in halves, so that a block can arrive early and wait late
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ void cluster_store(int32_t* red, int ld, int rows, int cols,
                              const Params& p, int m0, int n0) {
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  cluster.sync();
  const int valid_rows = min(rows, p.M - m0);
  const int valid_cols = min(cols, p.N - n0);
  const int total = valid_rows * cols;
  const int per = (total + ranks - 1) / ranks;
  const int end = min(total, (rank + 1) * per);
  for (int i = rank * per + static_cast<int>(threadIdx.x); i < end;
       i += blockDim.x) {
    const int r = i / cols;
    const int c = i % cols;
    if (c >= valid_cols) continue;
    int sum = 0;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) {   // all ranks' loads in flight
      if (q < ranks) sum += cluster.map_shared_rank(red, q)[r * ld + c];
    }
    p.out[static_cast<size_t>(m0 + r) * p.N + n0 + c] = sum;
  }
  cluster.sync();   // no block leaves while another reads its tile
}

// ---------------------------------------------------------------------------
// decode body
// ---------------------------------------------------------------------------

// 4x4 byte transpose: out[c] = (a[c], b[c], c_[c], d[c]) bytes
__device__ __forceinline__ void byte_transpose(uint32_t a, uint32_t b,
                                               uint32_t c, uint32_t d,
                                               uint32_t (&out)[4]) {
  const uint32_t t0 = __byte_perm(a, b, 0x5140u);
  const uint32_t t1 = __byte_perm(a, b, 0x7362u);
  const uint32_t t2 = __byte_perm(c, d, 0x5140u);
  const uint32_t t3 = __byte_perm(c, d, 0x7362u);
  out[0] = __byte_perm(t0, t2, 0x5410u);
  out[1] = __byte_perm(t0, t2, 0x7632u);
  out[2] = __byte_perm(t1, t3, 0x5410u);
  out[3] = __byte_perm(t1, t3, 0x7632u);
}

// grid (col tiles x ranks, ceil(M / 16)), cluster (ranks, 1, 1), up to 2
// K tiles x 16 groups x (8 / Loader::kK) parts x 8 column groups threads:
// (8-k group slot, part, column group) with the column group fastest.
// WIDE (n_bits = 5): 3 integer operations per (row, k, n); otherwise 3 per
// (row, 4 k, n) with dp2a on the masked weight bytes.
template <int IN, class Loader, bool WIDE>
__global__ void __launch_bounds__(kDecTiles * kGroups * (8 / Loader::kK) *
                                  kDecCg)
decode_kernel(const Params p) {
  constexpr int kCg = kDecCg;
  constexpr int kN = kDecN;                     // columns per block
  constexpr int kKt = Loader::kK;               // k per thread
  constexpr int kParts = 8 / kKt;               // threads per 8-k group
  constexpr int kQ = kKt / 4;                   // 4-k quads per thread
  constexpr int kLd = kDecTiles * kTile;
  // per (row, k).  WIDE: the code and the sign bytes.  Otherwise a 16-bit
  // factor sign * 2^(exp + 7) and a byte mask clearing the weight's low
  // -exp bits, so that per k
  //   (w_t & mask) * sign * 2^(exp + 7) = 2^7 * sign * ArithShift(w_t, exp)
  // exactly (|.| <= 2^21, 8 k per thread stay below 2^24); both are 0 if
  // the code contributes nothing
  __shared__ __align__(16) uint8_t code[kDecRows * kLd * 3];
  __shared__ __align__(16) int32_t red[kDecRows][kN];
  // the other ranks' tiles, stored here by them for rank 0 to sum
  __shared__ __align__(16) int32_t others[kMaxCluster - 1][kDecRows][kN];
  __shared__ int min_plane[kDecTiles];
  __shared__ int scratch[kDecMaxThreads / 32];
  int16_t* factor = reinterpret_cast<int16_t*>(code);    // [16][kLd]
  uint8_t* mask = code + 2 * kDecRows * kLd;              // [16][kLd]
  int8_t* e8 = reinterpret_cast<int8_t*>(code);           // WIDE: [16][kLd]
  int8_t* s8 = e8 + kDecRows * kLd;

  cg::cluster_group cluster = cg::this_cluster();
  // every block arrives now and waits before its first store into rank
  // 0, so that store finds rank 0 running
  cluster_arrive_relaxed();
  const int tid = threadIdx.x;
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n0 = (blockIdx.x / ranks) * kN;
  const int m0 = blockIdx.y * kDecRows;
  const int rows = min(kDecRows, p.M - m0);
  const int r0 = (m0 / kTile) * kTile;          // the skip tile's rows
  const int r1 = min(r0 + kTile, p.M);
  const bool writer = p.exp_out != nullptr && n0 == 0;
  const float scale = load_scale<IN>(p);
  const int slots = blockDim.x / (kCg * kParts);   // 8-k groups at once
  const int slot = tid / (kCg * kParts);
  const int part = (tid / kCg) % kParts;
  const int col0 = n0 + (tid % kCg) * kCols;

  for (int i = tid; i < kDecRows * kN; i += blockDim.x) {
    (&red[0][0])[i] = 0;
  }

  const int t_begin = rank * p.tiles_per_rank;
  const int t_end = min(p.k_tiles, t_begin + p.tiles_per_rank);
  for (int t0 = t_begin; t0 < t_end; t0 += kDecTiles) {
    const int nt = min(kDecTiles, t_end - t0);
    // 1. the codes of the skip tiles' rows; this block's rows kept
    for (int ti = 0; ti < nt; ++ti) {
      const int kbase = (t0 + ti) * kTile;
      const int mx = tile_codes<IN, 4>(
          p, scale, r0, r1, kbase, [&](int m, int kk, int e, int s) {
            if (m < m0 || m >= m0 + rows) return;
            if (writer && kbase + kk < p.K) {
              const size_t at = static_cast<size_t>(m) * p.K + kbase + kk;
              p.exp_out[at] = static_cast<int8_t>(e);
              p.sign_out[at] = static_cast<int8_t>(s);
            }
            const int at = (m - m0) * kLd + ti * kTile + kk;
            if constexpr (WIDE) {
              e8[at] = static_cast<int8_t>(e);
              s8[at] = static_cast<int8_t>(s);
            } else {
              const bool live = e != p.sentinel && e > -kBits;
              factor[at] =
                  static_cast<int16_t>(live ? s * (1 << (e + 7)) : 0);
              mask[at] = static_cast<uint8_t>(0xFFu << max(-e, 0));
            }
          });
      const int mp = block_min_plane(mx, p.sentinel, scratch);
      if (tid == 0) min_plane[ti] = mp;
    }
    __syncthreads();

    // 2. this thread's k of its 8-k groups: planes >= min_plane, then per
    //    row sign * ArithShift(w_t, exp) into 8 int32 sums; a warp holds
    //    whole groups of one K tile (so min_plane is warp-uniform) and sums
    //    them by shuffles before 8 lanes add into the block's tile
    for (int lg = slot; lg < nt * kGroups; lg += slots) {
      const int ti = lg / kGroups;
      const int g = (t0 + ti) * kGroups + lg % kGroups;
      const int mp = min_plane[ti];
      if (mp >= kBits) continue;
      const int k0 = 8 * g + part * kKt;
      uint32_t w[kKt][2];
      if (k0 < p.K && col0 < p.N) {
        Loader::template load<kKt>(p, k0, col0, mp, w);
      } else {
#pragma unroll
        for (int j = 0; j < kKt; ++j) w[j][0] = w[j][1] = 0u;
      }
      // v[c][q]: the bytes of k = k0 + 4q .. k0 + 4q + 3 of column c
      uint32_t v[kCols][kQ];
      if constexpr (!WIDE) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int q = 0; q < kQ; ++q) {
            uint32_t t[4];
            byte_transpose(w[4 * q][h], w[4 * q + 1][h], w[4 * q + 2][h],
                           w[4 * q + 3][h], t);
#pragma unroll
            for (int c = 0; c < 4; ++c) v[4 * h + c][q] = t[c];
          }
        }
      }
      const int at = ti * kTile + (lg % kGroups) * 8 + part * kKt;
      for (int m = 0; m < rows; ++m) {
        int acc[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[c] = 0;
        if constexpr (WIDE) {
          uint32_t ew[kQ], sw[kQ];
#pragma unroll
          for (int q = 0; q < kQ; ++q) {
            ew[q] = *reinterpret_cast<const uint32_t*>(
                &e8[m * kLd + at + 4 * q]);
            sw[q] = *reinterpret_cast<const uint32_t*>(
                &s8[m * kLd + at + 4 * q]);
          }
#pragma unroll
          for (int j = 0; j < kKt; ++j) {
            const uint32_t ewj = ew[j / 4];
            const uint32_t swj = sw[j / 4];
            const int e = static_cast<int8_t>(ewj >> (8 * (j & 3)));
            const int sg = static_cast<int8_t>(swj >> (8 * (j & 3)));
            const bool live = e != p.sentinel && e > -kBits;
            const int rs = max(-e, 0);
            const int mult = live ? sg * (1 << max(e, 0)) : 0;
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
              const unsigned sel = (c & 3) * 0x1111u + 0x8880u;
              const int b = static_cast<int>(
                  prmt(w[j][c >> 2], 0u, sel));   // the signed byte c
              acc[c] += (b >> min(rs, 7)) * mult;
            }
          }
        } else {
          uint32_t f[2 * kQ], mk[kQ];
#pragma unroll
          for (int q = 0; q < kQ; ++q) {
            const uint2 fq = *reinterpret_cast<const uint2*>(
                &factor[m * kLd + at + 4 * q]);
            f[2 * q] = fq.x;
            f[2 * q + 1] = fq.y;
            mk[q] = *reinterpret_cast<const uint32_t*>(
                &mask[m * kLd + at + 4 * q]);
          }
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
#pragma unroll
            for (int q = 0; q < kQ; ++q) {
              const int b4 = static_cast<int>(v[c][q] & mk[q]);
              acc[c] = __dp2a_lo(static_cast<int>(f[2 * q]), b4, acc[c]);
              acc[c] = __dp2a_hi(static_cast<int>(f[2 * q + 1]), b4,
                                 acc[c]);
            }
            acc[c] >>= 7;                          // exact: 2^7 | acc
          }
        }
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
#pragma unroll
          for (int off = kCg; off < 32; off <<= 1) {
            acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
          }
        }
        if ((tid & 31) < kCg) {
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            atomicAdd(&red[m][col0 - n0 + c], acc[c]);
          }
        }
      }
    }
    __syncthreads();
  }

  // 3. split K: every rank but 0 stores its tile into rank 0's
  //    shared memory; one cluster barrier; rank 0 sums and stores
  cluster_wait();
  if (rank > 0) {
    int4* dst = reinterpret_cast<int4*>(
        cluster.map_shared_rank(&others[rank - 1][0][0], 0));
    const int4* src = reinterpret_cast<const int4*>(&red[0][0]);
    for (int i = tid; i < rows * kN / 4; i += blockDim.x) dst[i] = src[i];
  }
  cluster_arrive_release();
  cluster_wait();
  if (rank == 0) {
    const int cols = min(kN, p.N - n0);
    for (int i = tid; i < rows * kN; i += blockDim.x) {
      const int r = i / kN;
      const int c = i % kN;
      if (c >= cols) continue;
      int sum = red[r][c];
#pragma unroll
      for (int q = 0; q < kMaxCluster - 1; ++q) {
        if (q < ranks - 1) sum += others[q][r][c];
      }
      p.out[static_cast<size_t>(m0 + r) * p.N + n0 + c] = sum;
    }
  }
}

// ---------------------------------------------------------------------------
// tensor-core body
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// grid (col tiles x ranks, ceil(M / 128)), cluster (ranks, 1, 1), 256
// threads; warp (wm, wn) owns rows 32 wm .. +31 and columns 32 wn .. +31,
// its n8 block j holding the columns 32 wn + 4 i + j, i = 0..7
template <int IN, class Loader>
__global__ void __launch_bounds__(kTcThreads, 2)
tc_kernel(const Params p) {
  // per (row, k) of the K tile: the bf16 bits of sign * 2^exp (0 if the
  // code contributes nothing) with the lowest plane it reaches,
  // max(-exp, 0) (8 if none), in the zero mantissa bits; after the last
  // tile the same bytes hold the block's int32 output tile
  __shared__ __align__(16) uint16_t code[kTcRows * kCodeLd];
  __shared__ __align__(16) uint8_t wt[kTile * kWtLd];
  __shared__ int scratch[kTcThreads / 32];
  static_assert(sizeof(code) >= sizeof(int32_t) * kTcRows * kRedLd,
                "the output tile must fit the code tile");

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int wm = warp >> 1;
  const int wn = warp & 1;
  const int ranks = static_cast<int>(cg::this_cluster().num_blocks());
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int n0 = (blockIdx.x / ranks) * kTcN;
  const int m0 = blockIdx.y * kTcRows;
  const bool writer = p.exp_out != nullptr && n0 == 0;
  const float scale = load_scale<IN>(p);

  int total[kTcMi][4][4];
  float acc[kTcMi][4][4];
#pragma unroll
  for (int mi = 0; mi < kTcMi; ++mi) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        total[mi][j][r] = 0;
        acc[mi][j][r] = 0.0f;
      }
    }
  }

  const int t_begin = rank * p.tiles_per_rank;
  const int t_end = min(p.k_tiles, t_begin + p.tiles_per_rank);
  for (int t = t_begin; t < t_end; ++t) {
    const int kbase = t * kTile;
    // 1. the codes of the (128-row, K tile) skip tile; rows past M are
    //    the sentinel
    const int r1 = min(m0 + kTcRows, p.M);
    const int mx = tile_codes<IN, 8>(
        p, scale, m0, r1, kbase, [&](int m, int kk, int e, int s) {
          uint32_t c = kBits;
          if (e != p.sentinel && e > -kBits) {
            c = (s < 0 ? 0x8000u : 0u) |
                (static_cast<uint32_t>(127 + e) << 7) |
                static_cast<uint32_t>(max(-e, 0));
          }
          if (writer && kbase + kk < p.K) {
            const size_t at = static_cast<size_t>(m) * p.K + kbase + kk;
            p.exp_out[at] = static_cast<int8_t>(e);
            p.sign_out[at] = static_cast<int8_t>(s);
          }
          code[(m - m0) * kCodeLd + kk] = static_cast<uint16_t>(c);
        });
    for (int i = (r1 - m0) * kTile + tid; i < kTcRows * kTile;
         i += kTcThreads) {
      code[(i / kTile) * kCodeLd + i % kTile] = kBits;
    }
    const int mp = block_min_plane(mx, p.sentinel, scratch);

    // 2. the w_t tile: thread = (8-k group, 8 columns), the decode loader
    if (mp < kBits && tid < kGroups * kTcN / kCols) {
      const int lg = tid / (kTcN / kCols);
      const int cl = (tid % (kTcN / kCols)) * kCols;
      uint32_t w[8][2];
      const int g = t * kGroups + lg;
      if (8 * g < p.K && n0 + cl < p.N) {
        Loader::template load<8>(p, 8 * g, n0 + cl, mp, w);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) w[j][0] = w[j][1] = 0u;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<uint2*>(&wt[(8 * lg + j) * kWtLd + cl]) =
            make_uint2(w[j][0], w[j][1]);
      }
    }
    __syncthreads();

    // 3. per 16-deep k step: A' and thresholds once, then each live plane
    if (mp < kBits) {
#pragma unroll 1
      for (int ks = 0; ks < kTile; ks += 16) {
        uint32_t av[kTcMi][4], th[kTcMi][4];
#pragma unroll
        for (int mi = 0; mi < kTcMi; ++mi) {
          const int row = wm * 32 + mi * 16 + gid;
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int rr = row + (r & 1) * 8;
            const int kk = ks + 2 * tig + (r >> 1) * 8;
            const uint32_t v = *reinterpret_cast<const uint32_t*>(
                &code[rr * kCodeLd + kk]);
            av[mi][r] = v & 0xFF80FF80u;
            th[mi][r] = v & 0x007F007Fu;
          }
        }
        uint32_t pb[4][2];   // (k, k+1) bytes of column 4 gid + j
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kk = ks + 2 * tig + 8 * h;
          const int col = wn * 32 + 4 * gid;
          const uint32_t lo =
              *reinterpret_cast<const uint32_t*>(&wt[kk * kWtLd + col]);
          const uint32_t hi =
              *reinterpret_cast<const uint32_t*>(&wt[(kk + 1) * kWtLd + col]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            pb[j][h] = __byte_perm(lo, hi, j * 0x11u + (4 + j) * 0x1100u);
          }
        }
#pragma unroll
        for (int b = 0; b < kBits; ++b) {
          if (b < mp) continue;
          // sgn_b 2^b in bf16; the dead test adds 0x7F - b to the
          // threshold byte: bit 7 is set iff the threshold exceeds b
          const uint32_t cb = b == kBits - 1 ? 0xC300u : 0x3F80u + (b << 7);
          const uint32_t dead_add = 0x007F007Fu - b * 0x00010001u;
          uint32_t bf[4][2];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              bf[j][h] = ((pb[j][h] >> b) & 0x00010001u) * cb;
            }
          }
#pragma unroll
          for (int mi = 0; mi < kTcMi; ++mi) {
            uint32_t a[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const uint32_t dead =
                  prmt(th[mi][r] + dead_add, 0u, 0xAA88u);
              a[r] = av[mi][r] & ~dead;
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_bf16(acc[mi][j], a, bf[j][0],
                                                bf[j][1]);
          }
        }
      }
      // 4. flush the exact f32 sums of this 128-deep tile to int32
#pragma unroll
      for (int mi = 0; mi < kTcMi; ++mi) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            total[mi][j][r] += __float2int_rn(acc[mi][j][r]);
            acc[mi][j][r] = 0.0f;
          }
        }
      }
    }
    __syncthreads();   // the next tile overwrites code and wt
  }

  // the block's int32 tile, columns in memory order, over the code bytes
  int32_t* red = reinterpret_cast<int32_t*>(code);
#pragma unroll
  for (int mi = 0; mi < kTcMi; ++mi) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = wm * 32 + mi * 16 + gid + (r >> 1) * 8;
        const int col = wn * 32 + 4 * (2 * tig + (r & 1)) + j;
        red[row * kRedLd + col] = total[mi][j][r];
      }
    }
  }
  cluster_store(red, kRedLd, kTcRows, kTcN, p, m0, n0);
}

// no work: what a launch of the same grid, block and cluster shape costs
__global__ void empty_kernel(Params) {}

template <class Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, int ranks,
                   cudaStream_t stream, const Params& p, bool empty) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return empty ? cudaLaunchKernelEx(&cfg, empty_kernel, p)
               : cudaLaunchKernelEx(&cfg, kernel, p);
}

template <int IN, class Loader, bool WIDE>
cudaError_t launch_decode(const Params& p, int ranks, cudaStream_t stream,
                          bool empty) {
  const dim3 grid(((p.N + kDecN - 1) / kDecN) * ranks,
                  (p.M + kDecRows - 1) / kDecRows);
  const int threads = min(p.tiles_per_rank, kDecTiles) * kGroups *
                      (8 / Loader::kK) * kDecCg;
  return launch(decode_kernel<IN, Loader, WIDE>, grid, threads, ranks,
                stream, p, empty);
}

template <int IN>
cudaError_t dispatch(const Params& p, bool packed, bool tensor_cores,
                     int ranks, cudaStream_t stream, bool empty = false) {
  if (tensor_cores) {
    const dim3 grid(((p.N + kTcN - 1) / kTcN) * ranks,
                    (p.M + kTcRows - 1) / kTcRows);
    return packed ? launch(tc_kernel<IN, PackedPlanes>, grid, kTcThreads,
                           ranks, stream, p, empty)
                  : launch(tc_kernel<IN, UnpackedPlanes>, grid, kTcThreads,
                           ranks, stream, p, empty);
  }
  if (p.emax > 7) {   // n_bits = 5
    return packed
        ? launch_decode<IN, PackedPlanes, true>(p, ranks, stream, empty)
        : launch_decode<IN, UnpackedPlanes, true>(p, ranks, stream, empty);
  }
  return packed
      ? launch_decode<IN, PackedPlanes, false>(p, ranks, stream, empty)
      : launch_decode<IN, UnpackedPlanes, false>(p, ranks, stream, empty);
}

// the shape fields of Params and the cluster size along K
int shape(Params* p, int M, int K, int N, int n_bits) {
  p->M = M;
  p->K = K;
  p->N = N;
  p->sentinel = -(1 << (n_bits - 1));
  p->emax = (1 << (n_bits - 1)) - 1;
  // ranks: whole K tiles each, at most 8 (a portable cluster)
  p->k_tiles = K > 0 ? (K + kTile - 1) / kTile : 1;
  p->tiles_per_rank = (p->k_tiles + kMaxCluster - 1) / kMaxCluster;
  return (p->k_tiles + p->tiles_per_rank - 1) / p->tiles_per_rank;
}

}  // namespace

// One launch: y = the bit-plane GEMM of the LOG2 codes of x / act_scale.
//   input 0 (f32) or 1 (bf16): x (M, K) and act_scale (a device f32
//     scalar, read in the kernel); input 2: exp_in, sign_in (M, K) int8;
//   planes: uint8 (8, K, N) {0,1} (packed = 0) or (8, K / 8, N) packed
//     along K (packed = 1, K % 8 == 0);
//   out: (M, N) int32; exp_out, sign_out: (M, K) int8 or null;
//   n_bits 2..5; tensor_cores = 1 takes the mma.sync body (n_bits <= 4).
// All contiguous.  Returns cudaGetLastError() after the launch (or the
// launch's own error).
extern "C" int qh_bitplane_matmul(const void* x, int input,
                                  const void* act_scale, const void* exp_in,
                                  const void* sign_in, const void* planes,
                                  int packed, void* out, void* exp_out,
                                  void* sign_out, int M, int K, int N,
                                  int n_bits, int tensor_cores,
                                  void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (n_bits < 2 || n_bits > 5 || (tensor_cores && n_bits > 4) ||
      (packed && K % 8 != 0) || input < 0 || input > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.x = x;
  p.act_scale = static_cast<const float*>(act_scale);
  p.exp_in = static_cast<const int8_t*>(exp_in);
  p.sign_in = static_cast<const int8_t*>(sign_in);
  p.planes = static_cast<const uint8_t*>(planes);
  p.out = static_cast<int32_t*>(out);
  p.exp_out = static_cast<int8_t*>(exp_out);
  p.sign_out = static_cast<int8_t*>(sign_out);
  const int ranks = shape(&p, M, K, N, n_bits);
  p.vec = N % kCols == 0 &&
          reinterpret_cast<uintptr_t>(planes) % kCols == 0;
  // 4-wide input loads: 16 bytes of f32, 8 of bf16, 4 of each code
  const uintptr_t xin =
      input == kCodes ? (reinterpret_cast<uintptr_t>(exp_in) |
                         reinterpret_cast<uintptr_t>(sign_in))
                      : reinterpret_cast<uintptr_t>(x);
  const int xalign = input == kF32 ? 16 : input == kBF16 ? 8 : 4;
  p.xvec = K % 4 == 0 && xin % xalign == 0;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (input == kF32) {
    err = dispatch<kF32>(p, packed != 0, tensor_cores != 0, ranks, st);
  } else if (input == kBF16) {
    err = dispatch<kBF16>(p, packed != 0, tensor_cores != 0, ranks, st);
  } else {
    err = dispatch<kCodes>(p, packed != 0, tensor_cores != 0, ranks, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The launch floor of the call qh_bitplane_matmul(..., M, K, N, n_bits,
// tensor_cores, stream) on planes of this layout: an empty kernel launched
// with that call's grid, block and cluster shape.
extern "C" int qh_bitplane_matmul_launch_floor(int M, int K, int N,
                                               int n_bits, int packed,
                                               int tensor_cores,
                                               void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (n_bits < 2 || n_bits > 5 || (tensor_cores && n_bits > 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p = {};
  const int ranks = shape(&p, M, K, N, n_bits);
  const cudaError_t err =
      dispatch<kCodes>(p, packed != 0, tensor_cores != 0, ranks,
                       static_cast<cudaStream_t>(stream), true);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* qh_bitplane_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
