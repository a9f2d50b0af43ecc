// The split-KV paged-attention page walk shared by the dense kernel
// (paged_attention.cu, K3) and the log2-quantized one
// (paged_attention_quant.cu, K4), for Hopper, sm_90a.
//
// One block per (split, kv-head g, slot b), the grid (splits, G, B), so a
// block owns one split and writes that split's unnormalised (o, m, l)
// partials; ops.py::merge_split_softmax merges the splits.  Per query row
// r of the head's R rows, over the split's pages of the page table:
//   s = (q . k) / sqrt(D), masked to pos < length (NEG_INF = -1e30)
//   m' = max(m, max s);  p = pos < length ? exp(s - m') : 0 (exactly)
//   l = l * exp(m - m') + sum p;  acc = acc * exp(m - m') + round(p) . v
// with m, l, acc in f32 and round() the loader's (K3: p rounded to the V
// dtype; K4: p kept in f32).
//
// The walk inside a block.  The block's W warps take the split's pages in
// parallel: warp w takes pages j0 + w, j0 + w + W, ..., so which warp
// takes a page depends only on j - j0, and a split's result does not
// depend on how many splits there are.  Each warp runs its own online
// softmax with its rows' m, l and acc in registers and no block barrier:
//   * a page (or a staged chunk of at most 32 of its rows, when the page
//     is longer or shared memory is short) is copied into the warp's own
//     double buffer in shared memory with cp.async, 16 bytes a copy where
//     D x the element size is a multiple of 16 (8 or 4 where only those
//     divide it; element copies otherwise), and the NEXT chunk's copies
//     are in flight while the current chunk's math runs;
//   * scores: lane (part, t) = (lane / tcp, lane % tcp) dots row t with
//     the query rows (from shared memory, f32) over its part of the dims,
//     16 bytes of K per shared-memory read where rows allow it; a shuffle
//     tree sums the parts;
//   * the chunk max, exp and the row sum are shuffle trees across lanes,
//     for a compile-time tile of query rows at once (1, 2, 4 or 8);
//   * PV: lane owns output dims d0 + lane + 32k and walks the chunk's
//     valid rows, p broadcast from the lane that holds it.
// Rows past a row's length are not loaded, pages wholly past it are not
// visited, masked p is exactly 0 and the PV loop stops at the last valid
// row, so trash pages, garbage codes and dead rows never reach a live row.
// A warp (or a split) that sees no valid token keeps m = NEG_INF, l = 0,
// acc = 0.  At the end the W warp states are merged in shared memory in
// warp order with merge_split_softmax's formula (weights exp(m_w - M)):
// deterministic, and the same kind of reassociation as the split merge.
//
// Query rows beyond the row tile (8) and output dims beyond kDimSlice run
// as further passes of the whole walk (the scores always span all of D),
// so any R and D the wrappers accept work; smollm-135m (R = 3, D = 64) and
// every config in the repo (D <= 128, R <= 8) take one pass.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace paged_walk {

constexpr float kNegInf = -1e30f;
constexpr int kMaxWarps = 16;
constexpr int kRowTile = 8;           // most query rows per pass
constexpr int kDimSlots = 4;          // output dims per lane per row
constexpr int kDimSlice = 32 * kDimSlots;
constexpr int kMaxChunkRows = 32;     // page rows per staged chunk
constexpr size_t kSmemBudget = 227 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Per-launch geometry, uniform across the grid.
struct Geometry {
  int G, R, D, page_len, nb, splits, n_pages;
  int tc;        // page rows per staged chunk (<= 32)
  int tcp;       // tc rounded up to a power of two: lanes per part
  int rs;        // shared-memory row stride of a staged chunk, bytes
  int gran;      // bytes per cp.async (16, 8, 4), 0 for element copies
  int rows;      // min(R, the row tile): query rows of the merge area
  int dsl;       // min(D, kDimSlice): dims of the merge area
};

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// nv rows of one pool's page (row stride G * D elements in global memory)
// into a staged buffer (row stride rs bytes), by the warp's 32 lanes.
template <typename Raw>
__device__ __forceinline__ void stage_rows(unsigned char* dst,
                                           const Raw* src, int nv,
                                           const Geometry& geo, int lane) {
  const int row_bytes = geo.D * static_cast<int>(sizeof(Raw));
  const size_t src_stride = static_cast<size_t>(geo.G) * geo.D;
  if (geo.gran) {
    const int per_row = row_bytes / geo.gran;
    for (int i = lane; i < nv * per_row; i += 32) {
      const int t = i / per_row;
      const int c = i - t * per_row;
      cp_async(dst + t * geo.rs + c * geo.gran,
               reinterpret_cast<const unsigned char*>(src + t * src_stride)
                   + c * geo.gran,
               geo.gran);
    }
  } else {
    for (int i = lane; i < nv * geo.D; i += 32) {
      const int t = i / geo.D;
      const int d = i - t * geo.D;
      reinterpret_cast<Raw*>(dst + t * geo.rs)[d] = src[t * src_stride + d];
    }
  }
}

// The walk of one block.  L is the page loader: L::Raw the pool element
// type; L::scales(page, g, G) the page's (k, v) scale pair (int2, unused
// by the dense loader); L::k_at / L::v_at one element widened to f32 under
// its scale; L::round_p the p that enters PV.  L::k and L::v point at the
// two pools.  RT query rows are walked together (a compile-time tile, so
// the per-row shuffle trees of a chunk run interleaved).
template <typename Q, class L, int RT>
__global__ void __launch_bounds__(kMaxWarps * 32)
paged_walk_kernel(const Q* __restrict__ q, const L ld,
                  const int* __restrict__ table,
                  const int* __restrict__ lengths, float* __restrict__ o,
                  float* __restrict__ m_out, float* __restrict__ l_out,
                  const Geometry geo) {
  using Raw = typename L::Raw;
  constexpr int E = 16 / static_cast<int>(sizeof(Raw));  // per 16 bytes
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int n_warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int G = geo.G, R = geo.R, D = geo.D, T = geo.page_len;
  const int tc = geo.tc, tcp = geo.tcp, rs = geo.rs;
  const int r_pad = (R + RT - 1) / RT * RT;

  // shared memory: each warp's two stages of (K, V) chunks, then q as f32
  // (R rounded up to the row tile, zero past R), then the merge area (per
  // warp: rows x (m, l, dsl dims))
  const int stage_bytes = tc * rs;
  unsigned char* mine = smem + static_cast<size_t>(warp) * 4 * stage_bytes;
  float* qs = reinterpret_cast<float*>(
      smem + static_cast<size_t>(n_warps) * 4 * stage_bytes);
  float* merge = qs + r_pad * D;
  const int mrow = geo.dsl + 2;

  // the warp's pages of this split, 32 at a time: lane i holds the page id
  // (and, for the quantized pool, the scales) of the warp's page i
  const int bps = geo.nb / geo.splits;
  const int j0 = split * bps;
  const int* trow = table + static_cast<size_t>(b) * geo.nb;
  const int len = lengths[b];
  const int live_pages = len > 0 ? (len + T - 1) / T : 0;
  const int j1 = min(j0 + bps, live_pages);
  const int n_mine = j1 > j0 + warp ? (j1 - j0 - warp + n_warps - 1) / n_warps
                                    : 0;

  const Q* qb = q + static_cast<size_t>(b * G + g) * R * D;
  for (int i = threadIdx.x; i < r_pad * D; i += blockDim.x) {
    qs[i] = i < R * D ? to_f32(qb[i]) : 0.f;
  }
  const float scale = sqrtf(static_cast<float>(D));
  // the score loop reads K 16 bytes at a time where rows allow it
  const int row_bytes = D * static_cast<int>(sizeof(Raw));
  const int nvec = row_bytes % 16 == 0 ? row_bytes / 16 : 0;
  __syncthreads();

  for (int r0 = 0; r0 < R; r0 += RT) {
    const int rt = min(RT, R - r0);
    const float* qt = qs + r0 * D;
    for (int d0 = 0; d0 < D; d0 += kDimSlice) {
      const int ds = min(kDimSlice, D - d0);
      const int nk = (ds + 31) / 32;
      float m[RT], l[RT], acc[RT][kDimSlots];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        m[r] = kNegInf;
        l[r] = 0.f;
#pragma unroll
        for (int k = 0; k < kDimSlots; ++k) acc[r][k] = 0.f;
      }

      int batch_page = 0;
      int2 batch_sc = make_int2(0, 0);
      int2 cur_sc = make_int2(0, 0), nxt_sc = make_int2(0, 0);
      // chunk c of the warp's page i: its first page row and valid rows
      auto chunk = [&](int i, int c, int& j, int& row0, int& nv) {
        j = j0 + warp + n_warps * i;
        row0 = c * tc;
        nv = min(min(tc, T - row0), len - (j * T + row0));
      };
      auto next = [&](int& i, int& c) {
        const int j = j0 + warp + n_warps * i;
        if ((c + 1) * tc < min(T, len - j * T)) {
          ++c;
        } else {
          ++i;
          c = 0;
        }
      };
      auto issue = [&](int i, int c, int stage) {
        if ((i & 31) == 0 && c == 0) {
          const int jl = j0 + warp + n_warps * (i + lane);
          int page = jl < j1 ? trow[jl] : 0;
          page = min(max(page, 0), geo.n_pages - 1);
          batch_page = page;
          batch_sc = ld.scales(page, g, G);
        }
        int j, row0, nv;
        chunk(i, c, j, row0, nv);
        const int page = __shfl_sync(0xffffffffu, batch_page, i & 31);
        const size_t off = (static_cast<size_t>(page) * T + row0) * G * D
                           + static_cast<size_t>(g) * D;
        unsigned char* buf = mine + stage * 2 * stage_bytes;
        stage_rows<Raw>(buf, ld.k + off, nv, geo, lane);
        stage_rows<Raw>(buf + stage_bytes, ld.v + off, nv, geo, lane);
        nxt_sc.x = __shfl_sync(0xffffffffu, batch_sc.x, i & 31);
        nxt_sc.y = __shfl_sync(0xffffffffu, batch_sc.y, i & 31);
      };

      const int t = lane & (tcp - 1);
      const int part = lane / tcp;
      const int lpr = 32 / tcp;
      int i = 0, c = 0, stage = 0;
      if (n_mine > 0) issue(0, 0, 0);
      cp_async_commit();
      cur_sc = nxt_sc;
      while (i < n_mine) {
        int ni = i, nc = c;
        next(ni, nc);
        if (ni < n_mine) issue(ni, nc, stage ^ 1);
        cp_async_commit();
        cp_async_wait<1>();
        __syncwarp();

        int j, row0, nv;
        chunk(i, c, j, row0, nv);
        const unsigned char* kbuf = mine + stage * 2 * stage_bytes;
        const unsigned char* vbuf = kbuf + stage_bytes;
        const bool valid = t < nv;

        // scores of row t: this part's share of the dims (16-byte groups,
        // or single elements where a row is not a multiple of 16 bytes)
        float s[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) s[r] = 0.f;
        if (valid) {
          const unsigned char* kr = kbuf + t * rs;
          if (nvec) {
#pragma unroll 2
            for (int v16 = part; v16 < nvec; v16 += lpr) {
              const uint4 raw = *reinterpret_cast<const uint4*>(kr + 16 * v16);
              Raw kv[E];
              memcpy(kv, &raw, 16);
#pragma unroll
              for (int e = 0; e < E; e += 4) {
                float kf[4];
#pragma unroll
                for (int x = 0; x < 4; ++x) kf[x] = ld.k_at(kv[e + x], cur_sc);
#pragma unroll
                for (int r = 0; r < RT; ++r) {
                  const float4 qv = *reinterpret_cast<const float4*>(
                      qt + r * D + v16 * E + e);
                  s[r] = fmaf(qv.x, kf[0], s[r]);
                  s[r] = fmaf(qv.y, kf[1], s[r]);
                  s[r] = fmaf(qv.z, kf[2], s[r]);
                  s[r] = fmaf(qv.w, kf[3], s[r]);
                }
              }
            }
          } else {
            const Raw* kx = reinterpret_cast<const Raw*>(kr);
            for (int d = part; d < D; d += lpr) {
              const float kf = ld.k_at(kx[d], cur_sc);
#pragma unroll
              for (int r = 0; r < RT; ++r) s[r] = fmaf(qt[r * D + d], kf, s[r]);
            }
          }
        }

        // the parts' partial dots summed, then the chunk's max, exp and
        // row sum, by shuffle trees (all RT rows interleaved)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          if (off >= tcp) {
#pragma unroll
            for (int r = 0; r < RT; ++r) {
              s[r] += __shfl_xor_sync(0xffffffffu, s[r], off);
            }
          }
        }
        float mx[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          s[r] = valid ? s[r] / scale : kNegInf;
          mx[r] = s[r];
        }
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          if (off < tcp) {
#pragma unroll
            for (int r = 0; r < RT; ++r) {
              mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
            }
          }
        }
        float pr[RT], sum[RT], corr[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float m_new = fmaxf(m[r], mx[r]);
          const float p = valid ? expf(s[r] - m_new) : 0.f;
          sum[r] = p;
          pr[r] = ld.round_p(p);
          corr[r] = expf(m[r] - m_new);
          m[r] = m_new;
        }
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          if (off < tcp) {
#pragma unroll
            for (int r = 0; r < RT; ++r) {
              sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], off);
            }
          }
        }

        // PV over the chunk's valid rows; lane owns dims d0 + lane + 32k
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          l[r] = l[r] * corr[r] + sum[r];
#pragma unroll
          for (int k = 0; k < kDimSlots; ++k) acc[r][k] *= corr[r];
        }
        const Raw* vcol = reinterpret_cast<const Raw*>(vbuf) + d0 + lane;
        const int vstride = rs / static_cast<int>(sizeof(Raw));
#pragma unroll 4
        for (int tt = 0; tt < nv; ++tt) {
          const Raw* vr = vcol + tt * vstride;
          float vv[kDimSlots];
#pragma unroll
          for (int k = 0; k < kDimSlots; ++k) {
            vv[k] = (k < nk && lane + 32 * k < ds) ? ld.v_at(vr[32 * k],
                                                               cur_sc)
                                                   : 0.f;
          }
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            const float p = __shfl_sync(0xffffffffu, pr[r], tt);
#pragma unroll
            for (int k = 0; k < kDimSlots; ++k) {
              if (k < nk) acc[r][k] = fmaf(p, vv[k], acc[r][k]);
            }
          }
        }
        __syncwarp();
        i = ni;
        c = nc;
        stage ^= 1;
        cur_sc = nxt_sc;
      }
      cp_async_wait<0>();

      // merge the warps' states in warp order
      float* mw = merge + static_cast<size_t>(warp) * geo.rows * mrow;
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        if (r < rt) {
          if (lane == 0) {
            mw[r * mrow] = m[r];
            mw[r * mrow + 1] = l[r];
          }
#pragma unroll
          for (int k = 0; k < kDimSlots; ++k) {
            const int d = lane + 32 * k;
            if (k < nk && d < ds) mw[r * mrow + 2 + d] = acc[r][k];
          }
        }
      }
      __syncthreads();
      const size_t cell = (static_cast<size_t>(b * G + g) * geo.splits
                           + split) * R + r0;
      for (int x = threadIdx.x; x < rt * ds; x += blockDim.x) {
        const int r = x / ds;
        const int d = x - r * ds;
        float mx_all = kNegInf;
        for (int w = 0; w < n_warps; ++w) {
          mx_all = fmaxf(mx_all, merge[(static_cast<size_t>(w) * geo.rows
                                        + r) * mrow]);
        }
        float num = 0.f;
        for (int w = 0; w < n_warps; ++w) {
          const float* sw = merge + (static_cast<size_t>(w) * geo.rows + r)
                                        * mrow;
          num += sw[2 + d] * expf(sw[0] - mx_all);
        }
        o[(cell + r) * D + d0 + d] = num;
      }
      if (d0 == 0) {
        for (int r = threadIdx.x; r < rt; r += blockDim.x) {
          float mx_all = kNegInf;
          for (int w = 0; w < n_warps; ++w) {
            mx_all = fmaxf(mx_all, merge[(static_cast<size_t>(w) * geo.rows
                                          + r) * mrow]);
          }
          float total = 0.f;
          for (int w = 0; w < n_warps; ++w) {
            const float* sw = merge + (static_cast<size_t>(w) * geo.rows + r)
                                          * mrow;
            total += sw[1] * expf(sw[0] - mx_all);
          }
          m_out[cell + r] = mx_all;
          l_out[cell + r] = total;
        }
      }
      __syncthreads();
    }
  }
}

// Chooses the chunk rows, the warps and the copy width for a launch and
// launches with the row tile RT; returns the CUDA error of the launch.
// Shared memory is W x 4 staged chunks (K and V, two stages) + q (R rounded
// up to RT rows) as f32 + the merge area; the chunk rows, then the warps,
// are halved until it fits.
template <typename Q, class L, int RT>
cudaError_t launch_tile(const Q* q, const L& ld, const int* table,
                        const int* lengths, float* o, float* m, float* l,
                        int B, int G, int R, int D, int page_len, int nb,
                        int splits, int n_pages, cudaStream_t stream) {
  using Raw = typename L::Raw;
  Geometry geo{};
  geo.G = G;
  geo.R = R;
  geo.D = D;
  geo.page_len = page_len;
  geo.nb = nb;
  geo.splits = splits;
  geo.n_pages = n_pages;
  geo.rows = R < RT ? R : RT;
  geo.dsl = D < kDimSlice ? D : kDimSlice;
  const int row_bytes = D * static_cast<int>(sizeof(Raw));
  geo.rs = (row_bytes + 15) / 16 * 16;
  if ((geo.rs / 16) % 2 == 0) geo.rs += 16;   // rows on distinct banks
  const uintptr_t kp = reinterpret_cast<uintptr_t>(ld.k);
  const uintptr_t vp = reinterpret_cast<uintptr_t>(ld.v);
  geo.gran = 0;
  for (int gb = 16; gb >= 4; gb >>= 1) {
    if (row_bytes % gb == 0 && kp % gb == 0 && vp % gb == 0) {
      geo.gran = gb;
      break;
    }
  }
  const size_t r_pad = (static_cast<size_t>(R) + RT - 1) / RT * RT;
  int tc = page_len < kMaxChunkRows ? page_len : kMaxChunkRows;
  if (tc < 1) tc = 1;
  int warps = kMaxWarps;
  auto smem_for = [&](int rows, int w) {
    return static_cast<size_t>(w) * 4 * rows * geo.rs
           + sizeof(float) * (r_pad * D + static_cast<size_t>(w) * geo.rows
                                              * (geo.dsl + 2));
  };
  while (smem_for(tc, warps) > kSmemBudget && (tc > 1 || warps > 1)) {
    if (tc > 1) {
      tc = (tc + 1) / 2;
    } else {
      warps /= 2;
    }
  }
  geo.tc = tc;
  geo.tcp = 1;
  while (geo.tcp < tc) geo.tcp <<= 1;
  const size_t smem = smem_for(tc, warps);
  if (smem > 48 * 1024) {
    static size_t configured = 48 * 1024;
    if (smem > configured) {
      const cudaError_t rc = cudaFuncSetAttribute(
          paged_walk_kernel<Q, L, RT>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (rc != cudaSuccess) return rc;
      configured = smem;
    }
  }
  const dim3 grid(splits, G, B);
  paged_walk_kernel<Q, L, RT><<<grid, warps * 32, smem, stream>>>(
      q, ld, table, lengths, o, m, l, geo);
  return cudaGetLastError();
}

// The walk for any R: the row tile is the smallest of 1, 2, 4, 8 that
// holds R (8 for larger R, walked in tiles of 8).
template <typename Q, class L>
cudaError_t launch_walk(const Q* q, const L& ld, const int* table,
                        const int* lengths, float* o, float* m, float* l,
                        int B, int G, int R, int D, int page_len, int nb,
                        int splits, int n_pages, cudaStream_t stream) {
  if (R <= 1) {
    return launch_tile<Q, L, 1>(q, ld, table, lengths, o, m, l, B, G, R, D,
                                page_len, nb, splits, n_pages, stream);
  }
  if (R <= 2) {
    return launch_tile<Q, L, 2>(q, ld, table, lengths, o, m, l, B, G, R, D,
                                page_len, nb, splits, n_pages, stream);
  }
  if (R <= 4) {
    return launch_tile<Q, L, 4>(q, ld, table, lengths, o, m, l, B, G, R, D,
                                page_len, nb, splits, n_pages, stream);
  }
  return launch_tile<Q, L, kRowTile>(q, ld, table, lengths, o, m, l, B, G, R,
                                     D, page_len, nb, splits, n_pages,
                                     stream);
}

}  // namespace paged_walk
