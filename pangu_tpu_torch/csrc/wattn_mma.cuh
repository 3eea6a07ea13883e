// The windowed attention in bf16 on the tensor cores: the forward of the
// block kernel (block_wm.cu, ungrouped and grouped alike) and of the grid
// attention (grid_attn.cu), the forward the backward units (block_bwd.cu,
// grid_attn.cu) recompute, and the backward with the bias-table gradient.
// The forward also runs the fused window attention (window_attn.cu), whose
// windows come partitioned lon-major: window w of type t is read as the
// type-t window of sample w of a grid with nz = nlon = 1, nlat = ntype.
// In bf16 they take the place of block_common.cuh::window_attention,
// block_wm.cu's group_attn_kernel and attn_bwd.cuh::attn_bwd_kernel;
// float32 keeps those CUDA-core kernels (TF32 products would miss float32's
// 1e-4 gate).
//
// Layout: qkv (M, 3C) and the cotangent dO (M, C) in window-major rows; a
// head's q, k, v, dO of one window are (N, hd) row-major tiles.  Logits as
// the CUDA-core kernels (prob_row, window_attend): hd^-1/2 (q.k) in
// float32 plus the table entry of type TB, plus -100 where the region ids
// differ; float32 softmax (ex2.approx and one reciprocal a row, a few
// float32 ulps from expf and a division, far inside the bf16 gate).
//   Forward: out = round(round(P) V).
//   Backward: dV = round(round(P)^T dO); dP = dO V^T in float32; dS32 =
//   P32 (dP - rowsum(dP P32)), summed unrounded into dtable[type, h]; dS =
//   round(dS32); dQ = round(hd^-1/2 dS K), dK = round(hd^-1/2 dS^T Q).
//
// What bounds them on an H100: bytes (qkv and dO read, dqkv written).
// Design, B11 / B12's (sdpa.cu) on this layout: one block per (window
// type, head), the heads of a type on neighbouring blocks (so the 64-byte
// head slices of a row are read and written at about the same time),
// walking the type's B x nlon windows in order, one warp per 16 query rows
// (N padded to 16, at most 144: nine warps), q, k, v (and dO) by cp.async
// into (np, hd + pad) tiles: the backward's double-buffered where shared
// memory allows, the forward's single (see wa_plan).
// The (type, head) bias is the same for every window of a block, so it is
// staged in shared memory once per block: the table slice in its own dtype
// beside a bit mask of the ids (a folded float32 slice would leave the
// backward no room for the table gradient's partial).  Reading the bias
// from device memory for every window spilled registers and ran ~1 ms
// slower at stage 0.  Per
// warp: the bias into the logit registers, S = q k^T by mma.sync m16n8k16
// per 16-key chunk folded in as s = scale acc + bias, the softmax in
// registers (quad shuffles).  The forward repacks P rounded as the A
// operand of P V.  The backward keeps P32 in registers for the whole window
// (P never goes to device memory: the JAX package's PANGU_BWD_STASH_P
// switch has no counterpart), forms dP in 16-key chunks twice (rowsum
// first, then dS), adds dS32 into the warp's own rows of the table gradient
// (a float32 partial in shared memory, zeroed once and written to device
// memory once per block, where it fits: bf16 tables; else those rows of
// dtable, the first window writing: one owner per entry, no atomics,
// windows in a fixed order), rounds dS into a shared (np, np) tile for dK
// and dQ, then round(P) into it for dV.  Outputs are stored as bf16 pairs
// from the C fragments.
#pragma once

#include <type_traits>

#include "attn_bwd.cuh"
#include "attn_mma.cuh"

namespace pangu {

constexpr int WA_KT = 9;  // key tiles of 16: N <= 144, one warp per 16 rows

struct WaGeo {  // the window grid of a launch (wm row order)
  int B, nz, nlat, nlon, N, C, heads, hd;
};

__host__ __device__ inline int wa_ldh(int hd) { return pad16(hd) + 8; }

// first storage row of window `win` (b = win / nlon, l = win % nlon) of
// type (zz, hh)
__device__ __forceinline__ long long wa_base(const WaGeo& w, int zz, int hh,
                                             int win) {
  const int b = win / w.nlon, l = win % w.nlon;
  return ((((long long)b * w.nz + zz) * w.nlat + hh) * w.nlon + l) * w.N;
}

// One (type, head) bias as both kernels hold it: the table slice in its
// own dtype TB as an (np, ldx) shared tile (key columns >= N at -inf, rows
// >= N zero) and the region-id mask as a bit per (query, key) pair, np rows
// of mw 32-bit words (bit j of row i: ids i and j differ); built once per
// block by the whole block.
__host__ __device__ inline int wa_mask_words(int np) { return np / 32 + 1; }

template <typename TB>
__device__ __forceinline__ void wa_stage_table(TB* tb, int ldx, uint32_t* msk,
                                               const TB* __restrict__ bt,
                                               const int* sid, int N,
                                               int np) {
  for (int idx = threadIdx.x; idx < np * np; idx += blockDim.x) {
    const int i = idx / np, j = idx % np;
    tb[i * ldx + j] = j >= N   ? from_f<TB>(-INFINITY)
                      : i >= N ? from_f<TB>(0.f)
                               : bt[(long long)i * N + j];
  }
  const int mw = wa_mask_words(np);
  for (int idx = threadIdx.x; idx < np * mw; idx += blockDim.x) {
    const int i = idx / mw, j0 = 32 * (idx % mw);
    uint32_t bits = 0u;
    if (sid && i < N)
      for (int b = 0; b < 32 && j0 + b < N; ++b)
        if (sid[i] != sid[j0 + b]) bits |= 1u << b;
    msk[idx] = bits;
  }
}

// two neighbouring entries of a shared table tile as float
__device__ __forceinline__ float2 tb_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 tb_pair(const bf16* p) {
  return unpack_bf16(*reinterpret_cast<const uint32_t*>(p));
}

// the logits' bias of query rows [i0, i0+16) in C-tile layout: the table
// entry plus -100 where the region ids differ, as prob_row adds them
template <int NT, typename TB>
__device__ __forceinline__ void wa_bias_table(float (&s)[NT][4], const TB* tb,
                                              int ldx, const uint32_t* msk,
                                              int mw, int i0, int live) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    if (nt < live)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = i0 + g + 8 * half, j = 8 * nt + 2 * t;
        const float2 v = tb_pair(tb + r * ldx + j);
        const uint32_t bits = msk[r * mw + (j >> 5)] >> (j & 31);
        s[nt][2 * half] = v.x + ((bits & 1u) ? -100.f : 0.f);
        s[nt][2 * half + 1] = v.y + ((bits & 2u) ? -100.f : 0.f);
      }
}

// P32 of query rows [i0, i0+16): s holds the bias on entry; s = scale (q
// k^T) + bias per 16-key chunk (k over hd padded to 16), softmax per row;
// rows >= N zeroed (they enter no gradient)
template <int KT>
__device__ __forceinline__ void wa_probs(float (&s)[2 * KT][4],
                                         const bf16* qt, const bf16* kt,
                                         int ldh, int i0, int N, int nkt,
                                         int dkr, float scale) {
#pragma unroll
  for (int jp = 0; jp < KT; ++jp)
    if (jp < nkt) {
      float acc[2][4] = {};
#pragma unroll 1
      for (int kc = 0; kc < dkr; ++kc) {
        uint32_t a[4], b[2][2];
        load_a_n(a, qt, ldh, 16 * kc, i0);
        load_b_n(b, kt, ldh, 16 * kc, 16 * jp);
        mma_bf16(acc[0], a, b[0]);
        mma_bf16(acc[1], a, b[1]);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[2 * jp + hh][e] = fmaf(acc[hh][e], scale, s[2 * jp + hh][e]);
    }
  row_softmax<2 * KT>(s, 2 * nkt);
  const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int nt = 0; nt < 2 * KT; ++nt) {
    if (i0 + g >= N) s[nt][0] = s[nt][1] = 0.f;
    if (i0 + g + 8 >= N) s[nt][2] = s[nt][3] = 0.f;
  }
}

// mul * acc (rows [m0, m0+16), head-dim columns [d0, d0+32)) rounded to
// bf16 at dst + row * ld + col, rows < N and columns < hd; bf16 pairs
// where hd is even
__device__ __forceinline__ void wa_store(const float (&acc)[4][4], bf16* dst,
                                         long long ld, int m0, int N, int d0,
                                         int hd, float mul) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = d0 + 8 * nt + 2 * t;
    if (col >= hd) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + g + 8 * half;
      if (r >= N) continue;
      bf16* p = dst + (long long)r * ld + col;
      const float v0 = mul * acc[nt][2 * half], v1 = mul * acc[nt][2 * half + 1];
      if ((hd & 1) == 0) {
        *reinterpret_cast<uint32_t*>(p) = pack_bf16(v0, v1);
      } else {
        p[0] = __float2bfloat16(v0);
        if (col + 1 < hd) p[1] = __float2bfloat16(v1);
      }
    }
  }
}

// rows [m0, m0+16) x head-dim columns [d0, d0+32) of X^T b (!kN: dK = dS^T
// q, dV = P^T dO) or X b (kN: dQ = dS k), k over the np tokens; X an (np,
// ldx) tile, b an (np, ldh) tile
template <bool kN>
__device__ __forceinline__ void wa_slab(float (&acc)[4][4], const bf16* X,
                                        int ldx, const bf16* bt, int ldh,
                                        int m0, int nkt, int d0, int dkr) {
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll 1
  for (int kc = 0; kc < nkt; ++kc) {
    uint32_t a[4];
    if (kN)
      load_a_n(a, X, ldx, 16 * kc, m0);
    else
      load_a_t(a, X, ldx, 16 * kc, m0);
#pragma unroll
    for (int dc = 0; dc < 2; ++dc) {
      if (d0 / 16 + dc >= dkr) continue;
      uint32_t b[2][2];
      load_b_t(b, bt, ldh, 16 * kc, d0 + 16 * dc);
      mma_bf16(acc[2 * dc], a, b[0]);
      mma_bf16(acc[2 * dc + 1], a, b[1]);
    }
  }
}

// N rows x hd columns of a row-major matrix (row stride ld) into an (np,
// ldh) tile, by the whole block: 16-byte cp.async copies where vec, else
// element by element (synchronous); pads are not written
__device__ __forceinline__ void wa_load_tile(bf16* dst, int ldh,
                                             const bf16* __restrict__ src,
                                             long long ld, int N, int hd,
                                             bool vec) {
  if (vec) {
    const int cpr = hd / 8;
    for (int idx = threadIdx.x; idx < N * cpr; idx += blockDim.x) {
      const int r = idx / cpr, c = (idx % cpr) * 8;
      cp_async16(dst + r * ldh + c, src + r * ld + c);
    }
  } else {
    for (int idx = threadIdx.x; idx < N * hd; idx += blockDim.x) {
      const int r = idx / hd, c = idx % hd;
      dst[r * ldh + c] = src[r * ld + c];
    }
  }
}

// head h's q, k, v (and dO where dout) of window `win` into consecutive
// (np, ldh) tiles, one commit group
__device__ __forceinline__ void wa_load(bf16* tiles, int tile,
                                        const bf16* __restrict__ qkv,
                                        const bf16* __restrict__ dout,
                                        const WaGeo& w, int zz, int hh, int h,
                                        int win, int ldh, bool vec) {
  const long long base = wa_base(w, zz, hh, win);
  const bf16* q = qkv + base * 3 * w.C + h * w.hd;
  for (int i = 0; i < 3; ++i)
    wa_load_tile(tiles + i * tile, ldh, q + i * w.C, 3LL * w.C, w.N, w.hd,
                 vec);
  if (dout)
    wa_load_tile(tiles + 3 * tile, ldh, dout + base * w.C + h * w.hd, w.C,
                 w.N, w.hd, vec);
  cp_async_commit();
}

// the type's region ids into shared memory (0 past N); null without ids
__device__ __forceinline__ const int* wa_ids(int* sid, const int* ids,
                                             int type, int N, int np) {
  for (int i = threadIdx.x; i < np; i += blockDim.x)
    sid[i] = (ids && i < N) ? ids[(long long)type * N + i] : 0;
  return ids ? sid : nullptr;
}

// forward: one block per (window type, head) over the type's windows, one
// tile buffer (wa_plan)
template <typename TB>
__global__ void __launch_bounds__(32 * WA_KT)
wattn_mma_fwd_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                     const TB* __restrict__ table, const int* __restrict__ ids,
                     WaGeo w, float scale, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int N = w.N, np = pad16(N), nkt = np / 16, ldx = np + 8;
  const int mw = wa_mask_words(np);
  const int hdp = pad16(w.hd), dkr = hdp / 16, ldh = hdp + 8;
  const int warp = threadIdx.x >> 5, i0 = 16 * warp;
  const int type = blockIdx.x / w.heads, h = blockIdx.x % w.heads;
  const int zz = type / w.nlat, hh = type % w.nlat;
  unsigned char* p = smem_raw;
  TB* tb = reinterpret_cast<TB*>(p);  // the table slice: (np, ldx)
  p += (size_t)np * ldx * sizeof(TB);
  uint32_t* msk = reinterpret_cast<uint32_t*>(p);  // (np, mw)
  p += (size_t)np * mw * sizeof(uint32_t);
  int* sid = reinterpret_cast<int*>(p);
  p += (size_t)np * sizeof(int);
  bf16* tiles = reinterpret_cast<bf16*>(p);
  const int tile = np * ldh;
  zero_smem(tiles, (size_t)3 * tile * sizeof(bf16));
  const int* sidp = wa_ids(sid, ids, type, N, np);
  __syncthreads();  // the ids
  const int nwin = w.B * w.nlon;
  wa_load(tiles, tile, qkv, nullptr, w, zz, hh, h, 0, ldh, vec);
  wa_stage_table(tb, ldx, msk, table + ((long long)type * w.heads + h) * N * N,
                 sidp, N, np);
  __syncthreads();  // the table tile, the mask and zeros
  const bf16 *qt = tiles, *kt = qt + tile, *vt = kt + tile;
  for (int win = 0; win < nwin; ++win) {
    float s[2 * WA_KT][4];
    wa_bias_table<2 * WA_KT>(s, tb, ldx, msk, mw, i0, 2 * nkt);
    cp_async_wait<0>();
    __syncthreads();  // window win's tiles are in
    if (warp < nkt) {
      wa_probs<WA_KT>(s, qt, kt, ldh, i0, N, nkt, dkr, scale);
      uint32_t pa[WA_KT][4];  // P rounded to bf16, the A operand of P V
#pragma unroll
      for (int jp = 0; jp < WA_KT; ++jp)
        if (jp < nkt) c_to_a(pa[jp], s[2 * jp], s[2 * jp + 1]);
      bf16* dst = out + wa_base(w, zz, hh, win) * w.C + h * w.hd;
      for (int d0 = 0; d0 < hdp; d0 += 32) {
        float o[4][4] = {};
#pragma unroll
        for (int jp = 0; jp < WA_KT; ++jp)
          if (jp < nkt) {
#pragma unroll
            for (int dc = 0; dc < 2; ++dc)
              if (d0 / 16 + dc < dkr) {
                uint32_t b[2][2];
                load_b_t(b, vt, ldh, 16 * jp, d0 + 16 * dc);
                mma_bf16(o[2 * dc], pa[jp], b[0]);
                mma_bf16(o[2 * dc + 1], pa[jp], b[1]);
              }
          }
        wa_store(o, dst, w.C, i0, N, d0, w.hd, 1.f);
      }
    }
    __syncthreads();  // every warp is done with the tiles
    if (win + 1 < nwin)
      wa_load(tiles, tile, qkv, nullptr, w, zz, hh, h, win + 1, ldh, vec);
  }
}

// v added into the table gradient in device memory at (r, c), (r, c+1)
// where they lie inside the N x N slice; the first window writes
__device__ __forceinline__ void dtab_add(float* dt, int r, int c, int N,
                                         float v0, float v1, bool first) {
  if (r >= N) return;
  float* e = dt + (long long)r * N + c;
  if (c + 1 < N && (N & 1) == 0) {
    float2* e2 = reinterpret_cast<float2*>(e);
    const float2 o = first ? make_float2(0.f, 0.f) : *e2;
    *e2 = make_float2(o.x + v0, o.y + v1);
  } else {
    if (c < N) e[0] = first ? v0 : e[0] + v0;
    if (c + 1 < N) e[1] = first ? v1 : e[1] + v1;
  }
}

// backward: one block per (window type, head) over the type's windows; the
// table gradient summed in a shared partial written once at the end
// (db_shared), or in the block's own rows of dtable
template <typename TB>
__global__ void __launch_bounds__(32 * WA_KT)
wattn_mma_bwd_kernel(const bf16* __restrict__ qkv,
                     const bf16* __restrict__ dout, bf16* __restrict__ dqkv,
                     const TB* __restrict__ table, const int* __restrict__ ids,
                     float* __restrict__ dtable, WaGeo w, float scale,
                     int nbuf, int db_shared, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int N = w.N, np = pad16(N), nkt = np / 16, ldx = np + 8;
  const int mw = wa_mask_words(np);
  const int hdp = pad16(w.hd), dkr = hdp / 16, ldh = hdp + 8;
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int warp = threadIdx.x >> 5, i0 = 16 * warp;
  const int type = blockIdx.x / w.heads, h = blockIdx.x % w.heads;
  const int zz = type / w.nlat, hh = type % w.nlat;
  const long long th = (long long)type * w.heads + h;
  const TB* bt = table + th * N * N;
  float* dglob = dtable + th * N * N;
  unsigned char* p = smem_raw;
  float* db = reinterpret_cast<float*>(p);  // (np, ldx) where db_shared
  p += db_shared ? (size_t)np * ldx * sizeof(float) : 0;
  bf16* X = reinterpret_cast<bf16*>(p);  // dS, then P: (np, ldx)
  p += (size_t)np * ldx * sizeof(bf16);
  TB* tb = reinterpret_cast<TB*>(p);  // the table slice: (np, ldx)
  p += (size_t)np * ldx * sizeof(TB);
  uint32_t* msk = reinterpret_cast<uint32_t*>(p);  // (np, mw)
  p += (size_t)np * mw * sizeof(uint32_t);
  int* sid = reinterpret_cast<int*>(p);
  p += (size_t)np * sizeof(int);
  bf16* tiles = reinterpret_cast<bf16*>(p);
  const int tile = np * ldh;
  zero_smem(tiles, (size_t)nbuf * 4 * tile * sizeof(bf16));
  if (db_shared) zero_smem(db, (size_t)np * ldx * sizeof(float));
  const int* sidp = wa_ids(sid, ids, type, N, np);
  __syncthreads();  // the ids
  wa_stage_table(tb, ldx, msk, table + th * N * N, sidp, N, np);
  __syncthreads();  // the table tile, the mask and zeros
  const int nwin = w.B * w.nlon;
  const long long C3 = 3LL * w.C;
  wa_load(tiles, tile, qkv, dout, w, zz, hh, h, 0, ldh, vec);
  for (int win = 0; win < nwin; ++win) {
    const int buf = nbuf == 2 ? win & 1 : 0;
    float s[2 * WA_KT][4];  // P32 of the warp's rows for the whole window
    wa_bias_table<2 * WA_KT>(s, tb, ldx, msk, mw, i0, 2 * nkt);
    if (nbuf == 2 && win + 1 < nwin) {
      wa_load(tiles + (buf ^ 1) * 4 * tile, tile, qkv, dout, w, zz, hh, h,
              win + 1, ldh, vec);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // window win's tiles are in
    const bf16* qt = tiles + buf * 4 * tile;
    const bf16 *kt = qt + tile, *vt = kt + tile, *ot = vt + tile;
    bf16* dq = dqkv + wa_base(w, zz, hh, win) * C3 + h * w.hd;

    // rows: P32, rowsum(dP P32), dS32 into the table gradient, dS into X
    if (warp < nkt) {
      wa_probs<WA_KT>(s, qt, kt, ldh, i0, N, nkt, dkr, scale);
      // dP of keys [16 jp, 16 jp + 16): dO V^T
      auto dp_chunk = [&](float (&dp)[2][4], int jp) {
#pragma unroll 1
        for (int kc = 0; kc < dkr; ++kc) {
          uint32_t a[4], b[2][2];
          load_a_n(a, ot, ldh, 16 * kc, i0);
          load_b_n(b, vt, ldh, 16 * kc, 16 * jp);
          mma_bf16(dp[0], a, b[0]);
          mma_bf16(dp[1], a, b[1]);
        }
      };
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int jp = 0; jp < WA_KT; ++jp)
        if (jp < nkt) {
          float dp[2][4] = {};
          dp_chunk(dp, jp);
#pragma unroll
          for (int hh2 = 0; hh2 < 2; ++hh2) {
            const float* pp = s[2 * jp + hh2];
            rs0 += dp[hh2][0] * pp[0] + dp[hh2][1] * pp[1];
            rs1 += dp[hh2][2] * pp[2] + dp[hh2][3] * pp[3];
          }
        }
      rs0 = quad_sum(rs0);
      rs1 = quad_sum(rs1);
#pragma unroll
      for (int jp = 0; jp < WA_KT; ++jp)
        if (jp < nkt) {
          float dp[2][4] = {};
          dp_chunk(dp, jp);
#pragma unroll
          for (int hh2 = 0; hh2 < 2; ++hh2) {
            const float* pp = s[2 * jp + hh2];
            float* d = dp[hh2];
            d[0] = pp[0] * (d[0] - rs0);
            d[1] = pp[1] * (d[1] - rs0);
            d[2] = pp[2] * (d[2] - rs1);
            d[3] = pp[3] * (d[3] - rs1);
            const int j = 16 * jp + 8 * hh2 + 2 * tq;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int r = i0 + gq + 8 * half;
              const float d0 = d[2 * half], d1 = d[2 * half + 1];
              if (db_shared) {  // (np, ldx), zeroed: the pads take zeros
                float2* e = reinterpret_cast<float2*>(db + r * ldx + j);
                const float2 o = *e;
                *e = make_float2(o.x + d0, o.y + d1);
              } else {  // the row's own entries in device memory
                dtab_add(dglob, r, j, N, d0, d1, win == 0);
              }
              *reinterpret_cast<uint32_t*>(X + r * ldx + j) =
                  pack_bf16(d0, d1);
            }
          }
        }
    }
    __syncthreads();  // X holds dS (rounded)

    // keys j0 = i0: dK = scale dS^T q; query rows i0: dQ = scale dS K
    if (warp < nkt) {
      for (int d0 = 0; d0 < hdp; d0 += 32) {
        float acc[4][4];
        wa_slab<false>(acc, X, ldx, qt, ldh, i0, nkt, d0, dkr);
        wa_store(acc, dq + w.C, C3, i0, N, d0, w.hd, scale);
        wa_slab<true>(acc, X, ldx, kt, ldh, i0, nkt, d0, dkr);
        wa_store(acc, dq, C3, i0, N, d0, w.hd, scale);
      }
    }
    __syncthreads();  // X is read

    if (warp < nkt) {  // P rounded into X
#pragma unroll
      for (int nt = 0; nt < 2 * WA_KT; ++nt) {
        if (nt >= 2 * nkt) continue;
        const int j = 8 * nt + 2 * tq;
        *reinterpret_cast<uint32_t*>(X + (i0 + gq) * ldx + j) =
            pack_bf16(s[nt][0], s[nt][1]);
        *reinterpret_cast<uint32_t*>(X + (i0 + gq + 8) * ldx + j) =
            pack_bf16(s[nt][2], s[nt][3]);
      }
    }
    __syncthreads();  // X holds P

    if (warp < nkt) {  // keys j0 = i0: dV = P^T dO
      for (int d0 = 0; d0 < hdp; d0 += 32) {
        float acc[4][4];
        wa_slab<false>(acc, X, ldx, ot, ldh, i0, nkt, d0, dkr);
        wa_store(acc, dq + 2 * w.C, C3, i0, N, d0, w.hd, 1.f);
      }
    }
    __syncthreads();  // every warp is done with this buffer and X
    if (nbuf == 1 && win + 1 < nwin)
      wa_load(tiles, tile, qkv, dout, w, zz, hh, h, win + 1, ldh, vec);
  }
  if (db_shared)
    for (int i = warp; i < N; i += blockDim.x >> 5)
      for (int j = lane; j < N; j += 32)
        dglob[(long long)i * N + j] = db[i * ldx + j];
}

// ---- host side ------------------------------------------------------------------

// dynamic shared bytes, tile buffers and (backward) whether the table
// gradient's partial is in shared memory, of the forward (bwd false) or
// backward kernel at (N, hd) with a table of tb_bytes a value; smem 0 where
// they cannot take the shape (N above 144, or tiles beyond shared memory)
struct WaPlan {
  int nbuf, db_shared;
  size_t smem;
};

inline WaPlan wa_plan(bool bwd, int N, int hd, size_t tb_bytes,
                      size_t max_smem) {
  WaPlan p{0, 0, 0};
  if (N < 1 || hd < 1 || pad16(N) > 16 * WA_KT) return p;
  const size_t np = pad16(N), tile = np * (np + 8);
  const size_t set = (size_t)(bwd ? 4 : 3) * np * wa_ldh(hd) * sizeof(bf16);
  // ids, the mask and the table tile; backward: the dS / P tile (and the
  // float32 partial)
  const size_t base = np * sizeof(int) + np * wa_mask_words((int)np) * 4 +
                      tile * (tb_bytes + (bwd ? sizeof(bf16) : 0));
  // the forward keeps one buffer: measured against two at full width on
  // the H100 (bf16 table, stage 0), its attention ran ~1.5% faster (one
  // CTA of nine warps fills a SM either way at ~163 registers a thread,
  // and the smaller plan leaves more of the SM to L1)
  for (int shared = bwd ? 1 : 0; shared >= 0; --shared)
    for (int nbuf = bwd ? 2 : 1; nbuf >= 1; --nbuf) {
      const size_t bytes = base + shared * tile * sizeof(float) + nbuf * set;
      if (bytes <= max_smem) return WaPlan{nbuf, shared, bytes};
    }
  return p;
}

inline size_t wa_max_smem() {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (size_t)v;
}

inline bool wa_vec(const WaGeo& w, const void* a, const void* b) {
  return w.hd % 8 == 0 && w.C % 8 == 0 && ((uintptr_t)a & 15) == 0 &&
         ((uintptr_t)b & 15) == 0;
}

// attention forward of every window of B samples (out (M, C)); the logits
// scale (q k^T) + bias with scale hd^-1/2, or ``scale`` where it is not 0
// (window_attn.cu passes 1: its q is already scaled, in bf16)
template <typename TB>
inline int wa_attention(const bf16* qkv, bf16* out, const TB* table,
                        const int* ids, int B, const WmShape& s, int C,
                        int heads, cudaStream_t st, float scale = 0.f) {
  const WaGeo w = {B, s.nz, s.nlat, s.nlon, s.n, C, heads, C / heads};
  const WaPlan p = wa_plan(false, s.n, w.hd, sizeof(TB), wa_max_smem());
  if (!p.smem) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      wattn_mma_fwd_kernel<TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)p.smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)(s.nz * s.nlat * heads);
  wattn_mma_fwd_kernel<TB><<<grid, 2 * pad16(s.n), p.smem, st>>>(
      qkv, out, table, ids, w, scale != 0.f ? scale : attn_scale(w.hd),
      wa_vec(w, qkv, qkv));
  return (int)cudaGetLastError();
}

// attention backward: dqkv (M, 3C) and the table gradient of every window
template <typename TB>
inline int wa_attention_bwd(const bf16* qkv, const bf16* dout, bf16* dqkv,
                            const TB* table, const int* ids, float* dtable,
                            int B, const WmShape& s, int C, int heads,
                            cudaStream_t st) {
  const WaGeo w = {B, s.nz, s.nlat, s.nlon, s.n, C, heads, C / heads};
  const WaPlan p = wa_plan(true, s.n, w.hd, sizeof(TB), wa_max_smem());
  if (!p.smem) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      wattn_mma_bwd_kernel<TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)p.smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)(s.nz * s.nlat * heads);
  wattn_mma_bwd_kernel<TB><<<grid, 2 * pad16(s.n), p.smem, st>>>(
      qkv, dout, dqkv, table, ids, dtable, w, attn_scale(w.hd), p.nbuf,
      p.db_shared, wa_vec(w, qkv, dout));
  return (int)cudaGetLastError();
}

// ---- the attention, by dtype ---------------------------------------------------

// the forward (the grid attention's, and the backward units' recompute):
// bf16 here, float32 on block_common.cuh's window_attention
template <typename T, typename TB>
inline int unit_attention(const T* qkv, T* out, const TB* table,
                          const int* ids, int B, const WmShape& s, int C,
                          int heads, cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value)
    return wa_attention<TB>(qkv, out, table, ids, B, s, C, heads, st);
  else
    return window_attention<T, TB>(qkv, out, table, ids, B, s, C, heads, st);
}

// the backward: bf16 here, float32 on attn_bwd.cuh's attn_bwd_kernel
template <typename T, typename TB>
inline int unit_attention_bwd(const T* qkv, const T* dout, T* dqkv,
                              const TB* table, const int* ids, float* dtable,
                              int B, const WmShape& s, int C, int heads,
                              cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value)
    return wa_attention_bwd<TB>(qkv, dout, dqkv, table, ids, dtable, B, s, C,
                                heads, st);
  else
    return attention_bwd<T, TB>(qkv, dout, dqkv, table, ids, dtable, B, s, C,
                                heads, st);
}

}  // namespace pangu
