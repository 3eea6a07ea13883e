// Device code the block kernel (block_wm.cu), its backward (block_bwd.cu) and
// the grid attention (grid_attn.cu) share: the shifted-window gather of a
// block's input and the windowed attention of one (window, head).
#pragma once

#include <type_traits>

#include "common.cuh"

namespace pangu {

struct BlockShift {
  int dz, dh, dw, canon_add, h_real;
};

// 1. gather: the input row window-coordinate row m reads (storage, or
// with in_canon the (B, Z, Hp, W) grid), or -1 for a latitude-pad row,
// which is zero-synthesised
__device__ __forceinline__ long long gather_src_row(long long m,
                                                    const WmShape& s,
                                                    const BlockShift& sh,
                                                    int in_canon) {
  const WmPos p = wm_split(m, s);
  const int Z = s.nz * s.wz, hp = s.nlat * s.wh, W = s.nlon * s.ww;
  if (pmod(s.wh * p.hh + p.rh + sh.canon_add, hp) >= sh.h_real) return -1;
  const int z = pmod(s.wz * p.zz + p.rz + sh.dz, Z);
  const int lat = pmod(s.wh * p.hh + p.rh + sh.dh, hp);
  const int lon = pmod(s.ww * p.l + p.rw + sh.dw, W);
  return in_canon ? grid_row(p.b, z, lat, lon, s) : wm_row(p.b, z, lat, lon, s);
}

// one warp per window-coordinate row, an element a lane at a time
template <typename T>
__global__ void __launch_bounds__(256)
block_gather_kernel(const T* __restrict__ x, T* __restrict__ xg, long long M,
                    int C, WmShape s, BlockShift sh, int in_canon) {
  const int lane = threadIdx.x % 32;
  const long long m = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (m >= M) return;
  const long long src = gather_src_row(m, s, sh, in_canon);
  T* dst = xg + m * C;
  if (src < 0) {
    for (int c = lane; c < C; c += 32) dst[c] = from_f<T>(0.f);
    return;
  }
  for (int c = lane; c < C; c += 32) dst[c] = x[src * C + c];
}

// ---- the bf16 block's row passes, 16 bytes a lane ------------------------------
// (C % 8 == 0 and 16-byte aligned rows; the C entries check both.)  One
// warp per row as above, lane j moving channels [8j, 8j + 8), [8j + 256,
// ...): a C = 192 row is one 16-byte access for 24 lanes instead of six
// 2-byte accesses for every lane.

// the gather: the same rows, copied 16 bytes at a time
static __global__ void __launch_bounds__(256)
block_gather16_kernel(const bf16* __restrict__ x, bf16* __restrict__ xg,
                      long long M, int C, WmShape s, BlockShift sh,
                      int in_canon) {
  const int lane = threadIdx.x % 32, cpr = C / 8;
  const long long m = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (m >= M) return;
  const long long src = gather_src_row(m, s, sh, in_canon);
  uint4* dst = reinterpret_cast<uint4*>(xg + m * C);
  const uint4* from = reinterpret_cast<const uint4*>(x + (src < 0 ? 0 : src) * C);
  for (int k = lane; k < cpr; k += 32)
    dst[k] = src < 0 ? make_uint4(0u, 0u, 0u, 0u) : from[k];
}

// the LayerNorm-residual pass of common.cuh's ln_rows_kernel (the same
// float32 statistics, branch scales, rounding points and row map); the
// sums run 8 channels a lane first, so a mean or variance may differ from
// ln_rows's in its last float32 bit
static __global__ void __launch_bounds__(256)
ln_rows16_kernel(const bf16* y, const bf16* res, bf16* out,
                 const bf16* __restrict__ scale,
                 const bf16* __restrict__ shift, long long M, int C,
                 RowMap out_map, const float* __restrict__ drop, int which,
                 long long rows_per_sample) {
  const int lane = threadIdx.x % 32, cpr = C / 8;
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= M) return;
  const bf16* yr = y + row * C;
  float s = 0.f;
  for (int k = lane; k < cpr; k += 32) {
    float v[8];
    ld8(yr + 8 * k, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) s += v[e];
  }
  const float mu = warp_sum(s) / C;
  float q = 0.f;
  for (int k = lane; k < cpr; k += 32) {
    float v[8];
    ld8(yr + 8 * k, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float d = v[e] - mu;
      q += d * d;
    }
  }
  const float rs = rsqrtf(warp_sum(q) / C + 1e-5f);
  bf16* o = out + map_row(row, out_map) * C;
  const float ds = drop ? round_t<bf16>(drop[2 * (row / rows_per_sample) + which])
                        : 1.f;
  for (int k = lane; k < cpr; k += 32) {
    float v[8], r[8];
    ld8(yr + 8 * k, v);
    if (res) ld8(res + row * C + 8 * k, r);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = 8 * k + e;
      float ln = round_t<bf16>((v[e] - mu) * rs * to_f(scale[c]) + to_f(shift[c]));
      if (drop) ln = round_t<bf16>(ln * ds);
      if (res) ln += r[e];
      v[e] = ln;
    }
    st8(o + 8 * k, v);
  }
}

// the gather of a block's input by dtype: bf16 16 bytes a lane, float32 an
// element a lane
template <typename T>
inline void block_gather(const T* x, T* xg, long long M, int C,
                         const WmShape& s, const BlockShift& sh, int in_canon,
                         cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value)
    block_gather16_kernel<<<row_blocks(M), 256, 0, st>>>(x, xg, M, C, s, sh,
                                                         in_canon);
  else
    block_gather_kernel<T><<<row_blocks(M), 256, 0, st>>>(x, xg, M, C, s, sh,
                                                          in_canon);
}

// a block's LayerNorm-residual pass by dtype: bf16 16 bytes a lane,
// float32 common.cuh's ln_rows
template <typename T>
inline void block_ln(const T* y, const T* res, T* out, const T* scale,
                     const T* shift, long long M, int C, cudaStream_t st,
                     RowMap out_map, const float* drop, int which,
                     long long rows_per_sample) {
  if constexpr (std::is_same<T, bf16>::value)
    ln_rows16_kernel<<<row_blocks(M), 256, 0, st>>>(
        y, res, out, scale, shift, M, C, out_map, drop, which,
        rows_per_sample);
  else
    ln_rows<T>(y, res, out, scale, shift, M, C, st, out_map, drop, which,
               rows_per_sample);
}

// 3. windowed attention of one (window, head): q, k, v of the window in
// shared memory as float32 (rows padded to hd+1 against bank conflicts), one
// warp per query row; lane j holds scores j, j+32, ...  ``btab``/``id``: the
// window type's (N, N) bias slice for this head and its region ids (null for
// an unshifted block), in global or shared memory.  kScaleQ: q is scaled
// first, round_T(q * scale) with ``scale`` already rounded to T (the fused
// attention's order, window_attn.cu), and the scores are q.k + bias;
// otherwise the scores are q.k * scale + bias (the block kernels' order).
constexpr int ATT_WARPS = 8;
constexpr int GATT_WARPS = 16;
constexpr int ATT_MAXJ = 8;  // N <= 256

template <typename T, typename TB, bool kScaleQ = false>
__device__ __forceinline__ void window_attend(
    const T* __restrict__ qkv, T* __restrict__ out, long long base, int h,
    const TB* btab, const int* id, float* sm, int N, int C, int hd,
    float scale) {
  const int ld = hd + 1;
  float* q = sm;
  float* k = q + N * ld;
  float* v = k + N * ld;
  float* prow = v + N * ld;  // one row of N probabilities per warp
  const int C3 = 3 * C;
  const int nwarps = blockDim.x / 32;

  for (int idx = threadIdx.x; idx < N * hd; idx += blockDim.x) {
    int t = idx / hd, d = idx % hd;
    const T* r = qkv + (base + t) * C3 + h * hd + d;
    q[t * ld + d] = kScaleQ ? round_t<T>(to_f(r[0]) * scale) : to_f(r[0]);
    k[t * ld + d] = to_f(r[C]);
    v[t * ld + d] = to_f(r[2 * C]);
  }
  __syncthreads();

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float* pr = prow + warp * N;
  for (int i = warp; i < N; i += nwarps) {
    float s[ATT_MAXJ];
    float mx = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < ATT_MAXJ; ++jj) {
      int j = lane + 32 * jj;
      s[jj] = -INFINITY;
      if (j < N) {
        float acc = 0.f;
        for (int d = 0; d < hd; ++d) acc = fmaf(q[i * ld + d], k[j * ld + d], acc);
        float b = to_f(btab[(long long)i * N + j]);
        if (id) b += (id[i] != id[j]) ? -100.f : 0.f;
        s[jj] = (kScaleQ ? acc : acc * scale) + b;
      }
      mx = fmaxf(mx, s[jj]);
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < ATT_MAXJ; ++jj) {
      int j = lane + 32 * jj;
      s[jj] = (j < N) ? expf(s[jj] - mx) : 0.f;
      sum += s[jj];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int jj = 0; jj < ATT_MAXJ; ++jj) {
      int j = lane + 32 * jj;
      if (j < N) pr[j] = round_t<T>(s[jj] / sum);
    }
    __syncwarp();
    for (int d = lane; d < hd; d += 32) {
      float o = 0.f;
      for (int j = 0; j < N; ++j) o = fmaf(pr[j], v[j * ld + d], o);
      out[(base + i) * C + h * hd + d] = from_f<T>(o);
    }
    __syncwarp();
  }
}

__host__ __device__ inline size_t attend_smem(int N, int hd, int warps) {
  return (size_t)(3 * N * (hd + 1) + warps * N) * sizeof(float);
}

// one thread block per (window, head); type = zz * nlat + hh
template <typename T, typename TB>
__global__ void __launch_bounds__(32 * ATT_WARPS)
window_attn_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                   const TB* __restrict__ bias_table, const int* __restrict__ ids,
                   int N, int C, int heads, int hd, int nlon, int ntype_per_b,
                   float scale) {
  extern __shared__ float sm[];
  const long long win = blockIdx.x;
  const int h = blockIdx.y;
  const int type = (int)((win / nlon) % ntype_per_b);
  window_attend<T, TB>(qkv, out, win * N, h,
                       bias_table + ((long long)type * heads + h) * N * N,
                       ids ? ids + (long long)type * N : nullptr, sm, N, C,
                       hd, scale);
}

inline float attn_scale(int hd) { return (float)pow((double)hd, -0.5); }

// launch window_attn_kernel over every window of B samples (wm row order)
template <typename T, typename TB>
inline int window_attention(const T* qkv, T* out, const TB* table,
                            const int* ids, int B, const WmShape& s, int C,
                            int heads, cudaStream_t st) {
  const int hd = C / heads;
  const size_t smem = attend_smem(s.n, hd, ATT_WARPS);
  cudaError_t e = cudaFuncSetAttribute(window_attn_kernel<T, TB>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((long long)B * s.nz * s.nlat * s.nlon), heads);
  window_attn_kernel<T, TB><<<grid, 32 * ATT_WARPS, smem, st>>>(
      qkv, out, table, ids, s.n, C, heads, hd, s.nlon, s.nz * s.nlat,
      attn_scale(hd));
  return (int)cudaGetLastError();
}

}  // namespace pangu
