// Device code the block kernel (block_wm.cu), its backward (block_bwd.cu) and
// the grid attention (grid_attn.cu) share: the shifted-window gather of a
// block's input and the windowed attention of one (window, head).
#pragma once

#include "common.cuh"

namespace pangu {

struct BlockShift {
  int dz, dh, dw, canon_add, h_real;
};

// 1. gather: one warp per window-coordinate row
template <typename T>
__global__ void __launch_bounds__(256)
block_gather_kernel(const T* __restrict__ x, T* __restrict__ xg, long long M,
                    int C, WmShape s, BlockShift sh, int in_canon) {
  const int lane = threadIdx.x % 32;
  const long long m = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (m >= M) return;
  const WmPos p = wm_split(m, s);
  const int Z = s.nz * s.wz, hp = s.nlat * s.wh, W = s.nlon * s.ww;
  T* dst = xg + m * C;
  if (pmod(s.wh * p.hh + p.rh + sh.canon_add, hp) >= sh.h_real) {
    for (int c = lane; c < C; c += 32) dst[c] = from_f<T>(0.f);
    return;
  }
  const int z = pmod(s.wz * p.zz + p.rz + sh.dz, Z);
  const int lat = pmod(s.wh * p.hh + p.rh + sh.dh, hp);
  const int lon = pmod(s.ww * p.l + p.rw + sh.dw, W);
  const T* src = x + (in_canon ? grid_row(p.b, z, lat, lon, s)
                               : wm_row(p.b, z, lat, lon, s)) * C;
  for (int c = lane; c < C; c += 32) dst[c] = src[c];
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
