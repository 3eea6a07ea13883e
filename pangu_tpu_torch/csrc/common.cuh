// Shared device code of the window-major kernels: element types, rounding,
// window-major index arithmetic, warp reductions, and the two building blocks
// every kernel unit is made of -- a tiled GEMM with a fused epilogue and a
// row-wise LayerNorm (+ residual).
//
// Element types: T is float or __nv_bfloat16.  Every product accumulates in
// float32; a value is rounded to T exactly where the JAX kernels round it
// (see the notes at each call site), so the bf16 path agrees with them.
//
// GEMM routes: float32 runs an smem-tiled FMA loop (64x64x16 tiles, 4x4 per
// thread); bf16 runs WMMA 16x16x16 tensor-core fragments (64x64x32 tiles,
// four warps of 32x32).  Neither is tuned: they are the simple, right first
// version (what bounds each unit on the card is noted in its .cu file).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace pangu {

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// element conversion and rounding
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype(bf16)
}

// v rounded to T and widened back to float
template <typename T> __device__ __forceinline__ float round_t(float v) {
  return to_f(from_f<T>(v));
}

// eight consecutive values at p (16-byte aligned) as float, and stored
// from float (rounded to nearest even for bf16): the tensor-core products'
// epilogues (mma_gemm.cuh) hand an epilogue 8 columns at a time, and the
// bf16 block's row passes (block_common.cuh) move rows 16 bytes a lane
__device__ __forceinline__ void ld8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// eight bf16 held in 16 bytes, as float
__device__ __forceinline__ void unpack8(uint4 u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void ld8(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);  // one 16-byte load
  unpack8(u, v);
}

__device__ __forceinline__ void st8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void st8(bf16* p, const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ int pmod(int a, int m) {
  int r = a % m;
  return r < 0 ? r + m : r;
}

// ---------------------------------------------------------------------------
// window-major storage (B, nz, nlat, nlon, N, C), N ordered (z, lat, lon)
// ---------------------------------------------------------------------------

struct WmShape {
  int nz, nlat, nlon, n;  // window grid and tokens per window
  int wz, wh, ww;         // window extent
};

struct WmPos {  // a row of wm storage, split into window and in-window index
  int b, zz, hh, l, rz, rh, rw;
};

__device__ __forceinline__ WmPos wm_split(long long m, const WmShape& s) {
  WmPos p;
  int t = (int)(m % s.n);
  long long r = m / s.n;
  p.l = (int)(r % s.nlon);
  r /= s.nlon;
  p.hh = (int)(r % s.nlat);
  r /= s.nlat;
  p.zz = (int)(r % s.nz);
  p.b = (int)(r / s.nz);
  p.rw = t % s.ww;
  p.rh = (t / s.ww) % s.wh;
  p.rz = t / (s.ww * s.wh);
  return p;
}

// row of token (z, lat, lon) of sample b; coordinates already in range
__device__ __forceinline__ long long wm_row(int b, int z, int lat, int lon,
                                            const WmShape& s) {
  long long win = (((long long)b * s.nz + z / s.wz) * s.nlat + lat / s.wh) *
                      s.nlon + lon / s.ww;
  return win * s.n + ((z % s.wz) * s.wh + lat % s.wh) * s.ww + lon % s.ww;
}

// row of token (z, lat, lon) of sample b in the (B, Z, Hp, W) token grid
__device__ __forceinline__ long long grid_row(int b, int z, int lat, int lon,
                                              const WmShape& s) {
  return (((long long)b * s.nz * s.wz + z) * (s.nlat * s.wh) + lat) *
             (s.nlon * s.ww) + lon;
}

// Where a kernel writes wm row m: the row itself, or (canon) the row of the
// same token in the (B, Z, Hp, W) grid, its window coordinates kept.
struct RowMap {
  int canon;
  WmShape s;
};

__device__ __forceinline__ long long map_row(long long m, const RowMap& r) {
  if (!r.canon) return m;
  const WmPos p = wm_split(m, r.s);
  return grid_row(p.b, r.s.wz * p.zz + p.rz, r.s.wh * p.hh + p.rh,
                  r.s.ww * p.l + p.rw, r.s);
}

// Rows whose canonical latitude (wh*hh + rh + canon_add) mod hp is at or
// beyond the real latitude count are latitude padding: zero-synthesised on
// read, or zeroed on write.
struct PadRows {
  int enabled;
  WmShape s;
  int hp, h_real, canon_add;
};

__device__ __forceinline__ bool is_pad_row(long long m, const PadRows& pr) {
  if (!pr.enabled) return false;
  int hh = (int)((m / ((long long)pr.s.n * pr.s.nlon)) % pr.s.nlat);
  int rh = (int)((m % pr.s.n) / pr.s.ww) % pr.s.wh;
  return pmod(pr.s.wh * hh + rh + pr.canon_add, pr.hp) >= pr.h_real;
}

// ---------------------------------------------------------------------------
// warp reductions
// ---------------------------------------------------------------------------

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// GEMM: C[M,N] = epilogue(A[M,K] @ B[K,N] + bias[N]); all row-major and
// contiguous.  Column tiles run on gridDim.x and row tiles on gridDim.y,
// which stops at 65,535 (a batch of 8 at stage 0 has 66,960 row tiles): a
// block takes row tiles blockIdx.y, blockIdx.y + gridDim.y, ...  (A grid
// flattened onto gridDim.x, the other way round the cap, ran the block
// 15-20% slower on the H100.)  Epilogue: the sum (float32) is rounded to T;
// with GELU the rounded value goes through GELU in float32 and is rounded
// again (the JAX block tail's order).  Rows flagged by ``pad`` are written
// as zeros.
// ---------------------------------------------------------------------------

enum Act { ACT_NONE = 0, ACT_GELU_ERF = 1, ACT_GELU_TANH = 2 };

template <typename T>
__device__ __forceinline__ T epilogue(float acc, const T* bias, int col, int act,
                                      bool zero) {
  if (zero) return from_f<T>(0.f);
  float v = acc + (bias ? to_f(bias[col]) : 0.f);
  if (act == ACT_GELU_ERF) {
    v = round_t<T>(v);
    v = v * 0.5f * (1.f + erff(v * 0.7071067811865476f));
  } else if (act == ACT_GELU_TANH) {
    v = round_t<T>(v);
    v = 0.5f * v * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
  }
  return from_f<T>(v);
}

// (The two non-template kernels are static: every .cu includes this header
// and all are linked into one library.)

// float32: smem-tiled FMA, 64x64 tile, 16-deep, 256 threads x (4x4)
constexpr int FM = 64, FN = 64, FK = 16;

static __global__ void __launch_bounds__(256)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                const float* __restrict__ bias, float* __restrict__ C, int M,
                int N, int K, int act, PadRows pad) {
  __shared__ float As[FK][FM + 4];
  __shared__ float Bs[FK][FN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * FN;
  for (long long mt = blockIdx.y; mt * FM < M; mt += gridDim.y) {
    const long long m0 = mt * FM;
    float acc[4][4] = {};
    for (int k0 = 0; k0 < K; k0 += FK) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int idx = tid + i * 256;
        int r = idx / FK, c = idx % FK;
        long long gr = m0 + r;
        int gc = k0 + c;
        As[c][r] = (gr < M && gc < K) ? A[gr * K + gc] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int idx = tid + i * 256;
        int r = idx / FN, c = idx % FN;
        int gr = k0 + r, gc = n0 + c;
        Bs[r][c] = (gr < K && gc < N) ? B[(long long)gr * N + gc] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < FK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      long long r = m0 + ty * 4 + i;
      if (r >= M) continue;
      bool zero = is_pad_row(r, pad);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int c = n0 + tx * 4 + j;
        if (c < N) C[r * N + c] = epilogue<float>(acc[i][j], bias, c, act, zero);
      }
    }
  }  // row tiles
}

// bf16: WMMA 16x16x16 fragments, 64x64 tile, 32-deep, 4 warps x (32x32)
constexpr int HM = 64, HN = 64, HK = 32;

static __global__ void __launch_bounds__(128)
gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                 const bf16* __restrict__ bias, bf16* __restrict__ C, int M,
                 int N, int K, int act, PadRows pad) {
  using namespace nvcuda;
  __shared__ __align__(128) bf16 As[HM][HK + 8];
  __shared__ __align__(128) bf16 Bs[HK][HN + 8];
  __shared__ __align__(128) float Cs[HM][HN + 4];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wr = warp / 2, wc = warp % 2;
  const int n0 = blockIdx.x * HN;
  const bf16 zero = __float2bfloat16(0.f);
  for (long long mt = blockIdx.y; mt * HM < M; mt += gridDim.y) {
    const long long m0 = mt * HM;

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    for (int k0 = 0; k0 < K; k0 += HK) {
      for (int idx = tid; idx < HM * HK; idx += 128) {
        int r = idx / HK, c = idx % HK;
        long long gr = m0 + r;
        int gc = k0 + c;
        As[r][c] = (gr < M && gc < K) ? A[gr * K + gc] : zero;
      }
      for (int idx = tid; idx < HK * HN; idx += 128) {
        int r = idx / HN, c = idx % HN;
        int gr = k0 + r, gc = n0 + c;
        Bs[r][c] = (gr < K && gc < N) ? B[(long long)gr * N + gc] : zero;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < HK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], &As[wr * 32 + i * 16][kk], HK + 8);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], &Bs[kk][wc * 32 + j * 16], HN + 8);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(&Cs[wr * 32 + i * 16][wc * 32 + j * 16], acc[i][j],
                                HN + 4, wmma::mem_row_major);
    __syncthreads();
    for (int idx = tid; idx < HM * HN; idx += 128) {
      int r = idx / HN, c = idx % HN;
      long long gr = m0 + r;
      int gc = n0 + c;
      if (gr < M && gc < N)
        C[gr * N + gc] = epilogue<bf16>(Cs[r][c], bias, gc, act, is_pad_row(gr, pad));
    }
  }  // row tiles
}

// gridDim.y holds at most 65,535 row tiles; a block loops over the rest
inline unsigned row_tile_blocks(int M, int tile) {
  const int tiles = (M + tile - 1) / tile;
  return (unsigned)(tiles < 65535 ? tiles : 65535);
}

inline void gemm(const float* A, const float* B, const float* bias, float* C,
                 int M, int N, int K, int act, PadRows pad, cudaStream_t st) {
  dim3 grid((N + FN - 1) / FN, row_tile_blocks(M, FM));
  gemm_f32_kernel<<<grid, 256, 0, st>>>(A, B, bias, C, M, N, K, act, pad);
}

inline void gemm(const bf16* A, const bf16* B, const bf16* bias, bf16* C, int M,
                 int N, int K, int act, PadRows pad, cudaStream_t st) {
  dim3 grid((N + HN - 1) / HN, row_tile_blocks(M, HM));
  gemm_bf16_kernel<<<grid, 128, 0, st>>>(A, B, bias, C, M, N, K, act, pad);
}

// ---------------------------------------------------------------------------
// Row LayerNorm over C channels, float32 statistics, one warp per row:
//   out = round_T(res + round_T(LN(y)))   (res given: the block tail)
//   out = round_T(LN(y))                   (res null; may run in place)
// Row m is written to out row map_row(m, out_map).  With a branch-scale
// pointer ``drop`` ((B, 2) float32, stochastic depth), the rounded LN value
// is multiplied by round_T(drop[b, which]) and rounded again before the
// residual is added, b = m / rows_per_sample; a null pointer is the plain
// tail.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256)
ln_rows_kernel(const T* y, const T* res, T* out, const T* __restrict__ scale,
               const T* __restrict__ shift, long long M, int C, RowMap out_map,
               const float* __restrict__ drop, int which,
               long long rows_per_sample) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= M) return;
  const T* yr = y + row * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += to_f(yr[c]);
  const float mu = warp_sum(s) / C;
  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    float d = to_f(yr[c]) - mu;
    v += d * d;
  }
  const float rs = rsqrtf(warp_sum(v) / C + 1e-5f);
  T* o = out + map_row(row, out_map) * C;
  const float ds = drop ? round_t<T>(drop[2 * (row / rows_per_sample) + which])
                        : 1.f;
  for (int c = lane; c < C; c += 32) {
    float ln = round_t<T>((to_f(yr[c]) - mu) * rs * to_f(scale[c]) + to_f(shift[c]));
    if (drop) ln = round_t<T>(ln * ds);
    if (res) ln += to_f(res[row * C + c]);
    o[c] = from_f<T>(ln);
  }
}

template <typename T>
inline void ln_rows(const T* y, const T* res, T* out, const T* scale,
                    const T* shift, long long M, int C, cudaStream_t st,
                    RowMap out_map = RowMap{}, const float* drop = nullptr,
                    int which = 0, long long rows_per_sample = 1) {
  const int rows_per_block = 8;
  long long blocks = (M + rows_per_block - 1) / rows_per_block;
  ln_rows_kernel<T><<<(unsigned)blocks, 32 * rows_per_block, 0, st>>>(
      y, res, out, scale, shift, M, C, out_map, drop, which, rows_per_sample);
}

// sample rows a warp at a time: one thread block of 8 warps per 8 rows
inline unsigned row_blocks(long long rows) { return (unsigned)((rows + 7) / 8); }

}  // namespace pangu

#define PANGU_CHECK_LAUNCH()                   \
  do {                                         \
    cudaError_t e_ = cudaGetLastError();       \
    if (e_ != cudaSuccess) return (int)e_;     \
  } while (0)
