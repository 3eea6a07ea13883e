// The GEMM shapes of the backward kernels: a product whose operands are read
// through functors, with a functor epilogue, and its deterministic split-K
// form for weight gradients.
//
//   xgemm(M, N, K, la, lb, epi):  for each (r, c) of an M x N output,
//     epi(0, r, c, sum_k la(r, k) * lb(k, c))   (sum in float32)
//   wgrad(rows, K, N, la, lb, part, out):  out[K x N] (float32) =
//     sum over rows of la(i, row) * lb(row, c): the rows are cut into
//     splits of WG_SPLIT_ROWS, each split's tile sums go to its own slice of
//     ``part``, and a second kernel adds the slices in split order.  No
//     atomics, so a gradient is the same bit for bit in every run, as the
//     TPU kernels' serial accumulation is.
//
// A loader is a struct with ``T operator()(long long r, long long k)`` (A) or
// ``(long long k, long long n)`` (B) and ``static constexpr bool kKFast``:
// true when neighbouring k are neighbouring addresses, false when the other
// index is contiguous (an A read transposed, as every weight gradient reads
// its activations; a row-major B).  The tile load puts the contiguous index
// on neighbouring threads.
//
// float32 only (the parity config's first kernels: smem-tiled FMA,
// 64x64x16, 4x4 per thread, untuned); every bf16 product of the backward
// runs on mma_gemm.cuh's tensor-core tiles, whose deterministic split sum
// (split_sum) is the one below.
#pragma once

#include "common.cuh"

namespace pangu {

constexpr long long WG_SPLIT_ROWS = 4096;

// A operands, la(r, k): a row-major (rows x ld) matrix, and the transpose of
// one, la(i, r) = p[r, i]; with ``ones`` set, row i == ld of the transpose
// reads 1 (the bias gradient rides the weight gradient as one more row)
template <typename T>
struct ARows {
  static constexpr bool kKFast = true;
  const T* p;
  long long ld;
  __device__ __forceinline__ T operator()(long long r, long long k) const {
    return p[r * ld + k];
  }
};

template <typename T>
struct ACols {
  static constexpr bool kKFast = false;
  const T* p;
  long long ld;
  int ones;
  __device__ __forceinline__ T operator()(long long i, long long r) const {
    if (ones && i == ld) return from_f<T>(1.f);
    return p[r * ld + i];
  }
};

// B operands, lb(k, n): a row-major (K x ld) matrix, and the transpose of a
// row-major (N x ld) weight, lb(k, n) = p[n, k] (a gradient through a dense
// layer multiplies by the weight's transpose)
template <typename T>
struct BRows {
  static constexpr bool kKFast = false;
  const T* p;
  long long ld;
  __device__ __forceinline__ T operator()(long long k, long long n) const {
    return p[k * ld + n];
  }
};

template <typename T>
struct BCols {
  static constexpr bool kKFast = true;
  const T* p;
  long long ld;
  __device__ __forceinline__ T operator()(long long k, long long n) const {
    return p[n * ld + k];
  }
};

// a weight gradient's split epilogue: part[split][r][c]
struct SplitStore {
  float* part;
  long long rows, cols;
  __device__ __forceinline__ void operator()(int z, long long r, int c,
                                             float acc) const {
    part[((long long)z * rows + r) * cols + c] = acc;
  }
  __device__ __forceinline__ void operator()(int z, long long r, int c,
                                             const float (&v)[8]) const {
    st8(part + ((long long)z * rows + r) * cols + c, v);
  }
};

template <typename LA, typename LB, typename Epi>
__global__ void __launch_bounds__(256)
xgemm_f32_kernel(long long M, int N, long long K, long long kchunk, LA la,
                 LB lb, Epi epi) {
  __shared__ float As[FK][FM + 4];
  __shared__ float Bs[FK][FN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * FN;
  const long long kbeg = blockIdx.z * kchunk;
  const long long kend = min(K, kbeg + kchunk);
  for (long long mt = blockIdx.y; mt * FM < M; mt += gridDim.y) {
    const long long m0 = mt * FM;
    float acc[4][4] = {};
    for (long long k0 = kbeg; k0 < kend; k0 += FK) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int idx = tid + i * 256;
        const int r = LA::kKFast ? idx / FK : idx % FM;
        const int c = LA::kKFast ? idx % FK : idx / FM;
        const long long gr = m0 + r, gc = k0 + c;
        As[c][r] = (gr < M && gc < kend) ? to_f(la(gr, gc)) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int idx = tid + i * 256;
        const int r = LB::kKFast ? idx % FK : idx / FN;
        const int c = LB::kKFast ? idx / FK : idx % FN;
        const long long gr = k0 + r;
        const int gc = n0 + c;
        Bs[r][c] = (gr < kend && gc < N) ? to_f(lb(gr, gc)) : 0.f;
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
      const long long r = m0 + ty * 4 + i;
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + tx * 4 + j;
        if (c < N) epi(blockIdx.z, r, c, acc[i][j]);
      }
    }
  }
}

inline unsigned xgemm_row_blocks(long long M, int tile) {
  const long long tiles = (M + tile - 1) / tile;
  return (unsigned)(tiles < 65535 ? tiles : 65535);
}

// C = la @ lb through ``epi``; ``splits`` > 1 cuts K into that many chunks
// of ``kchunk`` (the epilogue sees the chunk index)
template <typename LA, typename LB, typename Epi>
inline void xgemm(float*, long long M, int N, long long K, LA la, LB lb,
                  Epi epi, cudaStream_t st, int splits = 1,
                  long long kchunk = 0) {
  dim3 grid((N + FN - 1) / FN, xgemm_row_blocks(M, FM), splits);
  xgemm_f32_kernel<<<grid, 256, 0, st>>>(M, N, K, splits > 1 ? kchunk : K, la,
                                         lb, epi);
}

// out[i] = sum over z of part[z][i], z in order
static __global__ void __launch_bounds__(256)
split_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                 long long size, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[(long long)z * size + i];
  out[i] = s;
}

inline int wg_splits(long long rows) {
  return (int)((rows + WG_SPLIT_ROWS - 1) / WG_SPLIT_ROWS);
}

inline void split_sum(const float* part, float* out, long long size,
                      int splits, cudaStream_t st) {
  split_sum_kernel<<<(unsigned)((size + 255) / 256), 256, 0, st>>>(
      part, out, size, splits);
}

// out (K x N, float32) = sum over ``rows`` of la(i, row) * lb(row, c);
// ``part`` holds wg_splits(rows) * K * N floats
template <typename T, typename LA, typename LB>
inline void wgrad(long long rows, long long K, int N, LA la, LB lb,
                  float* part, float* out, cudaStream_t st) {
  const int splits = wg_splits(rows);
  xgemm((T*)nullptr, K, N, rows, la, lb, SplitStore{part, K, N}, st, splits,
        WG_SPLIT_ROWS);
  split_sum(part, out, K * N, splits, st);
}

}  // namespace pangu
