// Device code the block backward (block_bwd.cu) and the grid attention
// backward (grid_attn.cu) share: the GEMM epilogues that round a product to
// the activation dtype (one value at a time for grad_gemm.cuh's float32
// tiles, 8 columns at a time for mma_gemm.cuh's bf16 tensor-core tiles;
// BiasEpi and ZhEpi are the bf16 block forward's too, through fwd_gemm),
// and the float32 windowed attention backward with its bias table gradient
// (bf16 runs wattn_mma.cuh's).
#pragma once

#include "block_common.cuh"
#include "grad_gemm.cuh"

namespace pangu {

// ---- GEMM epilogues ---------------------------------------------------------

template <typename T>
struct BiasEpi {  // out = round_T(acc + bias)
  const T* bias;
  T* out;
  int N;
  __device__ void operator()(int, long long r, int c, float acc) const {
    out[r * N + c] = from_f<T>(acc + to_f(bias[c]));
  }
  __device__ void operator()(int, long long r, int c, const float (&v)[8]) const {
    float o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = v[e] + to_f(bias[c + e]);
    st8(out + r * N + c, o);
  }
};

// GELU of the block's MLP, erf or tanh form, on a value already rounded to
// the activation dtype (the JAX block tail's order)
__device__ __forceinline__ float gelu_f(float v, int tanh_form) {
  if (tanh_form)
    return 0.5f * v * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
  return v * 0.5f * (1.f + erff(v * 0.7071067811865476f));
}

template <typename T>
struct ZhEpi {  // z = round_T(acc + b1), h = round_T(GELU(z)); z null: h only
  const T* b1;
  T* z;  // null in the forward block, which keeps no z
  T* h;
  int N, tanh_form;
  __device__ void operator()(int, long long r, int c, float acc) const {
    const float v = round_t<T>(acc + to_f(b1[c]));
    if (z) z[r * N + c] = from_f<T>(v);
    h[r * N + c] = from_f<T>(gelu_f(v, tanh_form));
  }
  __device__ void operator()(int, long long r, int c, const float (&v)[8]) const {
    float zv[8], hv[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      zv[e] = round_t<T>(v[e] + to_f(b1[c + e]));
      hv[e] = gelu_f(zv[e], tanh_form);
    }
    if (z) st8(z + r * N + c, zv);
    st8(h + r * N + c, hv);
  }
};

template <typename T>
struct RoundEpi {
  T* out;
  int N;
  __device__ void operator()(int, long long r, int c, float acc) const {
    out[r * N + c] = from_f<T>(acc);
  }
  __device__ void operator()(int, long long r, int c, const float (&v)[8]) const {
    st8(out + r * N + c, v);
  }
};

template <typename T>
struct GridEpi {  // out row map_row(r) = round_T(acc (+ bias)): wm row -> grid
  const T* bias;  // may be null
  T* out;
  int N;
  RowMap map;
  __device__ void operator()(int, long long r, int c, float acc) const {
    out[map_row(r, map) * N + c] =
        from_f<T>(bias ? acc + to_f(bias[c]) : acc);
  }
  __device__ void operator()(int, long long r, int c, const float (&v)[8]) const {
    float o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = bias ? v[e] + to_f(bias[c + e]) : v[e];
    st8(out + map_row(r, map) * N + c, o);
  }
};

// ---- attention backward --------------------------------------------------------

constexpr int BATT_WARPS = 16;

// softmax probabilities (float32, unrounded) of query row i: lane j holds
// p[i, lane + 32 jj]; the same arithmetic as window_attend's scores
template <typename TB>
__device__ __forceinline__ void prob_row(const float* q, const float* k,
                                         int ld, int i, int N, int hd,
                                         const TB* btab, const int* id,
                                         float scale, float (&p)[ATT_MAXJ]) {
  const int lane = threadIdx.x % 32;
  float mx = -INFINITY;
#pragma unroll
  for (int jj = 0; jj < ATT_MAXJ; ++jj) {
    const int j = lane + 32 * jj;
    p[jj] = -INFINITY;
    if (j < N) {
      float acc = 0.f;
      for (int d = 0; d < hd; ++d) acc = fmaf(q[i * ld + d], k[j * ld + d], acc);
      float b = to_f(btab[(long long)i * N + j]);
      if (id) b += (id[i] != id[j]) ? -100.f : 0.f;
      p[jj] = acc * scale + b;
    }
    mx = fmaxf(mx, p[jj]);
  }
  mx = warp_max(mx);
  float sum = 0.f;
#pragma unroll
  for (int jj = 0; jj < ATT_MAXJ; ++jj) {
    const int j = lane + 32 * jj;
    p[jj] = (j < N) ? expf(p[jj] - mx) : 0.f;
    sum += p[jj];
  }
  sum = warp_sum(sum);
#pragma unroll
  for (int jj = 0; jj < ATT_MAXJ; ++jj) p[jj] /= sum;
}

__host__ __device__ inline size_t attn_bwd_smem(int N, int hd) {
  return (size_t)(4 * N * (hd + 1) + N * N) * sizeof(float);
}

// one thread block per (window type, head), looping over the type's windows
// (every sample, every longitude window); S holds one window's rounded dS,
// later its rounded P
template <typename T, typename TB>
__global__ void __launch_bounds__(32 * BATT_WARPS)
attn_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                T* __restrict__ dqkv, const TB* __restrict__ table,
                const int* __restrict__ ids, float* __restrict__ dtable,
                int B, int nz, int nlat, int nlon, int N, int C, int heads,
                int hd, float scale) {
  extern __shared__ float sm[];
  const int type = blockIdx.x, h = blockIdx.y;
  const int zz = type / nlat, hh = type % nlat;
  const int ld = hd + 1;
  float* q = sm;
  float* k = q + N * ld;
  float* v = k + N * ld;
  float* dO = v + N * ld;
  float* S = dO + N * ld;
  const TB* btab = table + ((long long)type * heads + h) * N * N;
  const int* id = ids ? ids + (long long)type * N : nullptr;
  float* dtab = dtable + ((long long)type * heads + h) * N * N;
  const int C3 = 3 * C;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;

  for (int b = 0; b < B; ++b) {
    for (int l = 0; l < nlon; ++l) {
      const long long base = ((((long long)b * nz + zz) * nlat + hh) * nlon + l) * N;
      const bool first = b == 0 && l == 0;
      __syncthreads();  // the previous window's shared memory is read
      for (int idx = threadIdx.x; idx < N * hd; idx += blockDim.x) {
        const int t = idx / hd, d = idx % hd;
        const T* r = qkv + (base + t) * C3 + h * hd + d;
        q[t * ld + d] = to_f(r[0]);
        k[t * ld + d] = to_f(r[C]);
        v[t * ld + d] = to_f(r[2 * C]);
        dO[t * ld + d] = to_f(dout[(base + t) * C + h * hd + d]);
      }
      __syncthreads();

      // rows: dS, the table gradient and dQ
      for (int i = warp; i < N; i += nwarps) {
        float p[ATT_MAXJ], dp[ATT_MAXJ];
        prob_row(q, k, ld, i, N, hd, btab, id, scale, p);
        float rs = 0.f;
#pragma unroll
        for (int jj = 0; jj < ATT_MAXJ; ++jj) {
          const int j = lane + 32 * jj;
          dp[jj] = 0.f;
          if (j < N) {
            float acc = 0.f;
            for (int d = 0; d < hd; ++d) acc = fmaf(dO[i * ld + d], v[j * ld + d], acc);
            dp[jj] = acc;
          }
          rs += dp[jj] * p[jj];
        }
        rs = warp_sum(rs);
#pragma unroll
        for (int jj = 0; jj < ATT_MAXJ; ++jj) {
          const int j = lane + 32 * jj;
          if (j < N) {
            const float ds = p[jj] * (dp[jj] - rs);
            float* t = dtab + (long long)i * N + j;
            *t = first ? ds : *t + ds;
            S[i * N + j] = round_t<T>(ds);
          }
        }
        __syncwarp();
        for (int d = lane; d < hd; d += 32) {
          float acc = 0.f;
          for (int j = 0; j < N; ++j) acc = fmaf(S[i * N + j], k[j * ld + d], acc);
          dqkv[(base + i) * C3 + h * hd + d] = from_f<T>(acc * scale);
        }
        __syncwarp();
      }
      __syncthreads();
      // dK = dS^T Q
      for (int idx = threadIdx.x; idx < N * hd; idx += blockDim.x) {
        const int j = idx / hd, d = idx % hd;
        float acc = 0.f;
        for (int i = 0; i < N; ++i) acc = fmaf(S[i * N + j], q[i * ld + d], acc);
        dqkv[(base + j) * C3 + C + h * hd + d] = from_f<T>(acc * scale);
      }
      __syncthreads();
      // P again, rounded; dV = P^T dO
      for (int i = warp; i < N; i += nwarps) {
        float p[ATT_MAXJ];
        prob_row(q, k, ld, i, N, hd, btab, id, scale, p);
#pragma unroll
        for (int jj = 0; jj < ATT_MAXJ; ++jj) {
          const int j = lane + 32 * jj;
          if (j < N) S[i * N + j] = round_t<T>(p[jj]);
        }
      }
      __syncthreads();
      for (int idx = threadIdx.x; idx < N * hd; idx += blockDim.x) {
        const int j = idx / hd, d = idx % hd;
        float acc = 0.f;
        for (int i = 0; i < N; ++i) acc = fmaf(S[i * N + j], dO[i * ld + d], acc);
        dqkv[(base + j) * C3 + 2 * C + h * hd + d] = from_f<T>(acc);
      }
    }
  }
}

// launch attn_bwd_kernel: dqkv and the table gradient of every window
template <typename T, typename TB>
inline int attention_bwd(const T* qkv, const T* dout, T* dqkv, const TB* table,
                         const int* ids, float* dtable, int B, const WmShape& s,
                         int C, int heads, cudaStream_t st) {
  const int hd = C / heads;
  const size_t smem = attn_bwd_smem(s.n, hd);
  cudaError_t e = cudaFuncSetAttribute(attn_bwd_kernel<T, TB>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(s.nz * s.nlat, heads);
  attn_bwd_kernel<T, TB><<<grid, 32 * BATT_WARPS, smem, st>>>(
      qkv, dout, dqkv, table, ids, dtable, B, s.nz, s.nlat, s.nlon, s.n, C,
      heads, hd, attn_scale(hd));
  return (int)cudaGetLastError();
}

}  // namespace pangu
