// Windowed scaled-dot-product attention on the transposed qkv layout,
// forward and backward.
//
// Replaces the Pallas kernels pangu_tpu/ops/window_attention.py::_sdpa_pallas
// (kernel body _make_kernel) and ::_sdpa_pallas_bwd (_make_bwd_kernel), which
// the "xla" backward of the grid attention (_grid_core's vjp through its
// reference composition, per-block and rolled-coordinate training) recomputes
// and differentiates.  Layouts as the Pallas kernels take them:
//   qkv   (nwin, ntype, 3, heads, hd, N), q / k / v stored transposed
//         (hd, N), in the model dtype T;
//   bias  (ntype, heads, N, N) float32, the shifted-window mask folded in;
//   out   (nwin, ntype, heads, hd, N), T;
//   g     the cotangent of out, its layout; dqkv qkv's layout and dtype;
//   dbias (ntype, heads, N, N) float32, the sum over nwin of dS.
//
// Forward, one thread block per (window, window type, head):
//   q, k, v of the window and head into shared memory as float32, q
//   multiplied by round_T(hd^-1/2) and rounded to T (the Pallas body scales q
//   in the input dtype); per query row (one warp) s = q.k + bias in float32,
//   softmax in float32, P rounded to T, o = P.V rounded to T (written over
//   the row's q, which no other row reads), then o to the output, coalesced
//   along N.
// Backward, one thread block per (window type, head), looping over the nwin
// windows in order:
//   P recomputed from the scaled, rounded q as the forward; per row
//   dP = dO V^T, dS = P o (dP - rowsum(dP o P)) in float32, summed unrounded
//   into dbias[type, h] (the block owns the slice: a fixed order, no
//   atomics), rounded to T into shared memory, and dQ = round_T(dS K
//   hd^-1/2); then over all threads dK = round_T(dS^T q_raw hd^-1/2) (the
//   UNSCALED q times the float32 scale, as the Pallas body); P again,
//   rounded to T; dV = round_T(P^T dO).  Every output is written coalesced
//   along N.
//
// What bounds it on an H100: bytes.  The forward does 4 N^2 hd FLOP per
// window and head against reading qkv and the bias and writing out (~0.9 GB
// at stage 0); the backward reads qkv, the bias and g and writes dqkv and
// dbias.  This first version runs the attention of the block kernel
// (block_common.cuh, attn_bwd.cuh): FMA dot products, one warp per query
// row, far from that bound; the float32 bias slice is read from device
// memory once per window and head (once per block of 144 x 144 in the
// backward's loop, where the dbias slice is read and written per window
// through the L2).
#include "attn_bwd.cuh"

namespace pangu {

// v rounded to T on the host
template <typename T> inline float round_host(float v);
template <> inline float round_host<float>(float v) { return v; }
template <> inline float round_host<bf16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// one (window, type, head): base offsets of q (k and v follow at heads*hd*N
// strides) and of the output slice
struct SdpaIdx {
  long long q, out;
};

__device__ __forceinline__ SdpaIdx sdpa_idx(long long w, int t, int h,
                                            int ntype, int heads, int hd,
                                            int N) {
  const long long wt = w * ntype + t;
  return SdpaIdx{((wt * 3) * heads + h) * (long long)hd * N,
                 (wt * heads + h) * (long long)hd * N};
}

// float32 (N, hd + 1) tiles of one (window, head): qs = round_T(q * round_T
// (scale)), and optionally the raw q, k, v; src is (hd, N), so the reads are
// coalesced along N
template <typename T>
__device__ __forceinline__ void load_qkv(const T* __restrict__ qkv,
                                         long long q0, long long kv_stride,
                                         float* qs, float* qr, float* k,
                                         float* v, int N, int hd,
                                         float scale_t) {
  const int ld = hd + 1;
  for (int idx = threadIdx.x; idx < N * hd; idx += blockDim.x) {
    const int d = idx / N, t = idx % N;
    const long long o = q0 + (long long)d * N + t;
    const float q = to_f(qkv[o]);
    qs[t * ld + d] = round_t<T>(q * scale_t);
    if (qr) qr[t * ld + d] = q;
    k[t * ld + d] = to_f(qkv[o + kv_stride]);
    v[t * ld + d] = to_f(qkv[o + 2 * kv_stride]);
  }
}

template <typename T>
__global__ void __launch_bounds__(32 * ATT_WARPS)
sdpa_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
            T* __restrict__ out, int ntype, int heads, int hd, int N,
            float scale_t) {
  extern __shared__ float sm[];
  const int ld = hd + 1;
  float* q = sm;
  float* k = q + N * ld;
  float* v = k + N * ld;
  float* prow = v + N * ld;  // one row of N probabilities per warp
  const long long w = blockIdx.x / ntype;
  const int t = (int)(blockIdx.x % ntype), h = blockIdx.y;
  const SdpaIdx ix = sdpa_idx(w, t, h, ntype, heads, hd, N);
  load_qkv<T>(qkv, ix.q, (long long)heads * hd * N, q, nullptr, k, v, N, hd,
              scale_t);
  __syncthreads();

  const float* btab = bias + ((long long)t * heads + h) * N * N;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;
  float* pr = prow + warp * N;
  for (int i = warp; i < N; i += nwarps) {
    float p[ATT_MAXJ];
    prob_row(q, k, ld, i, N, hd, btab, (const int*)nullptr, 1.f, p);
#pragma unroll
    for (int jj = 0; jj < ATT_MAXJ; ++jj) {
      const int j = lane + 32 * jj;
      if (j < N) pr[j] = round_t<T>(p[jj]);
    }
    __syncwarp();  // P written; every lane is done reading q[i]
    for (int d = lane; d < hd; d += 32) {
      float o = 0.f;
      for (int j = 0; j < N; ++j) o = fmaf(pr[j], v[j * ld + d], o);
      q[i * ld + d] = round_t<T>(o);
    }
    __syncwarp();
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < N * hd; idx += blockDim.x) {
    const int d = idx / N, i = idx % N;
    out[ix.out + (long long)d * N + i] = from_f<T>(q[i * ld + d]);
  }
}

__host__ __device__ inline size_t sdpa_bwd_smem(int N, int hd) {
  return (size_t)(6 * N * (hd + 1) + N * N) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(32 * BATT_WARPS)
sdpa_bwd_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                const T* __restrict__ g, T* __restrict__ dqkv,
                float* __restrict__ dbias, int nwin, int ntype, int heads,
                int hd, int N, float scale, float scale_t) {
  extern __shared__ float sm[];
  const int ld = hd + 1;
  float* qs = sm;
  float* qr = qs + N * ld;
  float* k = qr + N * ld;
  float* v = k + N * ld;
  float* dO = v + N * ld;
  float* acc = dO + N * ld;  // dQ before it is written
  float* S = acc + N * ld;
  const int t = blockIdx.x, h = blockIdx.y;
  const float* btab = bias + ((long long)t * heads + h) * N * N;
  float* dtab = dbias + ((long long)t * heads + h) * N * N;
  const long long kv_stride = (long long)heads * hd * N;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;

  for (int w = 0; w < nwin; ++w) {
    const SdpaIdx ix = sdpa_idx(w, t, h, ntype, heads, hd, N);
    __syncthreads();  // the previous window's shared memory is read
    load_qkv<T>(qkv, ix.q, kv_stride, qs, qr, k, v, N, hd, scale_t);
    for (int idx = threadIdx.x; idx < N * hd; idx += blockDim.x) {
      const int d = idx / N, i = idx % N;
      dO[i * ld + d] = to_f(g[ix.out + (long long)d * N + i]);
    }
    __syncthreads();

    // rows: dS into S (rounded) and the bias gradient (unrounded), then
    // dQ[i, d] = scale sum_j dS[i, j] K[j, d] into acc
    for (int i = warp; i < N; i += nwarps) {
      float p[ATT_MAXJ], dp[ATT_MAXJ];
      prob_row(qs, k, ld, i, N, hd, btab, (const int*)nullptr, 1.f, p);
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < ATT_MAXJ; ++jj) {
        const int j = lane + 32 * jj;
        dp[jj] = 0.f;
        if (j < N) {
          float a = 0.f;
          for (int d = 0; d < hd; ++d) a = fmaf(dO[i * ld + d], v[j * ld + d], a);
          dp[jj] = a;
        }
        rs += dp[jj] * p[jj];
      }
      rs = warp_sum(rs);
#pragma unroll
      for (int jj = 0; jj < ATT_MAXJ; ++jj) {
        const int j = lane + 32 * jj;
        if (j < N) {
          const float ds = p[jj] * (dp[jj] - rs);
          float* e = dtab + (long long)i * N + j;
          *e = w == 0 ? ds : *e + ds;
          S[i * N + j] = round_t<T>(ds);
        }
      }
      __syncwarp();
      for (int d = lane; d < hd; d += 32) {
        float a = 0.f;
        for (int j = 0; j < N; ++j) a = fmaf(S[i * N + j], k[j * ld + d], a);
        acc[i * ld + d] = a * scale;
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < N * hd; idx += blockDim.x) {
      const int d = idx / N, i = idx % N;
      dqkv[ix.q + (long long)d * N + i] = from_f<T>(acc[i * ld + d]);
    }
    // dK[d, j] = scale sum_i dS[i, j] q_raw[i, d]
    for (int idx = threadIdx.x; idx < N * hd; idx += blockDim.x) {
      const int d = idx / N, j = idx % N;
      float a = 0.f;
      for (int i = 0; i < N; ++i) a = fmaf(S[i * N + j], qr[i * ld + d], a);
      dqkv[ix.q + kv_stride + (long long)d * N + j] = from_f<T>(a * scale);
    }
    __syncthreads();  // S is read
    // P again, rounded; dV[d, j] = sum_i P[i, j] dO[i, d]
    for (int i = warp; i < N; i += nwarps) {
      float p[ATT_MAXJ];
      prob_row(qs, k, ld, i, N, hd, btab, (const int*)nullptr, 1.f, p);
#pragma unroll
      for (int jj = 0; jj < ATT_MAXJ; ++jj) {
        const int j = lane + 32 * jj;
        if (j < N) S[i * N + j] = round_t<T>(p[jj]);
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < N * hd; idx += blockDim.x) {
      const int d = idx / N, j = idx % N;
      float a = 0.f;
      for (int i = 0; i < N; ++i) a = fmaf(S[i * N + j], dO[i * ld + d], a);
      dqkv[ix.q + 2 * kv_stride + (long long)d * N + j] = from_f<T>(a);
    }
  }
}

template <typename T>
int sdpa(const void* qkv, const void* bias, void* out, int nwin, int ntype,
         int heads, int hd, int N, cudaStream_t st) {
  const size_t smem = attend_smem(N, hd, ATT_WARPS);
  cudaError_t e = cudaFuncSetAttribute(
      sdpa_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((long long)nwin * ntype), heads);
  sdpa_kernel<T><<<grid, 32 * ATT_WARPS, smem, st>>>(
      (const T*)qkv, (const float*)bias, (T*)out, ntype, heads, hd, N,
      round_host<T>(attn_scale(hd)));
  return (int)cudaGetLastError();
}

template <typename T>
int sdpa_bwd(const void* qkv, const void* bias, const void* g, void* dqkv,
             void* dbias, int nwin, int ntype, int heads, int hd, int N,
             cudaStream_t st) {
  const size_t smem = sdpa_bwd_smem(N, hd);
  cudaError_t e = cudaFuncSetAttribute(
      sdpa_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(ntype, heads);
  sdpa_bwd_kernel<T><<<grid, 32 * BATT_WARPS, smem, st>>>(
      (const T*)qkv, (const float*)bias, (const T*)g, (T*)dqkv,
      (float*)dbias, nwin, ntype, heads, hd, N, attn_scale(hd),
      round_host<T>(attn_scale(hd)));
  return (int)cudaGetLastError();
}

}  // namespace pangu

using namespace pangu;

// dtype codes: 0 = float32, 1 = bfloat16 (qkv, out, g, dqkv); bias and dbias
// float32.  Returns a cudaError_t (0 = ok).
extern "C" int pangu_sdpa(int dtype, const void* qkv, const void* bias,
                          void* out, int nwin, int ntype, int heads, int hd,
                          int n, void* stream) {
  if (n > 32 * ATT_MAXJ) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return sdpa<float>(qkv, bias, out, nwin, ntype, heads, hd, n, st);
  if (dtype == 1) return sdpa<bf16>(qkv, bias, out, nwin, ntype, heads, hd, n, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int pangu_sdpa_bwd(int dtype, const void* qkv, const void* bias,
                              const void* g, void* dqkv, void* dbias, int nwin,
                              int ntype, int heads, int hd, int n,
                              void* stream) {
  if (n > 32 * ATT_MAXJ || nwin < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return sdpa_bwd<float>(qkv, bias, g, dqkv, dbias, nwin, ntype, heads, hd, n, st);
  if (dtype == 1)
    return sdpa_bwd<bf16>(qkv, bias, g, dqkv, dbias, nwin, ntype, heads, hd, n, st);
  return (int)cudaErrorInvalidValue;
}
