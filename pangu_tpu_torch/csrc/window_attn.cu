// Fused windowed attention on partitioned windows: the qkv projection, the
// windowed softmax with the earth-specific bias and the output projection.
//
// Replaces the Pallas kernel pangu_tpu/ops/window_attention.py::
// _fused_attention_fwd_pallas (kernel body _make_fused_kernel), the forward
// of the public drop-in window_attention_pallas for layers.earth_attention.
// Layouts as the drop-in takes them:
//   x, out  (nwin, ntype, N, C) in T, windows lon-major: window row
//           w * ntype + t is window type t (the partition's order, not the
//           type-major order of window-major storage);
//   bias    (ntype, heads, N, N) float32, the shifted-window mask folded in
//           by the caller (-100 between regions);
//   weights Wqkv (C, 3C), bqkv (3C), Wp (C, C), bp (C) in T.
//
// A sequence of launches on the caller's stream, rounding where the Pallas
// body rounds:
//   GEMM       qkv = round_T(x Wqkv + bqkv): per head, q, k and v rounded
//              after their bias (every column is its own sum, so one product
//              over all heads gives the per-head values)
//   attention  per (window, head) (block_common.cuh's window_attend with
//              kScaleQ): q scaled in T, round_T(q * round_T(hd^-1/2));
//              s = q.k + bias[t, h] in float32, softmax in float32, P
//              rounded to T, o = round_T(P.V)
//   GEMM       out = round_T(o Wp + bp): the per-head proj products summed
//              in float32 with the bias, rounded once
// The TPU kernel keeps qkv and o in VMEM (it reads x once and writes y
// once); this first version keeps them in device memory (4 C values a row).
//
// What bounds it on an H100: arithmetic, 2 M C (4C + 2N) FLOP for M rows
// (0.22 ms in bf16 at stage 0, 30 x 124 windows of 144 tokens at C = 192)
// against reading x and the bias and writing out (~0.47 GB, 0.14 ms).  The
// untuned GEMM tiles of common.cuh and the one-warp-per-query attention loop
// of the block kernel run it well below that bound.
#include "block_common.cuh"

namespace pangu {

// one thread block per (window, head); type = window % ntype
template <typename T>
__global__ void __launch_bounds__(32 * ATT_WARPS)
fused_attn_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                  const float* __restrict__ bias, int N, int C, int heads,
                  int hd, int ntype, float scale_t) {
  extern __shared__ float sm[];
  const long long win = blockIdx.x;
  const int h = blockIdx.y;
  const int type = (int)(win % ntype);
  window_attend<T, float, true>(qkv, out, win * N, h,
                                bias + ((long long)type * heads + h) * N * N,
                                nullptr, sm, N, C, hd, scale_t);
}

// hd^-1/2 rounded to T on the host (the Pallas body's jnp.asarray(scale, dt))
inline float q_scale(int hd, int bf16_dtype) {
  const float s = (float)pow((double)hd, -0.5);
  return bf16_dtype ? __bfloat162float(__float2bfloat16(s)) : s;
}

template <typename T>
int window_attn(const T* x, T* out, T* ws, const T* wqkv, const T* bqkv,
                const T* wp, const T* bp, const float* bias, long long nwin,
                int ntype, int N, int C, int heads, float scale_t,
                cudaStream_t st) {
  const long long M = nwin * ntype * N;
  // workspace: qkv (3C) | o (C)
  T* qkv = ws;
  T* attn = qkv + M * 3 * C;
  const PadRows none = {0};
  const int hd = C / heads;

  gemm(x, wqkv, bqkv, qkv, (int)M, 3 * C, C, ACT_NONE, none, st);
  PANGU_CHECK_LAUNCH();
  const size_t smem = attend_smem(N, hd, ATT_WARPS);
  cudaError_t e = cudaFuncSetAttribute(fused_attn_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)(nwin * ntype), heads);
  fused_attn_kernel<T><<<grid, 32 * ATT_WARPS, smem, st>>>(
      qkv, attn, bias, N, C, heads, hd, ntype, scale_t);
  PANGU_CHECK_LAUNCH();
  gemm(attn, wp, bp, out, (int)M, C, C, ACT_NONE, none, st);
  PANGU_CHECK_LAUNCH();
  return 0;
}

}  // namespace pangu

using namespace pangu;

// T elements of workspace the entry below needs for ``rows`` window rows
extern "C" long long pangu_window_attn_ws(long long rows, int C) {
  return rows * 4LL * C;
}

// dtype codes: 0 = float32, 1 = bfloat16 (x, out, the weights); bias is
// float32.  Returns a cudaError_t (0 = ok).
extern "C" int pangu_window_attn(int dtype, const void* x, void* out, void* ws,
                                 const void* wqkv, const void* bqkv,
                                 const void* wp, const void* bp,
                                 const void* bias, int nwin, int ntype, int n,
                                 int C, int heads, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n > 32 * ATT_MAXJ || heads < 1 || C % heads != 0)
    return (int)cudaErrorInvalidValue;
  const float scale_t = q_scale(C / heads, dtype == 1);
#define PANGU_WATTN(T)                                                         \
  return window_attn<T>((const T*)x, (T*)out, (T*)ws, (const T*)wqkv,         \
                        (const T*)bqkv, (const T*)wp, (const T*)bp,           \
                        (const float*)bias, nwin, ntype, n, C, heads,         \
                        scale_t, st)
  if (dtype == 0) PANGU_WATTN(float);
  if (dtype == 1) PANGU_WATTN(bf16);
#undef PANGU_WATTN
  return (int)cudaErrorInvalidValue;
}
