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
// once); here they stay in device memory (4 C values a row), as in the
// grid attention (grid_attn.cu), which computes the same three steps.
//
// What bounds it on an H100: arithmetic, 2 M C (4C + 2N) FLOP for M rows
// (0.22 ms in bf16 at stage 0, 30 x 124 windows of 144 tokens at C = 192)
// against reading x and the bias and writing out (~0.47 GB, 0.14 ms).
//
// bf16 (the perf config) runs the grid attention forward's plan without its
// gather (the windows come partitioned): the qkv product on mma_gemm.cuh
// (128 x 96 mma.sync tiles) whose epilogue (QScaleEpi) adds the bias in
// float32, rounds once and, on q's C columns, multiplies by the rounded
// scale and rounds again; wattn_mma.cuh's tensor-core attention with its
// logit scale 1 (q is scaled already), one block of nine warps per
// (window type, head) walking the windows of that type (window w of type t
// starts at row (w ntype + t) N: wa_base with nz = nlon = 1, nlat =
// ntype), the float32 folded bias as its table and no region ids; the proj
// product on mma_gemm.cuh with the bias in float32 and one rounding
// (fwd_gemm: the Pallas body's per-head float32 sums plus bp, in another
// order).  So the bf16 route takes C a multiple of 8, windows of at most
// 144 tokens and 16-byte aligned x, out, workspace and weights (the entry
// refuses the rest; the wrapper checks first); any head dim (the attention
// copies a head dim off 8 element by element).  float32 (the parity
// config) keeps the first version: common.cuh's gemm and the one-warp-per-
// query attention of block_common.cuh (window_attend, kScaleQ).
#include "mma_gemm.cuh"
#include "wattn_mma.cuh"

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

// the float32 route (the first version; bf16 runs window_attn_bf16)
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

// ---- the bf16 route -------------------------------------------------------

// qkv = round_bf16(acc + bias); on q's C columns, then round_bf16(q *
// scale_t): the Pallas body's rounding of q after its bias, then q times
// the scale in the dtype (two bf16 values multiply exactly in float32, so
// one more rounding gives the bf16 product)
struct QScaleEpi {
  const bf16* bias;
  bf16* out;
  int N, C;
  float scale_t;
  __device__ void operator()(int, long long r, int c,
                             const float (&v)[8]) const {
    float o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = v[e] + to_f(bias[c + e]);
    if (c < C)   // 8-column groups: C % 8 == 0, so a group is q's or not
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = round_t<bf16>(o[e]) * scale_t;
    st8(out + r * N + c, o);
  }
};

int window_attn_bf16(const bf16* x, bf16* out, bf16* ws, const bf16* wqkv,
                     const bf16* bqkv, const bf16* wp, const bf16* bp,
                     const float* bias, int nwin, int ntype, int N, int C,
                     int heads, float scale_t, cudaStream_t st);

// The file builds as two objects compiled in parallel (_build.PARTS): with
// WINDOW_ATTN_PART 1 only window_attn_bf16 (the tensor-core products and
// attention, most of the file's compile time), with WINDOW_ATTN_PART 0
// everything else, the entry calling it across the objects.  Without
// WINDOW_ATTN_PART it builds whole.
#if !defined(WINDOW_ATTN_PART) || WINDOW_ATTN_PART == 1
int window_attn_bf16(const bf16* x, bf16* out, bf16* ws, const bf16* wqkv,
                     const bf16* bqkv, const bf16* wp, const bf16* bp,
                     const float* bias, int nwin, int ntype, int N, int C,
                     int heads, float scale_t, cudaStream_t st) {
  const long long M = (long long)nwin * ntype * N;
  // workspace: qkv (3C) | o (C)
  bf16* qkv = ws;
  bf16* attn = qkv + M * 3 * C;
  int e = (int)mma_gemm<false>(x, wqkv, M, 3 * C, C,
                               QScaleEpi{bqkv, qkv, 3 * C, C, scale_t}, st);
  if (e) return e;
  // window w of type t: sample w, lat window t of a (1, ntype, 1) grid
  const WmShape s = {1, ntype, 1, N, 1, 1, N};
  e = wa_attention<float>(qkv, attn, bias, nullptr, nwin, s, C, heads, st,
                          1.f);
  if (e) return e;
  return fwd_gemm(attn, wp, bp, out, M, C, C, ACT_NONE, st);
}
#endif

}  // namespace pangu

using namespace pangu;

#if !defined(WINDOW_ATTN_PART) || WINDOW_ATTN_PART == 0

// T elements of workspace the entry below needs for ``rows`` window rows
extern "C" long long pangu_window_attn_ws(long long rows, int C) {
  return rows * 4LL * C;
}

// dtype codes: 0 = float32, 1 = bfloat16 (x, out, the weights); bias is
// float32.  Returns a cudaError_t (0 = ok; cudaErrorInvalidValue for a
// window of more than 256 tokens and, in bf16, for a C that is not a
// multiple of 8, a window of more than 144 tokens or an operand off a
// 16-byte boundary).
extern "C" int pangu_window_attn(int dtype, const void* x, void* out, void* ws,
                                 const void* wqkv, const void* bqkv,
                                 const void* wp, const void* bp,
                                 const void* bias, int nwin, int ntype, int n,
                                 int C, int heads, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n > 32 * ATT_MAXJ || heads < 1 || C % heads != 0)
    return (int)cudaErrorInvalidValue;
  const float scale_t = q_scale(C / heads, dtype == 1);
  if (dtype == 0)
    return window_attn<float>((const float*)x, (float*)out, (float*)ws,
                              (const float*)wqkv, (const float*)bqkv,
                              (const float*)wp, (const float*)bp,
                              (const float*)bias, nwin, ntype, n, C, heads,
                              scale_t, st);
  // bf16: the tensor-core tiles take 8-column groups, 16-byte aligned
  // operands and windows of at most 144 tokens
  if (dtype != 1 || C % 8 || pad16(n) > 16 * WA_KT ||
      !aligned16_all({x, out, ws, wqkv, wp}))
    return (int)cudaErrorInvalidValue;
  return window_attn_bf16((const bf16*)x, (bf16*)out, (bf16*)ws,
                          (const bf16*)wqkv, (const bf16*)bqkv,
                          (const bf16*)wp, (const bf16*)bp,
                          (const float*)bias, nwin, ntype, n, C, heads,
                          scale_t, st);
}
#endif  // WINDOW_ATTN_PART 0
