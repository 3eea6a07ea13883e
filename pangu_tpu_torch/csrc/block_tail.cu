// The Earth-specific block's tail on a (tokens, C) matrix:
//   x1 = s + LN1(a);  out = x1 + LN2(fc2(GELU(fc1 x1)))
//
// Replaces the Pallas kernel pangu_tpu/ops/block_tail.py::fused_block_tail
// (kernel body _make_tail_kernel, math tail_math), which the per-block path
// (layers.py::earth_block) runs after a shifted block's grid attention or an
// attention with LoRA leaves.  a (the attention branch, cropped) and s (the
// block input) are token-local, so the rows need no layout; the Pallas
// kernel's padding of the tokens to 2048-row programs has no counterpart.
//
// The unit is the tail of the block kernel (block_wm.cu, steps 5-8), four
// launches on the caller's stream with its rounding points:
//   LN       x1 = round_T(s + round_T(LN1(a)))
//   GEMM     h = round_T(GELU(round_T(x1 @ W1 + b1)))   (erf or tanh)
//   GEMM     y = round_T(h @ W2 + b2)
//   LN       out = round_T(x1 + round_T(LN2(y)))
//
// What bounds it on an H100: arithmetic, 4 rows C hidden FLOP (~3.1e11 at
// stage 0 in bf16, 0.31 ms) against reading a and s and writing out
// (~0.6 GB).  The unit keeps x1, h and y in device memory (2 C + hidden
// values a row, written once and read again), so each launch is bound by
// its own bytes.  bf16 (the perf config) runs the block kernel's forward
// route: both products through mma_gemm.cuh's fwd_gemm (128 x 96 mma.sync
// tiles, a 3-stage cp.async ring, 8-column epilogues of 16-byte accesses:
// ZhEpi writing h only for fc1, BiasEpi for fc2), both LayerNorm passes
// through block_common.cuh's block_ln (16 bytes a lane).  So the bf16 route
// takes C and hidden multiples of 8 and 16-byte aligned operands (the
// wrapper checks, and the C entry refuses the rest).  float32 (the parity
// config) keeps the first version's kernels, common.cuh's FMA gemm and
// ln_rows, through the same dispatches: its outputs are the same bit for bit.
#include "mma_gemm.cuh"

namespace pangu {

template <typename T>
int block_tail(const T* a, const T* s, T* out, T* ws, const T* n1s,
               const T* n1b, const T* n2s, const T* n2b, const T* w1,
               const T* b1, const T* w2, const T* b2, long long M, int C,
               int hidden, int gelu_tanh, cudaStream_t st) {
  // workspace: x1 (M*C) | y (M*C) | h (M*hidden)
  T* x1 = ws;
  T* y = x1 + M * C;
  T* h = y + M * C;
  block_ln<T>(a, s, x1, n1s, n1b, M, C, st, RowMap{}, nullptr, 0, M);
  PANGU_CHECK_LAUNCH();
  int e = fwd_gemm(x1, w1, b1, h, M, hidden, C,
                   gelu_tanh ? ACT_GELU_TANH : ACT_GELU_ERF, st);
  if (e) return e;
  e = fwd_gemm(h, w2, b2, y, M, C, hidden, ACT_NONE, st);
  if (e) return e;
  block_ln<T>(y, x1, out, n2s, n2b, M, C, st, RowMap{}, nullptr, 1, M);
  PANGU_CHECK_LAUNCH();
  return 0;
}

}  // namespace pangu

using namespace pangu;

// dtype codes: 0 = float32, 1 = bfloat16 (every operand).  a, s, out: (M, C)
// row-major; workspace M * (2C + hidden) elements.  Returns a cudaError_t
// (0 = ok).
extern "C" int pangu_block_tail(int dtype, const void* a, const void* s,
                                void* out, void* workspace, const void* n1s,
                                const void* n1b, const void* n2s,
                                const void* n2b, const void* w1,
                                const void* b1, const void* w2, const void* b2,
                                int M, int C, int hidden, int gelu_tanh,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (M < 1) return (int)cudaErrorInvalidValue;
  // bf16: the tensor-core tiles and the 16-byte row passes take 8-column
  // groups and 16-byte aligned operands
  if (dtype == 1 && (C % 8 || hidden % 8 ||
                     !aligned16_all({a, s, out, workspace, w1, w2})))
    return (int)cudaErrorInvalidValue;
#define PANGU_TAIL(T)                                                          \
  return block_tail<T>((const T*)a, (const T*)s, (T*)out, (T*)workspace,     \
                       (const T*)n1s, (const T*)n1b, (const T*)n2s,          \
                       (const T*)n2b, (const T*)w1, (const T*)b1,            \
                       (const T*)w2, (const T*)b2, M, C, hidden, gelu_tanh,  \
                       st)
  if (dtype == 0) PANGU_TAIL(float);
  if (dtype == 1) PANGU_TAIL(bf16);
#undef PANGU_TAIL
  return (int)cudaErrorInvalidValue;
}
