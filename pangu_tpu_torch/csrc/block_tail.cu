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
// (~0.6 GB).  This first version keeps x1, h and y in device memory and runs
// the untuned GEMM tiles of common.cuh, so it runs well below that bound.
#include "common.cuh"

namespace pangu {

template <typename T>
int block_tail(const void* a_, const void* s_, void* out_, void* ws_,
               const void* n1s, const void* n1b, const void* n2s,
               const void* n2b, const void* w1, const void* b1,
               const void* w2, const void* b2, int M, int C, int hidden,
               int gelu_tanh, cudaStream_t st) {
  // workspace: x1 (M*C) | y (M*C) | h (M*hidden)
  T* x1 = (T*)ws_;
  T* y = x1 + (long long)M * C;
  T* h = y + (long long)M * C;
  const PadRows none = {0};
  ln_rows<T>((const T*)a_, (const T*)s_, x1, (const T*)n1s, (const T*)n1b, M,
             C, st);
  PANGU_CHECK_LAUNCH();
  gemm(x1, (const T*)w1, (const T*)b1, h, M, hidden, C,
       gelu_tanh ? ACT_GELU_TANH : ACT_GELU_ERF, none, st);
  PANGU_CHECK_LAUNCH();
  gemm(h, (const T*)w2, (const T*)b2, y, M, C, hidden, ACT_NONE, none, st);
  PANGU_CHECK_LAUNCH();
  ln_rows<T>(y, x1, (T*)out_, (const T*)n2s, (const T*)n2b, M, C, st);
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
#define PANGU_TAIL(T)                                                          \
  return block_tail<T>(a, s, out, workspace, n1s, n1b, n2s, n2b, w1, b1, w2, \
                       b2, M, C, hidden, gelu_tanh, st)
  if (dtype == 0) PANGU_TAIL(float);
  if (dtype == 1) PANGU_TAIL(bf16);
#undef PANGU_TAIL
  return (int)cudaErrorInvalidValue;
}
