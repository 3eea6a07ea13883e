// Windowed attention on the (B, Z, Hp, W, C) token grid, forward and
// backward, with its qkv and output projections.
//
// Replaces the Pallas kernels pangu_tpu/ops/window_attention.py::
// _grid_attention_pallas (kernel body _make_grid_kernel) and
// ::_grid_attention_bwd_pallas (_make_grid_bwd_kernel), which the
// rolled-coordinate training block (earth_block_fused.py::
// _block_v2_train_core, through _grid_core) recomputes and differentiates.
// The caller has already rolled the grid into the block's window coordinates
// and zeroed its latitude-pad rows, so window (zz, hh, l) is the grid's
// rows wz*zz.., wh*hh.., ww*l.. as they stand, and type = zz*nlat + hh.
//
// Forward, a sequence of launches on the caller's stream:
//   gather     xg = the grid's rows in window-major order
//   GEMM       qkv = round_T(xg @ Wqkv + bqkv)
//   attention  per (window, head), as the block kernel (block_common.cuh):
//              softmax(q.k hd^-1/2 + bias[type, h] (+ -100 where region
//              ids differ)) in float32, probabilities rounded to T before P.V
//   GEMM       out = round_T(attn @ Wp + bp), each row written to its place
//              in the grid
//
// Backward, the Pallas body's rounding points (window_attention.py:558-674):
//   recompute  xg, gg (the cotangent's rows), qkv and attn as above
//   proj       dWp, dbp = sums over rows of attn^T g, g (float32);
//              da = round_T(g Wp^T)
//   attention  per (window type, head) (attn_bwd.cuh): P recomputed in
//              float32; dV = round_T(round_T(P)^T dO); dS = P o (dP -
//              rowsum(dP o P)), dP = dO V^T, summed unrounded into
//              dtable[type, h]; dQ, dK = round_T(round_T(dS) K, Q hd^-1/2)
//   qkv        dWqkv, dbqkv = sums of xg^T dqkv, dqkv (float32);
//              dx = round_T(dqkv Wqkv^T), to the grid
// The weight and bias gradients are deterministic split-K sums over every
// window of the batch (the bias as a row of ones); each table entry has one
// owner thread block; no atomics, so the gradients are the same bit for bit
// in every run.
//
// What bounds it on an H100: bytes, about 2 M C (4C + 2N) FLOP forward (M
// rows, N = 144 tokens a window) and three times that backward, against
// reading and writing the grid and the intermediates (5 C values a row
// forward, 10 C backward) at ~140 FLOP per byte.  bf16 (the perf config):
// every product on the tensor cores (mma_gemm.cuh; the forward's qkv
// product through fwd_gemm, as the block kernel's), the attention forward,
// recomputed forward and backward too (wattn_mma.cuh, one block of nine
// warps per (type, head)), the gathers of x 16 bytes a lane
// (block_common.cuh).  float32 (the parity config): the first version's
// kernels (common.cuh's gemm, grad_gemm.cuh's FMA tiles, the CUDA-core
// attention of block_common.cuh and attn_bwd.cuh), so its outputs stay
// the same bit for bit.
#include "mma_gemm.cuh"
#include "wattn_mma.cuh"

namespace pangu {

// the grid's rows in window-major order: no shift, no pad rows synthesised
inline BlockShift no_shift(const WmShape& s) {
  return BlockShift{0, 0, 0, 0, s.nlat * s.wh};
}

// T workspace elements of the forward (which = 0), of the backward (1), and
// float32 elements of the backward (2)
inline long long grid_ws_elems(long long M, int C, int which) {
  if (which == 0) return M * 5LL * C;
  if (which == 1) return M * 10LL * C;
  return wg_splits(M) * (long long)(C + 1) * 3 * C;
}

// qkv = round_T(xg Wqkv + bqkv), xg the grid's rows in window-major order
template <typename T>
int grid_qkv(const T* x, T* xg, T* qkv, const T* wqkv, const T* bqkv,
             long long M, const WmShape& s, int C, cudaStream_t st) {
  block_gather<T>(x, xg, M, C, s, no_shift(s), 1, st);
  PANGU_CHECK_LAUNCH();
  return fwd_gemm(xg, wqkv, bqkv, qkv, M, 3 * C, C, ACT_NONE, st);
}

template <typename T, typename TB>
int grid_attn(const T* x, T* out, T* ws, const T* wqkv, const T* bqkv,
              const T* wp, const T* bp, const TB* table, const int* ids, int B,
              WmShape s, int C, int heads, cudaStream_t st) {
  const long long M = (long long)B * s.nz * s.nlat * s.nlon * s.n;
  // workspace: xg (C) | qkv (3C) | attn (C)
  T* xg = ws;
  T* qkv = xg + M * C;
  T* attn = qkv + M * 3 * C;

  int e = grid_qkv(x, xg, qkv, wqkv, bqkv, M, s, C, st);
  if (e) return e;
  e = unit_attention<T, TB>(qkv, attn, table, ids, B, s, C, heads, st);
  if (e) return e;
  return unit_gemm<false>(attn, wp, M, C, C,
                          GridEpi<T>{bp, out, C, RowMap{1, s}}, st);
}

template <typename T, typename TB>
int grid_attn_bwd(const T* x, const T* g, T* dx, T* ws, float* part,
                  const T* wqkv, const T* bqkv, const T* wp, const TB* table,
                  const int* ids, float* dwqkv, float* dwp, float* dtable,
                  int B, WmShape s, int C, int heads, cudaStream_t st) {
  const long long M = (long long)B * s.nz * s.nlat * s.nlon * s.n;
  // workspace: xg gg (C) | qkv (3C) | attn da (C) | dqkv (3C)
  T* xg = ws;
  T* gg = xg + M * C;
  T* qkv = gg + M * C;
  T* attn = qkv + M * 3 * C;
  T* da = attn + M * C;
  T* dqkv = da + M * C;

  // ---- recompute ----
  int e = grid_qkv(x, xg, qkv, wqkv, bqkv, M, s, C, st);
  if (e) return e;
  block_gather_kernel<T><<<row_blocks(M), 256, 0, st>>>(g, gg, M, C, s,
                                                        no_shift(s), 1);
  PANGU_CHECK_LAUNCH();
  e = unit_attention<T, TB>(qkv, attn, table, ids, B, s, C, heads, st);
  if (e) return e;

  // ---- proj ----
  e = unit_wgrad(attn, C, gg, C, M, part, dwp, st);
  if (e) return e;
  e = unit_gemm<true>(gg, wp, M, C, C, RoundEpi<T>{da, C}, st);
  if (e) return e;

  // ---- attention ----
  e = unit_attention_bwd<T, TB>(qkv, da, dqkv, table, ids, dtable, B, s, C,
                                heads, st);
  if (e) return e;

  // ---- qkv ----
  e = unit_wgrad(xg, C, dqkv, 3 * C, M, part, dwqkv, st);
  if (e) return e;
  return unit_gemm<true>(dqkv, wqkv, M, C, 3 * C,
                         GridEpi<T>{nullptr, dx, C, RowMap{1, s}}, st);
}

// The file builds as three objects compiled in parallel (_build.PARTS):
// with GRID_ATTN_PART 1 only the bf16 instantiations of the forward, with
// GRID_ATTN_PART 2 those of the backward (the tensor-core route, most of
// the file's compile time), with GRID_ATTN_PART 0 everything else, the
// entries calling the bf16 ones across the objects.  Without
// GRID_ATTN_PART it builds whole.
#define PANGU_GRID_FWD_INSTANCE(T, TB)                                         \
  int grid_attn<T, TB>(const T*, T*, T*, const T*, const T*, const T*,         \
                       const T*, const TB*, const int*, int, WmShape, int,     \
                       int, cudaStream_t)
#define PANGU_GRID_BWD_INSTANCE(T, TB)                                         \
  int grid_attn_bwd<T, TB>(const T*, const T*, T*, T*, float*, const T*,       \
                           const T*, const T*, const TB*, const int*, float*,  \
                           float*, float*, int, WmShape, int, int,             \
                           cudaStream_t)
#if defined(GRID_ATTN_PART) && GRID_ATTN_PART == 0
extern template PANGU_GRID_FWD_INSTANCE(bf16, float);
extern template PANGU_GRID_FWD_INSTANCE(bf16, bf16);
extern template PANGU_GRID_BWD_INSTANCE(bf16, float);
extern template PANGU_GRID_BWD_INSTANCE(bf16, bf16);
#elif defined(GRID_ATTN_PART) && GRID_ATTN_PART == 1
template PANGU_GRID_FWD_INSTANCE(bf16, float);
template PANGU_GRID_FWD_INSTANCE(bf16, bf16);
#elif defined(GRID_ATTN_PART) && GRID_ATTN_PART == 2
template PANGU_GRID_BWD_INSTANCE(bf16, float);
template PANGU_GRID_BWD_INSTANCE(bf16, bf16);
#endif
#undef PANGU_GRID_FWD_INSTANCE
#undef PANGU_GRID_BWD_INSTANCE

}  // namespace pangu

using namespace pangu;

#if !defined(GRID_ATTN_PART) || GRID_ATTN_PART == 0

// Workspace the entries below need for ``rows`` grid rows: T elements of the
// forward (which = 0), of the backward (1), float32 elements of the
// backward (2).
extern "C" long long pangu_grid_attn_ws(long long rows, int C, int which) {
  return grid_ws_elems(rows, C, which);
}

// dtype codes: 0 = float32, 1 = bfloat16.  x, out: (B, Z, Hp, W, C) grids;
// table (ntype, heads, n, n) in its own dtype; ids (ntype, n) int32 region
// ids or null.  Returns a cudaError_t (0 = ok).
extern "C" int pangu_grid_attn(int dtype, int table_dtype, const void* x,
                               void* out, void* ws, const void* wqkv,
                               const void* bqkv, const void* wp,
                               const void* bp, const void* table,
                               const void* ids, int B, int nz, int nlat,
                               int nlon, int n, int C, int heads, int wz,
                               int wh, int ww, void* stream) {
  WmShape s = {nz, nlat, nlon, n, wz, wh, ww};
  cudaStream_t st = (cudaStream_t)stream;
  // bf16: the tensor-core tiles and the 16-byte gather take 8-column
  // groups, 16-byte aligned operands and windows of at most 144 tokens
  if (n > 32 * ATT_MAXJ || C % heads != 0 ||
      (dtype == 1 && (C % 8 || pad16(n) > 16 * WA_KT ||
                      !aligned16_all({x, out, ws, wqkv, wp}))))
    return (int)cudaErrorInvalidValue;
#define PANGU_GRID(T, TB)                                                      \
  return grid_attn<T, TB>((const T*)x, (T*)out, (T*)ws, (const T*)wqkv,       \
                          (const T*)bqkv, (const T*)wp, (const T*)bp,         \
                          (const TB*)table, (const int*)ids, B, s, C, heads,  \
                          st)
  if (dtype == 0 && table_dtype == 0) PANGU_GRID(float, float);
  if (dtype == 0 && table_dtype == 1) PANGU_GRID(float, bf16);
  if (dtype == 1 && table_dtype == 0) PANGU_GRID(bf16, float);
  if (dtype == 1 && table_dtype == 1) PANGU_GRID(bf16, bf16);
#undef PANGU_GRID
  return (int)cudaErrorInvalidValue;
}

// Outputs: dx (the grid, x's dtype), and float32 dwqkv (C+1, 3C), dwp
// (C+1, C) -- the last row the bias gradient -- and dtable (ntype, heads, n,
// n).  g: the cotangent of the forward's output, a grid in x's dtype.
extern "C" int pangu_grid_attn_bwd(
    int dtype, int table_dtype, const void* x, const void* g, void* dx,
    void* ws, void* wsf, const void* wqkv, const void* bqkv, const void* wp,
    const void* table, const void* ids, void* dwqkv, void* dwp, void* dtable,
    int B, int nz, int nlat, int nlon, int n, int C, int heads, int wz, int wh,
    int ww, void* stream) {
  WmShape s = {nz, nlat, nlon, n, wz, wh, ww};
  cudaStream_t st = (cudaStream_t)stream;
  // bf16: the tensor-core tiles and the 16-byte gather take 8-column
  // groups, 16-byte aligned operands and windows of at most 144 tokens
  if (n > 32 * ATT_MAXJ || C % heads != 0 ||
      (dtype == 1 && (C % 8 || pad16(n) > 16 * WA_KT ||
                      !aligned16_all({x, dx, ws, wqkv, wp}))))
    return (int)cudaErrorInvalidValue;
#define PANGU_GRID_BWD(T, TB)                                                  \
  return grid_attn_bwd<T, TB>(                                                 \
      (const T*)x, (const T*)g, (T*)dx, (T*)ws, (float*)wsf, (const T*)wqkv,   \
      (const T*)bqkv, (const T*)wp, (const TB*)table, (const int*)ids,         \
      (float*)dwqkv, (float*)dwp, (float*)dtable, B, s, C, heads, st)
  if (dtype == 0 && table_dtype == 0) PANGU_GRID_BWD(float, float);
  if (dtype == 0 && table_dtype == 1) PANGU_GRID_BWD(float, bf16);
  if (dtype == 1 && table_dtype == 0) PANGU_GRID_BWD(bf16, float);
  if (dtype == 1 && table_dtype == 1) PANGU_GRID_BWD(bf16, bf16);
#undef PANGU_GRID_BWD
  return (int)cudaErrorInvalidValue;
}
#endif  // GRID_ATTN_PART 0
