// One whole Earth-specific transformer block on window-major storage.
//
// Replaces the Pallas kernels pangu_tpu/ops/earth_block_wm.py::_block_wm_call
// (kernel body _make_wm_kernel) in its three layouts -- wm -> wm, and the
// stage end-points that read (in_layout="canon") or write
// (out_layout="canon") the canonical (B, Z, Hp, W, C) token grid -- and
// ::_block_wm_group_call (_make_wm_group_kernel), the same block with gh
// latitude windows per program.  Storage is (B, nz, nlat, nlon, N, C) with
// N = wz*wh*ww tokens per window.  Window token (rz, rh, rw) of window
// (zz, hh, l) reads storage token
//   (wz*zz + rz + dz, wh*hh + rh + dh, ww*l + rw + dw), each modulo its extent,
// and the block writes its output in its own window coordinates.  On the TPU
// that shift is a four-chunk BlockSpec stitch plus sublane rolls; here it is
// pointer arithmetic in the gather.
//
// The unit is a short sequence of launches on the caller's stream:
//   1. gather   xg = x at the shifted window coordinates, latitude-pad rows
//               zeroed by their canonical latitude (wh*hh + rh + canon_add) % hp;
//               a canonical input is read at the same coordinates in the
//               (B, Z, Hp, W) grid (the window relayout is this gather)
//   2. GEMM     qkv = round_T(xg @ Wqkv + bqkv)
//   3. attention per (window, head): softmax(q.k * hd^-1/2 + bias[type, h]
//               (+ -100 where region ids differ, shifted blocks)) in float32,
//               probabilities rounded to T before P.V; type = zz*nlat + hh
//   4. GEMM     a = round_T(attn @ Wp + bp)
//   5. LN       x1 = round_T(xg + round_T(LN1(a)))
//               (training, with per-sample branch scales s1, s2 from a
//               (B, 2) float32 ``drop``: x1 = round_T(xg +
//               round_T(round_T(LN1(a)) * round_T(s1))), and likewise s2 in
//               step 8; a null ``drop`` is the served block)
//   6. GEMM     h = round_T(GELU(round_T(x1 @ W1 + b1)))   (erf or tanh)
//   7. GEMM     y = round_T(h @ W2 + b2)
//   8. LN       out = round_T(x1 + round_T(LN2(y))); a canonical output row
//               goes to its token's place in the (B, Z, Hp, W) grid, in the
//               block's own window coordinates (the stage rolls back once)
//
// The grouped block differs only in step 3, and only in float32.  On the
// TPU, gh latitude windows per program amortise the weight and bias-table
// streams into VMEM; here the GEMMs already run over all rows, so grouping
// matters only in the attention.  float32: one thread block per (sample, z
// window, group of gh lat windows, head) stages each window type's (N, N)
// bias slice (and region ids) in shared memory once and loops over the
// group's gh * nlon windows.  bf16: the tensor-core attention already
// stages each (type, head) slice once for all B x nlon windows of the type,
// which is what gh was for, so gh no longer changes the launch; the C entry
// still checks nlat % gh, and block_wm_group still counts its launches.
//
// What bounds it on an H100: arithmetic.  A stage-0 block at full width does
// ~5.3e11 FLOP against ~0.45 GB of traffic (x in, out, the bias table), far
// above the card's ~295 FLOP/byte balance point in bf16; but the unit
// keeps every intermediate in device memory (about 10 C + 2 hidden values a
// row written and read again), and each launch is bound by its own bytes.
// bf16 (the perf config): the four products on the tensor cores through
// mma_gemm.cuh's fwd_gemm (128 x 96 tiles, a 3-stage cp.async ring,
// ldmatrix and mma.sync, 8-column epilogues of 16-byte accesses: BiasEpi,
// and ZhEpi writing h only for fc1); the attention through wattn_mma.cuh's
// wa_attention (one block of nine warps of 16 query rows per (type, head),
// the table slice and a region-id bit mask staged once per block, P kept
// in registers and rounded to bf16 as the A operand of P.V; one tile
// buffer: against two, measured at full width on the H100, its attention
// ran 1.555-1.571 ms against 1.581-1.593 at stage 0); the gather
// and the two LayerNorm passes 16 bytes a lane (block_common.cuh).  So the
// bf16 route takes C and hidden multiples of 8, 16-byte aligned operands
// and windows of at most 144 tokens (the wrappers check before a launch).
// float32 (the parity config): the first version's kernels, common.cuh's
// FMA gemm and the one-warp-per-query CUDA-core attention, kept because
// TF32 products would miss float32's 1e-4 gate; its outputs are the same
// bit for bit as before the bf16 redesign.
//
// The file builds as two objects compiled in parallel (_build.PARTS): with
// BLOCK_WM_PART 1 only the bf16 instantiations of block_wm (the tensor-core
// route), with BLOCK_WM_PART 0 everything else, the entries calling the bf16
// ones across the objects.  Without BLOCK_WM_PART it builds whole.
#include "mma_gemm.cuh"
#include "wattn_mma.cuh"

namespace pangu {

// grouped: one thread block per (sample, z window, group of gh lat windows,
// head); each window type's bias slice and region ids are staged in shared
// memory once, behind the attention buffers, for the group's nlon windows
template <typename T, typename TB>
__global__ void __launch_bounds__(32 * GATT_WARPS)
group_attn_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                  const TB* __restrict__ bias_table, const int* __restrict__ ids,
                  int N, int C, int heads, int hd, int nz, int nlat, int nlon,
                  int gh, float scale) {
  extern __shared__ float sm[];
  const int ngrp = nlat / gh;
  const long long bz = blockIdx.x / ngrp;  // b * nz + zz
  const int grp = (int)(blockIdx.x % ngrp);
  const int zz = (int)(bz % nz);
  const int h = blockIdx.y;
  int* id_s = (int*)(sm + attend_smem(N, hd, GATT_WARPS) / sizeof(float));
  TB* bias_s = (TB*)(id_s + N);
  for (int wi = 0; wi < gh; ++wi) {
    const int hh = grp * gh + wi;
    const int type = zz * nlat + hh;
    __syncthreads();  // the previous type's slice is no longer read
    const TB* src = bias_table + ((long long)type * heads + h) * N * N;
    for (int idx = threadIdx.x; idx < N * N; idx += blockDim.x) bias_s[idx] = src[idx];
    if (ids)
      for (int idx = threadIdx.x; idx < N; idx += blockDim.x)
        id_s[idx] = ids[(long long)type * N + idx];
    for (int l = 0; l < nlon; ++l) {
      __syncthreads();  // slice staged; the previous window's q, k, v read
      const long long win = (bz * nlat + hh) * nlon + l;
      window_attend<T, TB>(qkv, out, win * N, h, bias_s, ids ? id_s : nullptr,
                           sm, N, C, hd, scale);
    }
  }
}

// step 3: bf16 on the tensor cores (whatever gh), float32 on the CUDA cores
// (grouped where gh > 1)
template <typename T, typename TB>
int block_attention(const T* qkv, T* attn, const TB* table, const int* ids,
                    int B, const WmShape& s, int C, int heads, int gh,
                    cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value) {
    return wa_attention<TB>(qkv, attn, table, ids, B, s, C, heads, st);
  } else {
    if (gh == 1)
      return window_attention<T, TB>(qkv, attn, table, ids, B, s, C, heads,
                                     st);
    const int hd = C / heads;
    const size_t smem = attend_smem(s.n, hd, GATT_WARPS) + s.n * sizeof(int) +
                        (size_t)s.n * s.n * sizeof(TB);
    cudaError_t e = cudaFuncSetAttribute(group_attn_kernel<T, TB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    dim3 agrid((unsigned)((long long)B * s.nz * (s.nlat / gh)), heads);
    group_attn_kernel<T, TB><<<agrid, 32 * GATT_WARPS, smem, st>>>(
        qkv, attn, table, ids, s.n, C, heads, hd, s.nz, s.nlat, s.nlon, gh,
        attn_scale(hd));
    return (int)cudaGetLastError();
  }
}

template <typename T, typename TB>
int block_wm(const T* x, T* out, T* ws, const T* wqkv, const T* bqkv,
             const T* wp, const T* bp, const TB* table, const int* ids,
             const T* n1s, const T* n1b, const T* n2s, const T* n2b,
             const T* w1, const T* b1, const T* w2, const T* b2,
             const float* drop, int B, WmShape s, int C, int heads,
             int hidden, BlockShift sh, int gelu_tanh, int gh, int in_canon,
             int out_canon, cudaStream_t st) {
  const long long M = (long long)B * s.nz * s.nlat * s.nlon * s.n;
  // workspace: xg (M*C) | qkv (M*3C) | attn, later x1 (M*C) |
  //            a, later y (M*C) | h (M*hidden)
  T* xg = ws;
  T* qkv = xg + M * C;
  T* attn = qkv + M * 3 * C;
  T* a = attn + M * C;
  T* hb = a + M * C;
  T* x1 = attn;
  T* y = a;
  const long long rows_per_sample = M / B;

  block_gather<T>(x, xg, M, C, s, sh, in_canon, st);
  PANGU_CHECK_LAUNCH();
  int e = fwd_gemm(xg, wqkv, bqkv, qkv, M, 3 * C, C, ACT_NONE, st);
  if (e) return e;
  e = block_attention<T, TB>(qkv, attn, table, ids, B, s, C, heads, gh, st);
  if (e) return e;
  e = fwd_gemm(attn, wp, bp, a, M, C, C, ACT_NONE, st);
  if (e) return e;
  block_ln<T>(a, xg, x1, n1s, n1b, M, C, st, RowMap{}, drop, 0,
              rows_per_sample);
  PANGU_CHECK_LAUNCH();
  e = fwd_gemm(x1, w1, b1, hb, M, hidden, C,
               gelu_tanh ? ACT_GELU_TANH : ACT_GELU_ERF, st);
  if (e) return e;
  e = fwd_gemm(hb, w2, b2, y, M, C, hidden, ACT_NONE, st);
  if (e) return e;
  block_ln<T>(y, x1, out, n2s, n2b, M, C, st, RowMap{out_canon, s}, drop, 1,
              rows_per_sample);
  PANGU_CHECK_LAUNCH();
  return 0;
}

#define PANGU_BLOCK_INSTANCE(T, TB)                                            \
  int block_wm<T, TB>(const T*, T*, T*, const T*, const T*, const T*,          \
                      const T*, const TB*, const int*, const T*, const T*,     \
                      const T*, const T*, const T*, const T*, const T*,        \
                      const T*, const float*, int, WmShape, int, int, int,     \
                      BlockShift, int, int, int, int, cudaStream_t)
#if defined(BLOCK_WM_PART) && BLOCK_WM_PART == 0
extern template PANGU_BLOCK_INSTANCE(bf16, float);
extern template PANGU_BLOCK_INSTANCE(bf16, bf16);
#elif defined(BLOCK_WM_PART) && BLOCK_WM_PART == 1
template PANGU_BLOCK_INSTANCE(bf16, float);
template PANGU_BLOCK_INSTANCE(bf16, bf16);
#endif
#undef PANGU_BLOCK_INSTANCE

}  // namespace pangu

using namespace pangu;

#if !defined(BLOCK_WM_PART) || BLOCK_WM_PART == 0

// dtype codes: 0 = float32, 1 = bfloat16.  drop: (B, 2) float32 branch
// scales or null.  gh: lat windows per attention
// program (1: one window per program); in_canon / out_canon: x / out is the
// (B, Z, Hp, W, C) grid instead of wm storage.  Returns a cudaError_t (0 = ok).
extern "C" int pangu_block_wm(
    int dtype, int table_dtype, const void* x, void* out, void* workspace,
    const void* wqkv, const void* bqkv, const void* wp, const void* bp,
    const void* table, const void* ids, const void* n1s, const void* n1b,
    const void* n2s, const void* n2b, const void* w1, const void* b1,
    const void* w2, const void* b2, const void* drop, int B, int nz,
    int nlat, int nlon, int n,
    int C, int heads, int hidden, int wz, int wh, int ww, int dz, int dh,
    int dw, int canon_add, int h_real, int gelu_tanh, int gh, int in_canon,
    int out_canon, void* stream) {
  WmShape s = {nz, nlat, nlon, n, wz, wh, ww};
  BlockShift sh = {dz, dh, dw, canon_add, h_real};
  cudaStream_t st = (cudaStream_t)stream;
  const int* id = (const int*)ids;
  if (n > 32 * ATT_MAXJ || C % heads != 0 || gh < 1 || nlat % gh != 0)
    return (int)cudaErrorInvalidValue;
  // bf16: the tensor-core tiles and the 16-byte row passes take 8-column
  // groups, 16-byte aligned operands and windows of at most 144 tokens
  if (dtype == 1 &&
      (C % 8 || hidden % 8 || pad16(n) > 16 * WA_KT ||
       !aligned16_all({x, out, workspace, wqkv, wp, w1, w2})))
    return (int)cudaErrorInvalidValue;
#define PANGU_BLOCK(T, TB)                                                     \
  return block_wm<T, TB>(                                                      \
      (const T*)x, (T*)out, (T*)workspace, (const T*)wqkv, (const T*)bqkv,     \
      (const T*)wp, (const T*)bp, (const TB*)table, id, (const T*)n1s,         \
      (const T*)n1b, (const T*)n2s, (const T*)n2b, (const T*)w1,               \
      (const T*)b1, (const T*)w2, (const T*)b2, (const float*)drop, B, s, C,   \
      heads, hidden, sh, gelu_tanh, gh, in_canon, out_canon, st)
  if (dtype == 0 && table_dtype == 0) PANGU_BLOCK(float, float);
  if (dtype == 0 && table_dtype == 1) PANGU_BLOCK(float, bf16);
  if (dtype == 1 && table_dtype == 0) PANGU_BLOCK(bf16, float);
  if (dtype == 1 && table_dtype == 1) PANGU_BLOCK(bf16, bf16);
#undef PANGU_BLOCK
  return (int)cudaErrorInvalidValue;
}

// The whole unshifted block on the lat-padded (B, Z, Hp, W, C) grid, its pad
// rows taken as data (B16, pangu_tpu/ops/window_attention.py::
// _block_fused_pallas): the block with zero shift, no region ids, a grid
// input and output and no pad rows synthesised (h_real = Hp).  The output's
// pad rows hold the block applied to the input's pad rows, as the Pallas
// kernel writes them; the caller crops them.
extern "C" int pangu_block_noroll(
    int dtype, int table_dtype, const void* x, void* out, void* workspace,
    const void* wqkv, const void* bqkv, const void* wp, const void* bp,
    const void* table, const void* n1s, const void* n1b, const void* n2s,
    const void* n2b, const void* w1, const void* b1, const void* w2,
    const void* b2, int B, int nz, int nlat, int nlon, int n, int C,
    int heads, int hidden, int wz, int wh, int ww, int gelu_tanh,
    void* stream) {
  return pangu_block_wm(dtype, table_dtype, x, out, workspace, wqkv, bqkv, wp,
                        bp, table, nullptr, n1s, n1b, n2s, n2b, w1, b1, w2, b2,
                        nullptr, B, nz, nlat, nlon, n, C, heads, hidden, wz,
                        wh, ww, 0, 0, 0, 0, nlat * wh, gelu_tanh, 1, 1, 1,
                        stream);
}

extern "C" const char* pangu_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
#endif  // BLOCK_WM_PART 0
