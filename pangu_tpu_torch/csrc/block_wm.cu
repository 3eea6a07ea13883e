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
// The grouped block differs only in step 3.  On the TPU, gh latitude windows
// per program amortise the weight and bias-table streams into VMEM; here the
// GEMMs already run over all rows, so grouping matters only in the attention:
// one thread block per (sample, z window, group of gh lat windows, head)
// stages each window type's (N, N) bias slice (and region ids) in shared
// memory once and loops over the group's gh * nlon windows, instead of
// re-reading the slice once per longitude window.
//
// What bounds it on an H100: arithmetic.  A stage-0 block at full width does
// ~5.3e11 FLOP against ~0.45 GB of traffic (x in, out, the bias table), far
// above the card's ~295 FLOP/byte balance point in bf16.  This first version
// keeps every intermediate in device memory (about 10*C values per token) and
// uses untuned WMMA (bf16) / FMA (float32) GEMMs and a one-warp-per-query
// attention loop, so it runs well below that bound; fusing the steps and
// moving the GEMMs to wgmma is later work.
#include "block_common.cuh"

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

template <typename T, typename TB>
int block_wm(const void* x_, void* out_, void* ws_, const void* wqkv_,
             const void* bqkv_, const void* wp_, const void* bp_,
             const void* table_, const int* ids, const void* n1s_,
             const void* n1b_, const void* n2s_, const void* n2b_,
             const void* w1_, const void* b1_, const void* w2_, const void* b2_,
             const float* drop, int B, WmShape s, int C, int heads, int hidden,
             BlockShift sh,
             int gelu_tanh, int gh, int in_canon, int out_canon,
             cudaStream_t st) {
  const T* x = (const T*)x_;
  T* out = (T*)out_;
  const long long M = (long long)B * s.nz * s.nlat * s.nlon * s.n;
  // workspace: xg (M*C) | qkv (M*3C) | attn, later x1 (M*C) |
  //            a, later y (M*C) | h (M*hidden)
  T* xg = (T*)ws_;
  T* qkv = xg + M * C;
  T* attn = qkv + M * 3 * C;
  T* a = attn + M * C;
  T* hb = a + M * C;
  T* x1 = attn;
  T* y = a;
  const PadRows none = {0};
  const int hd = C / heads;

  block_gather_kernel<T><<<row_blocks(M), 256, 0, st>>>(x, xg, M, C, s, sh,
                                                        in_canon);
  PANGU_CHECK_LAUNCH();
  gemm(xg, (const T*)wqkv_, (const T*)bqkv_, qkv, (int)M, 3 * C, C, ACT_NONE,
       none, st);
  PANGU_CHECK_LAUNCH();

  if (gh > 1) {
    const size_t smem = attend_smem(s.n, hd, GATT_WARPS) + s.n * sizeof(int) +
                        (size_t)s.n * s.n * sizeof(TB);
    cudaError_t e = cudaFuncSetAttribute(group_attn_kernel<T, TB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    dim3 agrid((unsigned)((long long)B * s.nz * (s.nlat / gh)), heads);
    group_attn_kernel<T, TB><<<agrid, 32 * GATT_WARPS, smem, st>>>(
        qkv, attn, (const TB*)table_, ids, s.n, C, heads, hd, s.nz, s.nlat,
        s.nlon, gh, attn_scale(hd));
    PANGU_CHECK_LAUNCH();
  } else {
    const int e = window_attention<T, TB>(qkv, attn, (const TB*)table_, ids,
                                          B, s, C, heads, st);
    if (e) return e;
  }

  gemm(attn, (const T*)wp_, (const T*)bp_, a, (int)M, C, C, ACT_NONE, none, st);
  PANGU_CHECK_LAUNCH();
  const long long rows_per_sample = M / B;
  ln_rows<T>(a, xg, x1, (const T*)n1s_, (const T*)n1b_, M, C, st, RowMap{},
             drop, 0, rows_per_sample);
  PANGU_CHECK_LAUNCH();
  gemm(x1, (const T*)w1_, (const T*)b1_, hb, (int)M, hidden, C,
       gelu_tanh ? ACT_GELU_TANH : ACT_GELU_ERF, none, st);
  PANGU_CHECK_LAUNCH();
  gemm(hb, (const T*)w2_, (const T*)b2_, y, (int)M, C, hidden, ACT_NONE, none, st);
  PANGU_CHECK_LAUNCH();
  const RowMap out_map = {out_canon, s};
  ln_rows<T>(y, x1, out, (const T*)n2s_, (const T*)n2b_, M, C, st, out_map,
             drop, 1, rows_per_sample);
  PANGU_CHECK_LAUNCH();
  return 0;
}

}  // namespace pangu

using namespace pangu;

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
#define PANGU_BLOCK(T, TB)                                                     \
  return block_wm<T, TB>(x, out, workspace, wqkv, bqkv, wp, bp, table, id, \
                         n1s, n1b, n2s, n2b, w1, b1, w2, b2,                \
                         (const float*)drop, B, s, C, heads,                  \
                         hidden, sh, gelu_tanh, gh, in_canon, out_canon, st)
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
