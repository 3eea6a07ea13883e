// Every gradient of one whole Earth-specific block on window-major storage.
//
// Replaces the Pallas kernel pangu_tpu/ops/earth_block_bwd.py::_block_bwd_call
// (kernel body _make_block_bwd_kernel) in its wm -> wm layout and with its
// canonical stage end-points (x_layout / g_layout = "canon").  Inputs: the
// block's saved input x and the cotangent g of its output, both in stage
// storage; x is read through the block's shift delta_x (latitude-pad rows
// zero-synthesised), g through delta_g, the negated shift of the next block,
// whose backward wrote its dx in its own window coordinates.  On the TPU both
// reads are BlockSpec chunk stitches; here they are the forward's modular
// gather.  A canonical x (a stage's first block) is the lat-padded
// (B, Z, Hp, W, C) grid, read unshifted by the same gather, and dx goes to
// the same grid rows (the DxEpi scatter); a canonical g (a stage's last
// block) is that grid in the block's own window coordinates, what the
// stage's roll back hands back.  The unit is a sequence of launches on the
// caller's stream:
//
//   recompute  xg, gg (gathers); qkv = round_T(xg Wqkv + b); attention as the
//              forward; a = round_T(attn Wp + bp); LN1 statistics and
//              x1 = round_T(xg + s1 * (ahat n1s + n1b)), the branch kept in
//              float32 (the backward's rounding point, not the forward's);
//              z = round_T(x1 W1 + b1), h = round_T(GELU(z));
//              y = round_T(h W2 + b2)
//   tail       dy2 = round_T(LN2'(s2 * g)); dW2, db2; dz = round_T(dy2 W2^T *
//              GELU'(z)); dW1, db1; dx1 = g + dz W1^T (float32);
//              da = round_T(LN1'(s1 * dx1)); dLN1, dLN2 (column sums)
//   proj       dWp, dbp; datt = round_T(da Wp^T)
//   attention  per (window type, head): P recomputed, dV = P^T dO,
//              dS = P o (dP - rowsum(dP o P)) with dP = dO V^T,
//              d table[type, h] += dS (float32), dQ = dS K hd^-1/2,
//              dK = dS^T Q hd^-1/2 with dS rounded to T
//   qkv        dWqkv, dbqkv; dx = round_T(dx1 + dqkv Wqkv^T), pad rows 0
//
// Weight gradients are transposed-A products over every row of the batch:
// each split of WG_SPLIT_ROWS rows writes its own float32 partial and a
// second pass adds them in order, so the sums are the same bit for bit in
// every run.  The bias gradient rides each weight gradient as a row of
// ones.  The table gradient takes one thread block per (window type, head),
// which loops over the type's B x nlon windows: each table entry has one
// owner, so no atomics.
//
// What bounds it on an H100: bytes.  Twelve products (four recomputed, four
// data-gradient, four weight-gradient; ~1.4e12 FLOP at stage 0) against
// about 15 C + 2 hidden intermediate values a row written and read again
// (4.7 GB at stage 0 in bf16), most products at ~140 FLOP per byte, under
// the card's ~295.  bf16 (the perf config): every product on the tensor
// cores through mma_gemm.cuh (128 x 96 tiles, cp.async rings, 8-column
// epilogues of 16-byte accesses), the attention forward and backward
// through wattn_mma.cuh (one block per (type, head), P kept in registers,
// the table gradient summed in shared memory); the gathers and the
// LayerNorm passes stay one warp per row.  float32 (the parity config):
// the first version's kernels, grad_gemm.cuh's FMA tiles and the CUDA-core
// attention (block_common.cuh, attn_bwd.cuh), kept because TF32 products
// would miss float32's 1e-4 gate.
#include "mma_gemm.cuh"
#include "wattn_mma.cuh"

namespace pangu {

__device__ __forceinline__ float gelu_grad(float v, int tanh_form) {
  if (tanh_form) {
    const float k = 0.7978845608028654f;
    const float t = tanhf(k * (v + 0.044715f * v * v * v));
    const float du = k * (1.f + 3.f * 0.044715f * v * v);
    return 0.5f * (1.f + t) + 0.5f * v * (1.f - t * t) * du;
  }
  const float phi = 0.5f * (1.f + erff(v * 0.7071067811865476f));
  return phi + v * 0.3989422804014327f * expf(-0.5f * v * v);
}

// ---- GEMM epilogues ---------------------------------------------------------

template <typename T>
struct DzEpi {  // dz = round_T(acc * GELU'(z)); may overwrite h
  const T* z;
  T* dz;
  int N, tanh_form;
  __device__ void operator()(int, long long r, int c, float acc) const {
    dz[r * N + c] = from_f<T>(acc * gelu_grad(to_f(z[r * N + c]), tanh_form));
  }
  __device__ void operator()(int, long long r, int c, const float (&v)[8]) const {
    float zv[8];
    ld8(z + r * N + c, zv);
#pragma unroll
    for (int e = 0; e < 8; ++e) zv[e] = v[e] * gelu_grad(zv[e], tanh_form);
    st8(dz + r * N + c, zv);
  }
};

template <typename T>
struct Dx1Epi {  // dx1 = g + acc, float32
  const T* gg;
  float* dx1;
  int N;
  __device__ void operator()(int, long long r, int c, float acc) const {
    dx1[r * N + c] = to_f(gg[r * N + c]) + acc;
  }
  __device__ void operator()(int, long long r, int c, const float (&v)[8]) const {
    float gv[8];
    ld8(gg + r * N + c, gv);
#pragma unroll
    for (int e = 0; e < 8; ++e) gv[e] += v[e];
    st8(dx1 + r * N + c, gv);
  }
};

template <typename T>
struct DxEpi {  // dx = round_T(dx1 + acc), pad rows zero; row map_row(r)
  const float* dx1;
  T* dx;
  int N;
  PadRows pad;
  RowMap map;  // canon: the token's row of the (B, Z, Hp, W) grid
  __device__ void operator()(int, long long r, int c, float acc) const {
    dx[map_row(r, map) * N + c] = is_pad_row(r, pad)
                                      ? from_f<T>(0.f)
                                      : from_f<T>(dx1[r * N + c] + acc);
  }
  __device__ void operator()(int, long long r, int c, const float (&v)[8]) const {
    float o[8];
    ld8(dx1 + r * N + c, o);
    const bool zero = is_pad_row(r, pad);
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = zero ? 0.f : o[e] + v[e];
    st8(dx + map_row(r, map) * N + c, o);
  }
};

// ---- row kernels: one warp per row -------------------------------------------

__device__ __forceinline__ float branch_scale(const float* drop, long long row,
                                              long long rows_per_sample,
                                              int which) {
  return drop ? drop[2 * (row / rows_per_sample) + which] : 1.f;
}

template <typename T>
__device__ __forceinline__ void row_stats(const T* r, int C, float& mu,
                                          float& rs) {
  const int lane = threadIdx.x % 32;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += to_f(r[c]);
  mu = warp_sum(s) / C;
  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = to_f(r[c]) - mu;
    v += d * d;
  }
  rs = rsqrtf(warp_sum(v) / C + 1e-5f);
}

// LN1 forward of the recompute: statistics of a, and
// x1 = round_T(xg + s1 * (ahat * n1s + n1b)) with the branch in float32
template <typename T>
__global__ void __launch_bounds__(256)
ln1_fwd_kernel(const T* __restrict__ a, const T* __restrict__ xg,
               const T* __restrict__ n1s, const T* __restrict__ n1b,
               const float* __restrict__ drop, T* __restrict__ x1,
               float* __restrict__ stats, long long M, int C,
               long long rows_per_sample) {
  const int lane = threadIdx.x % 32;
  const long long m = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (m >= M) return;
  float mu, rs;
  row_stats(a + m * C, C, mu, rs);
  const float s1 = branch_scale(drop, m, rows_per_sample, 0);
  for (int c = lane; c < C; c += 32) {
    float br = (to_f(a[m * C + c]) - mu) * rs * to_f(n1s[c]) + to_f(n1b[c]);
    if (drop) br *= s1;
    x1[m * C + c] = from_f<T>(to_f(xg[m * C + c]) + br);
  }
  if (lane == 0) {
    stats[2 * m] = mu;
    stats[2 * m + 1] = rs;
  }
}

// LayerNorm backward of one row: d = (dxhat - mean(dxhat) - xhat *
// mean(dxhat * xhat)) * rstd with dxhat = s * dy * scale; dy read as float
template <typename T, typename DY>
__device__ __forceinline__ void ln_bwd_row(const T* x, DY dy, float s,
                                           const T* scale, float mu, float rs,
                                           int C, T* out) {
  const int lane = threadIdx.x % 32;
  float m1 = 0.f, m2 = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float xh = (to_f(x[c]) - mu) * rs;
    const float dxh = dy(c) * s * to_f(scale[c]);
    m1 += dxh;
    m2 += dxh * xh;
  }
  m1 = warp_sum(m1) / C;
  m2 = warp_sum(m2) / C;
  for (int c = lane; c < C; c += 32) {
    const float xh = (to_f(x[c]) - mu) * rs;
    const float dxh = dy(c) * s * to_f(scale[c]);
    out[c] = from_f<T>((dxh - m1 - xh * m2) * rs);
  }
}

template <typename T>
struct ReadT {
  const T* p;
  __device__ __forceinline__ float operator()(int c) const { return to_f(p[c]); }
};

struct ReadF {
  const float* p;
  __device__ __forceinline__ float operator()(int c) const { return p[c]; }
};

// LN2 backward: statistics of y, dy2 = round_T(LN2'(s2 * g))
template <typename T>
__global__ void __launch_bounds__(256)
ln2_bwd_kernel(const T* __restrict__ y, const T* __restrict__ gg,
               const T* __restrict__ n2s, const float* __restrict__ drop,
               T* __restrict__ dy2, float* __restrict__ stats, long long M,
               int C, long long rows_per_sample) {
  const long long m = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (m >= M) return;
  float mu, rs;
  row_stats(y + m * C, C, mu, rs);
  ln_bwd_row(y + m * C, ReadT<T>{gg + m * C},
             branch_scale(drop, m, rows_per_sample, 1), n2s, mu, rs, C,
             dy2 + m * C);
  if (threadIdx.x % 32 == 0) {
    stats[2 * m] = mu;
    stats[2 * m + 1] = rs;
  }
}

// LN1 backward: da = round_T(LN1'(s1 * dx1)) with a's saved statistics
template <typename T>
__global__ void __launch_bounds__(256)
ln1_bwd_kernel(const T* __restrict__ a, const float* __restrict__ dx1,
               const T* __restrict__ n1s, const float* __restrict__ drop,
               const float* __restrict__ stats, T* __restrict__ da,
               long long M, int C, long long rows_per_sample) {
  const long long m = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (m >= M) return;
  ln_bwd_row(a + m * C, ReadF{dx1 + m * C},
             branch_scale(drop, m, rows_per_sample, 0), n1s, stats[2 * m],
             stats[2 * m + 1], C, da + m * C);
}

// LayerNorm parameter gradients, one split of rows per blockIdx.y:
// part[split] = (sum dbr1*ahat, sum dbr1, sum dbr2*yhat, sum dbr2), each (C)
template <typename T>
__global__ void __launch_bounds__(256)
ln_grads_kernel(const T* __restrict__ a, const float* __restrict__ dx1,
                const T* __restrict__ y, const T* __restrict__ gg,
                const float* __restrict__ stats_a,
                const float* __restrict__ stats_y,
                const float* __restrict__ drop, float* __restrict__ part,
                long long M, int C, long long rows_per_sample) {
  __shared__ float sm[4][8][33];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + tx;
  const long long r0 = (long long)blockIdx.y * WG_SPLIT_ROWS;
  const long long r1 = min(M, r0 + WG_SPLIT_ROWS);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (c < C) {
    for (long long r = r0 + ty; r < r1; r += 8) {
      const float d1 = dx1[r * C + c] * branch_scale(drop, r, rows_per_sample, 0);
      const float d2 = to_f(gg[r * C + c]) * branch_scale(drop, r, rows_per_sample, 1);
      acc[0] += d1 * (to_f(a[r * C + c]) - stats_a[2 * r]) * stats_a[2 * r + 1];
      acc[1] += d1;
      acc[2] += d2 * (to_f(y[r * C + c]) - stats_y[2 * r]) * stats_y[2 * r + 1];
      acc[3] += d2;
    }
  }
  for (int k = 0; k < 4; ++k) sm[k][ty][tx] = acc[k];
  __syncthreads();
  if (ty < 4 && c < C) {
    float s = 0.f;
    for (int i = 0; i < 8; ++i) s += sm[ty][i][tx];
    part[((long long)blockIdx.y * 4 + ty) * C + c] = s;
  }
}

// ---- the unit ------------------------------------------------------------------

// workspace: T elements (which = 0) or float32 elements (which = 1)
inline long long bwd_ws_elems(long long M, int C, int hidden, int which) {
  if (which == 0) return M * (15LL * C + 2LL * hidden);
  long long part = (long long)(C + 1) * 3 * C;
  part = part > (long long)(C + 1) * hidden ? part : (long long)(C + 1) * hidden;
  part = part > (long long)(hidden + 1) * C ? part : (long long)(hidden + 1) * C;
  return M * C + 4 * M + wg_splits(M) * part;
}

template <typename T, typename TB>
int block_bwd(const T* x, const T* g, T* dx, T* ws, float* wsf, const T* wqkv,
              const T* bqkv, const T* wp, const T* bp, const TB* table,
              const int* ids, const T* n1s, const T* n1b, const T* n2s,
              const T* w1, const T* b1, const T* w2, const T* b2,
              const float* drop, float* dwqkv, float* dwp, float* dw1,
              float* dw2, float* dln, float* dtable, int B, WmShape s, int C,
              int heads, int hidden, BlockShift shx, BlockShift shg,
              int gelu_tanh, int x_canon, int g_canon, cudaStream_t st) {
  const long long M = (long long)B * s.nz * s.nlat * s.nlon * s.n;
  const long long rps = M / B;
  // T workspace: xg gg (C) | qkv (3C) | attn a x1 y dy2 (C) | z hb (hidden) |
  //              da datt (C) | dqkv (3C)
  T* xg = ws;
  T* gg = xg + M * C;
  T* qkv = gg + M * C;
  T* attn = qkv + M * 3 * C;
  T* a = attn + M * C;
  T* x1 = a + M * C;
  T* y = x1 + M * C;
  T* dy2 = y + M * C;
  T* z = dy2 + M * C;
  T* hb = z + M * hidden;  // h, then dz
  T* da = hb + M * hidden;
  T* datt = da + M * C;
  T* dqkv = datt + M * C;
  // float32 workspace: dx1 (C) | stats of a, of y (2 each) | split partials
  float* dx1 = wsf;
  float* stats_a = dx1 + M * C;
  float* stats_y = stats_a + 2 * M;
  float* part = stats_y + 2 * M;
  const PadRows pad = {1, s, s.nlat * s.wh, shx.h_real, shx.canon_add};

  // ---- recompute ----
  block_gather_kernel<T><<<row_blocks(M), 256, 0, st>>>(x, xg, M, C, s, shx,
                                                        x_canon);
  PANGU_CHECK_LAUNCH();
  block_gather_kernel<T><<<row_blocks(M), 256, 0, st>>>(g, gg, M, C, s, shg,
                                                        g_canon);
  PANGU_CHECK_LAUNCH();
  int e = unit_gemm<false>(xg, wqkv, M, 3 * C, C,
                           BiasEpi<T>{bqkv, qkv, 3 * C}, st);
  if (e) return e;
  e = unit_attention<T, TB>(qkv, attn, table, ids, B, s, C, heads, st);
  if (e) return e;
  e = unit_gemm<false>(attn, wp, M, C, C, BiasEpi<T>{bp, a, C}, st);
  if (e) return e;
  ln1_fwd_kernel<T><<<row_blocks(M), 256, 0, st>>>(a, xg, n1s, n1b, drop, x1,
                                                   stats_a, M, C, rps);
  PANGU_CHECK_LAUNCH();
  e = unit_gemm<false>(x1, w1, M, hidden, C,
                       ZhEpi<T>{b1, z, hb, hidden, gelu_tanh}, st);
  if (e) return e;
  e = unit_gemm<false>(hb, w2, M, C, hidden, BiasEpi<T>{b2, y, C}, st);
  if (e) return e;

  // ---- the tail ----
  ln2_bwd_kernel<T><<<row_blocks(M), 256, 0, st>>>(y, gg, n2s, drop, dy2,
                                                   stats_y, M, C, rps);
  PANGU_CHECK_LAUNCH();
  e = unit_wgrad(hb, hidden, dy2, C, M, part, dw2, st);
  if (e) return e;
  e = unit_gemm<true>(dy2, w2, M, hidden, C,
                      DzEpi<T>{z, hb, hidden, gelu_tanh}, st);
  if (e) return e;
  e = unit_wgrad(x1, C, hb, hidden, M, part, dw1, st);
  if (e) return e;
  e = unit_gemm<true>(hb, w1, M, C, hidden, Dx1Epi<T>{gg, dx1, C}, st);
  if (e) return e;
  ln1_bwd_kernel<T><<<row_blocks(M), 256, 0, st>>>(a, dx1, n1s, drop, stats_a,
                                                   da, M, C, rps);
  PANGU_CHECK_LAUNCH();
  {
    const int splits = wg_splits(M);
    dim3 grid((C + 31) / 32, splits);
    ln_grads_kernel<T><<<grid, 256, 0, st>>>(a, dx1, y, gg, stats_a, stats_y,
                                             drop, part, M, C, rps);
    PANGU_CHECK_LAUNCH();
    split_sum(part, dln, 4LL * C, splits, st);
    PANGU_CHECK_LAUNCH();
  }

  // ---- proj ----
  e = unit_wgrad(attn, C, da, C, M, part, dwp, st);
  if (e) return e;
  e = unit_gemm<true>(da, wp, M, C, C, RoundEpi<T>{datt, C}, st);
  if (e) return e;

  // ---- attention ----
  e = unit_attention_bwd<T, TB>(qkv, datt, dqkv, table, ids, dtable, B, s, C,
                                heads, st);
  if (e) return e;

  // ---- qkv and the residual ----
  e = unit_wgrad(xg, C, dqkv, 3 * C, M, part, dwqkv, st);
  if (e) return e;
  e = unit_gemm<true>(dqkv, wqkv, M, C, 3 * C,
                      DxEpi<T>{dx1, dx, C, pad, RowMap{x_canon, s}}, st);
  if (e) return e;
  return 0;
}

// The file builds as two objects compiled in parallel (_build.PARTS): with
// BLOCK_BWD_PART 1 only the bf16 instantiations of block_bwd (the
// tensor-core route, most of the file's compile time), with BLOCK_BWD_PART
// 0 everything else, the entries calling the bf16 ones across the objects.
// Without BLOCK_BWD_PART it builds whole.
#define PANGU_BWD_INSTANCE(T, TB)                                              \
  int block_bwd<T, TB>(                                                        \
      const T*, const T*, T*, T*, float*, const T*, const T*, const T*,        \
      const T*, const TB*, const int*, const T*, const T*, const T*,           \
      const T*, const T*, const T*, const T*, const float*, float*, float*,    \
      float*, float*, float*, float*, int, WmShape, int, int, int, BlockShift, \
      BlockShift, int, int, int, cudaStream_t)
#if defined(BLOCK_BWD_PART) && BLOCK_BWD_PART == 0
extern template PANGU_BWD_INSTANCE(bf16, float);
extern template PANGU_BWD_INSTANCE(bf16, bf16);
#elif defined(BLOCK_BWD_PART) && BLOCK_BWD_PART == 1
template PANGU_BWD_INSTANCE(bf16, float);
template PANGU_BWD_INSTANCE(bf16, bf16);
#endif
#undef PANGU_BWD_INSTANCE

}  // namespace pangu

using namespace pangu;

#if !defined(BLOCK_BWD_PART) || BLOCK_BWD_PART == 0

// Workspace the entry below needs for ``rows`` storage rows: elements of the
// activation dtype (which = 0) or float32 elements (which = 1).
extern "C" long long pangu_block_bwd_ws(long long rows, int C, int hidden,
                                        int which) {
  return bwd_ws_elems(rows, C, hidden, which);
}

// dtype codes: 0 = float32, 1 = bfloat16.  x_canon / g_canon: x (and dx) /
// g is the (B, Z, Hp, W, C) grid, read unshifted (its delta must be zero),
// instead of wm storage.  Outputs: dx (storage or the grid, the block's
// window coordinates), and float32 dwqkv (C+1, 3C), dwp (C+1, C),
// dw1 (C+1, hidden), dw2 (hidden+1, C) -- the last row the bias gradient --
// dln (4, C) = (norm1 scale, norm1 bias, norm2 scale, norm2 bias), dtable
// (ntype, heads, N, N).  drop: (B, 2) float32 branch scales or null.
// Returns a cudaError_t (0 = ok).
extern "C" int pangu_block_bwd(
    int dtype, int table_dtype, const void* x, const void* g, void* dx,
    void* ws, void* wsf, const void* wqkv, const void* bqkv, const void* wp,
    const void* bp, const void* table, const void* ids, const void* n1s,
    const void* n1b, const void* n2s, const void* w1, const void* b1,
    const void* w2, const void* b2, const void* drop, void* dwqkv, void* dwp,
    void* dw1, void* dw2, void* dln, void* dtable, int B, int nz, int nlat,
    int nlon, int n, int C, int heads, int hidden, int wz, int wh, int ww,
    int dxz, int dxh, int dxw, int dgz, int dgh, int dgw, int canon_add,
    int h_real, int gelu_tanh, int x_canon, int g_canon, void* stream) {
  WmShape s = {nz, nlat, nlon, n, wz, wh, ww};
  BlockShift shx = {dxz, dxh, dxw, canon_add, h_real};
  BlockShift shg = {dgz, dgh, dgw, 0, nlat * wh};  // g: no pad rows synthesised
  cudaStream_t st = (cudaStream_t)stream;
  if (n > 32 * ATT_MAXJ || C % heads != 0 ||
      (x_canon && (dxz || dxh || dxw)) || (g_canon && (dgz || dgh || dgw)))
    return (int)cudaErrorInvalidValue;
  // bf16: the tensor-core tiles take 8-column groups, 16-byte aligned
  // operands and windows of at most 144 tokens
  if (dtype == 1 &&
      (C % 8 || hidden % 8 || pad16(n) > 16 * WA_KT ||
       !aligned16_all({wqkv, wp, w1, w2})))
    return (int)cudaErrorInvalidValue;
#define PANGU_BWD(T, TB)                                                       \
  return block_bwd<T, TB>(                                                     \
      (const T*)x, (const T*)g, (T*)dx, (T*)ws, (float*)wsf, (const T*)wqkv,   \
      (const T*)bqkv, (const T*)wp, (const T*)bp, (const TB*)table,            \
      (const int*)ids, (const T*)n1s, (const T*)n1b, (const T*)n2s,            \
      (const T*)w1, (const T*)b1, (const T*)w2, (const T*)b2,                  \
      (const float*)drop, (float*)dwqkv, (float*)dwp, (float*)dw1,             \
      (float*)dw2, (float*)dln, (float*)dtable, B, s, C, heads, hidden, shx,   \
      shg, gelu_tanh, x_canon, g_canon, st)
  if (dtype == 0 && table_dtype == 0) PANGU_BWD(float, float);
  if (dtype == 0 && table_dtype == 1) PANGU_BWD(float, bf16);
  if (dtype == 1 && table_dtype == 0) PANGU_BWD(bf16, float);
  if (dtype == 1 && table_dtype == 1) PANGU_BWD(bf16, bf16);
#undef PANGU_BWD
  return (int)cudaErrorInvalidValue;
}
#endif  // BLOCK_BWD_PART 0
