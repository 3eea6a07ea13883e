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
// Rounding as the Pallas bodies: qs = round_T(q round_T(hd^-1/2)); float32
// logits qs k^T + bias and softmax; P rounded to T; o = P V summed in
// float32, rounded once.  Backward: P recomputed as the forward; dV =
// round_T(P_T^T dO); dP = dO V^T in float32; dS32 = P32 (dP - rowsum(dP
// P32)) with the unrounded P32, summed unrounded into dbias; dS = round_T
// (dS32); dQ = round_T(hd^-1/2 dS K); dK = round_T(hd^-1/2 dS^T q_raw), from
// the UNSCALED q.
//
// What bounds it on an H100: bytes.  The forward does 4 N^2 hd FLOP per
// window and head against reading qkv and the bias and writing out (0.885
// GB at stage 0, 0.264 ms); the backward 10 N^2 hd against reading qkv, the
// bias and g and writing dqkv and dbias.
//
// bf16 (the perf config): tensor cores, mma.sync m16n8k16 with float32
// accumulators (attn_mma.cuh).  N is padded to np (a multiple of 16), hd to
// 16; warp w owns query rows [16 w, 16 w + 16) and their 16 x np logits in
// registers.  Two instantiations a kernel: np <= 144, the model's shapes
// (nine warps, one slab each), and np <= 256 (eight warps striding over the
// slabs).  hd is walked at run time, 16 at a time as the logits' k and 32
// output columns at a time, so any head dim whose tiles fit in shared
// memory runs with the same registers.
//   Forward: one block per (window type, head) and a run of consecutive
//   windows (the runs split a pair's windows only where the pairs alone
//   would not fill the card twice).  The float32 bias slice is read from
//   device memory once per block into shared memory, pads filled (-inf key
//   columns, zero rows), and is the initial value of the logit
//   accumulators, so S = bias + qs k^T comes out of the product (np > 144:
//   the bias stays in device memory).  q, k, v come in as bf16 (hd, N)
//   tiles by cp.async, double-buffered: the next window loads while this
//   one computes.  Per warp: qs fragments (q scaled and rounded in
//   registers), S by mma, the softmax in registers (quad shuffles; exp by
//   ex2.approx and one reciprocal a row, a few float32 ulps from the plain
//   softmax, far inside the bf16 gate), P rounded and repacked as the A
//   operand of O = P V by mma, o rounded and staged through the warp's own
//   columns of the q tile to 16-byte stores along N.
//   Backward: one block per (window type, head), walking all its windows in
//   order.  Per window and warp (its query rows): S once (the bias slice
//   read from device memory, L2-resident, as the initial accumulator; those
//   reads are issued before the window waits for its tiles), P32 in
//   registers; dP = dO V^T by mma in 16-key chunks, twice (rowsum(dP P32)
//   first, then dS32 = P32 (dP - rowsum)), so only P32 and one chunk are
//   live; dS32 added to the warp's own rows of the float32 dbias partial in
//   shared memory (zeroed once; no atomics, a fixed order: windows in
//   sequence, written to device memory once per block; where it does not
//   fit beside the tiles, np > 144, it is summed in device memory, still
//   row-owned); dS rounded into a shared (np, np) tile.  After a barrier
//   each warp owns 16 keys and 16 query rows: dK = dS^T q_raw and dQ = dS K
//   by mma from that tile (ldmatrix, .trans for dK), interleaved; after a
//   barrier the tile takes round(P32) from the registers that kept it, and
//   dV = P^T dO.  The softmax is computed once per window
//   (np > 144: a warp holds one slab's P32 at a time, so P is recomputed
//   for dV).  Each warp stages its dQ / dK / dV columns in its own scratch
//   and stores them 16 bytes at a time.
// float32 (the parity config): CUDA cores, the first version's kernels, kept
// because TF32 products would miss float32's 1e-4 gate: forward one block
// per (window, type, head), q, k, v as float32 (N, hd + 1) tiles, one warp
// per query row by FMA; backward one block per (type, head) looping over
// the windows, the softmax recomputed for dV (prob_row of attn_bwd.cuh), the
// dbias slice summed through device memory per window.
#include <algorithm>

#include "attn_bwd.cuh"
#include "attn_mma.cuh"

namespace pangu {

// ===========================================================================
// float32: CUDA cores
// ===========================================================================

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


// ===========================================================================
// bf16: tensor cores
// ===========================================================================

constexpr int SDPA_LDS = 24;  // row stride of a warp's output staging (48 B)

// threads of a block at most: a warp per 16-row slab up to np = 144 (KT =
// 9 slabs), else 8 warps striding over the slabs
#define SDPA_THREADS(KT) ((KT) <= 9 ? 32 * 9 : 32 * 8)

// logit accumulators of query rows [i0, i0+16) initialised with the bias:
// from the shared slice (pads filled: key columns >= N at -inf, rows >= N
// zero), or checked reads of the slice in device memory (row stride N; 8
// bytes a read where N is even)
template <int NT, bool kShared>
__device__ __forceinline__ void bias_init(float (&s)[NT][4],
                                          const float* __restrict__ bt,
                                          int ldb, int i0, int N, int live) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = i0 + g, r1 = r0 + 8;
  const bool pairs = kShared || (N & 1) == 0;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    if (nt < live) {
      const int j = 8 * nt + 2 * t;
      if (pairs) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = half ? r1 : r0;
          float2 v;
          if (kShared)
            v = *reinterpret_cast<const float2*>(bt + r * ldb + j);
          else if (j >= N)
            v = make_float2(-INFINITY, -INFINITY);
          else if (r >= N)
            v = make_float2(0.f, 0.f);
          else
            v = __ldg(reinterpret_cast<const float2*>(
                bt + (long long)r * ldb + j));
          s[nt][2 * half] = v.x;
          s[nt][2 * half + 1] = v.y;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e < 2 ? r0 : r1, c = j + (e & 1);
          s[nt][e] = c >= N ? -INFINITY
                            : r >= N ? 0.f : __ldg(bt + (long long)r * ldb + c);
        }
      }
    }
}

// P32 of query rows [i0, i0+16) from the bias in s: S = bias + qs k^T (qs:
// the q tile's fragments scaled by scale_t and rounded; k over hd padded
// to 16, dkr chunks), softmax per row; rows >= N zeroed (they enter no
// gradient)
template <int KT>
__device__ __forceinline__ void sdpa_probs(float (&s)[2 * KT][4],
                                           const bf16* qt, const bf16* kt,
                                           int ldt, int i0, int N, int nkt,
                                           int dkr, float scale_t) {
#pragma unroll 2
  for (int kc = 0; kc < dkr; ++kc) {
    uint32_t aq[4];
    load_a_t(aq, qt, ldt, 16 * kc, i0);
    scale_a(aq, scale_t);
#pragma unroll
    for (int jp = 0; jp < KT; ++jp)
      if (jp < nkt) {
        uint32_t b[2][2];
        load_b_t(b, kt, ldt, 16 * kc, 16 * jp);
        mma_bf16(s[2 * jp], aq, b[0]);
        mma_bf16(s[2 * jp + 1], aq, b[1]);
      }
  }
  row_softmax<2 * KT>(s, 2 * nkt);
  const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int nt = 0; nt < 2 * KT; ++nt) {
    if (i0 + g >= N) s[nt][0] = s[nt][1] = 0.f;
    if (i0 + g + 8 >= N) s[nt][2] = s[nt][3] = 0.f;
  }
}

// the q, k, v tiles (and g's) of window w into three (four) consecutive
// (hdp, ldt) tiles
__device__ __forceinline__ void sdpa_load(bf16* tiles, int tile,
                                          const bf16* __restrict__ qkv,
                                          const bf16* __restrict__ g,
                                          long long w, int t, int h,
                                          int ntype, int heads, int hd, int N,
                                          int ldt, bool vec) {
  const long long wt = w * ntype + t, hdn = (long long)hd * N;
  const bf16* q = qkv + (wt * 3 * heads + h) * hdn;
  for (int i = 0; i < 3; ++i)
    load_rows(tiles + i * tile, ldt, q + i * heads * hdn, hd, N, vec);
  if (g) load_rows(tiles + 3 * tile, ldt, g + (wt * heads + h) * hdn, hd, N, vec);
  cp_async_commit();
}

template <int KT>
__global__ void __launch_bounds__(SDPA_THREADS(KT))
sdpa_mma_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                bf16* __restrict__ out, int nwin, int run, int ntype,
                int heads, int hd, int N, float scale_t, int nbuf, int vec) {
  constexpr bool kShared = KT <= 9;  // the bias slice in shared memory
  constexpr bool kOneSlab = KT <= 9;  // one row slab a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int np = pad16(N), nkt = np / 16, ldt = np + 8, ldb = np + 8;
  const int hdp = pad16(hd), dkr = hdp / 16;
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int th = blockIdx.x, t = th / heads, h = th % heads;
  const int w0 = blockIdx.y * run, w1 = min(nwin, w0 + run);
  const float* src = bias + (long long)th * N * N;
  float* bsm = reinterpret_cast<float*>(smem_raw);
  bf16* tiles = reinterpret_cast<bf16*>(
      smem_raw + (kShared ? (size_t)np * ldb * sizeof(float) : 0));
  const float* bt = kShared ? bsm : src;
  const int ldbt = kShared ? ldb : N;
  const int tile = hdp * ldt;
  zero_smem(tiles, (size_t)nbuf * 3 * tile * sizeof(bf16));
  if (kShared)
    for (int i = warp; i < np; i += nwarps)
      for (int j = threadIdx.x & 31; j < np; j += 32)
        bsm[i * ldb + j] = j >= N ? -INFINITY : i >= N ? 0.f : src[i * N + j];
  __syncthreads();  // zeros before the tile loads
  sdpa_load(tiles, tile, qkv, nullptr, w0, t, h, ntype, heads, hd, N, ldt, vec);
  for (int w = w0; w < w1; ++w) {
    const int buf = nbuf == 2 ? (w - w0) & 1 : 0;
    float s[2 * KT][4];
    if (kOneSlab)  // the bias does not wait for the tiles
      bias_init<2 * KT, kShared>(s, bt, ldbt, 16 * warp, N, 2 * nkt);
    if (nbuf == 2 && w + 1 < w1) {
      sdpa_load(tiles + (buf ^ 1) * 3 * tile, tile, qkv, nullptr, w + 1, t, h,
                ntype, heads, hd, N, ldt, vec);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // window w's tiles are in
    bf16* qt = tiles + buf * 3 * tile;
    const bf16 *kt = qt + tile, *vt = kt + tile;
    bf16* o_dst = out + (((long long)w * ntype + t) * heads + h) * hd * N;
    for (int sl = warp; sl < nkt; sl += nwarps) {
      const int i0 = 16 * sl;
      if (!kOneSlab) bias_init<2 * KT, kShared>(s, bt, ldbt, i0, N, 2 * nkt);
      sdpa_probs<KT>(s, qt, kt, ldt, i0, N, nkt, dkr, scale_t);
      for (int d0 = 0; d0 < hdp; d0 += 32) {  // o, 32 columns of hd at a time
        float o[4][4] = {};
#pragma unroll
        for (int jp = 0; jp < KT; ++jp)
          if (jp < nkt) {
            uint32_t ap[4];
            c_to_a(ap, s[2 * jp], s[2 * jp + 1]);  // P rounded to bf16
#pragma unroll
            for (int dc = 0; dc < 2; ++dc)
              if (d0 / 16 + dc < dkr) {
                uint32_t b[2][2];
                load_b_n(b, vt, ldt, 16 * jp, d0 + 16 * dc);
                mma_bf16(o[2 * dc], ap, b[0]);
                mma_bf16(o[2 * dc + 1], ap, b[1]);
              }
          }
        // o through this warp's own columns of the q tile (no other warp
        // reads them), rows d < hd and tokens < N only: the pads stay zero
        stage_t<4>(o, qt + d0 * ldt, ldt, i0, hd - d0, min(16, N - i0), 1.f);
      }
      __syncwarp();
      store_cols(qt, ldt, i0, o_dst, i0, hd, N, vec);
    }
    __syncthreads();  // every warp is done with this buffer
    if (nbuf == 1 && w + 1 < w1)
      sdpa_load(tiles, tile, qkv, nullptr, w + 1, t, h, ntype, heads, hd, N,
                ldt, vec);
  }
}

// The products after the row pass for a slab [m0, m0+16) of the (np, np)
// tile at and 32 columns d0.. of hd, each warp on its own slab: acc[0] =
// at^T b0 (dK = dS^T q_raw, dV = P^T dO) and, where kTwo, acc[1] = at b1
// (dQ = dS K); kOnly >= 0 computes that one of the two.  For np <= 144 the
// k loop is not unrolled: fewer fragments in flight keep the kernel within
// its 168 registers and ran faster than the unrolled loop.
template <int KT, bool kTwo, int kOnly = -1>
__device__ __forceinline__ void sdpa_slab(float (&acc)[2][4][4],
                                          const bf16* at, const bf16* b0,
                                          const bf16* b1, int ldt, int m0,
                                          int nkt, int d0, int dkr) {
  auto chunk = [&](int kc) {
    uint32_t a[2][4];
    if (kOnly != 1) load_a_t(a[0], at, ldt, 16 * kc, m0);
    if (kTwo && kOnly != 0) load_a_n(a[1], at, ldt, 16 * kc, m0);
#pragma unroll
    for (int dc = 0; dc < 2; ++dc) {
      if (d0 / 16 + dc >= dkr) continue;
#pragma unroll
      for (int p = 0; p < (kTwo ? 2 : 1); ++p) {
        if (kOnly >= 0 && p != kOnly) continue;
        uint32_t b[2][2];
        load_b_n(b, p ? b1 : b0, ldt, 16 * kc, d0 + 16 * dc);
        mma_bf16(acc[p][2 * dc], a[p], b[0]);
        mma_bf16(acc[p][2 * dc + 1], a[p], b[1]);
      }
    }
  };
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    if (kOnly >= 0 && p != kOnly) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      acc[p][i][0] = acc[p][i][1] = acc[p][i][2] = acc[p][i][3] = 0.f;
  }
  if (KT <= 9) {
#pragma unroll 1
    for (int kc = 0; kc < nkt; ++kc) chunk(kc);
  } else {
#pragma unroll
    for (int kc = 0; kc < KT; ++kc)
      if (kc < nkt) chunk(kc);
  }
}

// sdpa_slab's products times mul, rounded, to dst0 (and dst1), (hd, N)
// columns [m0, m0+16), 32 rows of hd at a time through the warp's scratch.
// For np > 144 (128 registers of logits in the row pass) the two products
// run one after the other, which keeps that kernel free of spills.
template <int KT, bool kTwo>
__device__ __forceinline__ void sdpa_out(const bf16* at, const bf16* b0,
                                         const bf16* b1, int ldt, int m0,
                                         int nkt, int dkr, bf16* scratch,
                                         bf16* dst0, bf16* dst1, int hd,
                                         int N, float mul, bool vec) {
  for (int d0 = 0; d0 < 16 * dkr; d0 += 32) {
    float acc[2][4][4];
    if (kTwo && KT > 9) {
      sdpa_slab<KT, kTwo, 0>(acc, at, b0, b1, ldt, m0, nkt, d0, dkr);
      sdpa_slab<KT, kTwo, 1>(acc, at, b0, b1, ldt, m0, nkt, d0, dkr);
    } else {
      sdpa_slab<KT, kTwo>(acc, at, b0, b1, ldt, m0, nkt, d0, dkr);
    }
    const int rows = min(32, hd - d0);
#pragma unroll
    for (int p = 0; p < (kTwo ? 2 : 1); ++p) {
      stage_t<4>(acc[p], scratch, SDPA_LDS, 0, rows, min(16, N - m0), mul);
      __syncwarp();
      store_cols(scratch, SDPA_LDS, 0, (p ? dst1 : dst0) + (long long)d0 * N,
                 m0, rows, N, vec);
      __syncwarp();  // the scratch is read before it is written again
    }
  }
}

// v added into the dbias partial in device memory at (r, c), (r, c+1) if
// they lie inside the N x N slice; the first window writes
__device__ __forceinline__ void dbias_add(float* db, int r, int c, int N,
                                          float v0, float v1, bool first) {
  if (r >= N) return;
  float* e = db + (long long)r * N + c;
  if (c + 1 < N && (N & 1) == 0) {
    float2* e2 = reinterpret_cast<float2*>(e);
    const float2 old = first ? make_float2(0.f, 0.f) : *e2;
    *e2 = make_float2(old.x + v0, old.y + v1);
  } else {
    if (c < N) e[0] = first ? v0 : e[0] + v0;
    if (c + 1 < N) e[1] = first ? v1 : e[1] + v1;
  }
}

template <int KT>
__global__ void __launch_bounds__(SDPA_THREADS(KT))
sdpa_mma_bwd_kernel(const bf16* __restrict__ qkv,
                    const float* __restrict__ bias, const bf16* __restrict__ g,
                    bf16* __restrict__ dqkv, float* __restrict__ dbias,
                    int nwin, int ntype, int heads, int hd, int N, float scale,
                    float scale_t, int nbuf, int db_shared, int vec) {
  constexpr bool kKeepP = KT <= 9;  // one slab a warp: P32 stays in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int np = pad16(N), nkt = np / 16, ldt = np + 8;
  const int hdp = pad16(hd), dkr = hdp / 16;
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int th = blockIdx.x, t = th / heads, h = th % heads;
  const float* btab = bias + (long long)th * N * N;
  float* dglob = dbias + (long long)th * N * N;
  unsigned char* p = smem_raw;
  float* db = reinterpret_cast<float*>(p);  // (np, ldt) where db_shared
  p += db_shared ? (size_t)np * ldt * sizeof(float) : 0;
  bf16* X = reinterpret_cast<bf16*>(p);  // dS, then P: (np, ldt)
  p += (size_t)np * ldt * sizeof(bf16);
  bf16* scratch = reinterpret_cast<bf16*>(p) + warp * 32 * SDPA_LDS;
  p += (size_t)nwarps * 32 * SDPA_LDS * sizeof(bf16);
  bf16* tiles = reinterpret_cast<bf16*>(p);
  const int tile = hdp * ldt;
  zero_smem(tiles, (size_t)nbuf * 4 * tile * sizeof(bf16));
  if (db_shared) zero_smem(db, (size_t)np * ldt * sizeof(float));
  __syncthreads();
  sdpa_load(tiles, tile, qkv, g, 0, t, h, ntype, heads, hd, N, ldt, vec);
  for (int w = 0; w < nwin; ++w) {
    const int buf = nbuf == 2 ? w & 1 : 0;
    float s[2 * KT][4];  // P32 of the warp's (last) slab
    if (kKeepP)  // the bias does not wait for the tiles
      bias_init<2 * KT, false>(s, btab, N, 16 * warp, N, 2 * nkt);
    if (nbuf == 2 && w + 1 < nwin) {
      sdpa_load(tiles + (buf ^ 1) * 4 * tile, tile, qkv, g, w + 1, t, h,
                ntype, heads, hd, N, ldt, vec);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // window w's tiles are in
    const bf16* qt = tiles + buf * 4 * tile;
    const bf16 *kt = qt + tile, *vt = kt + tile, *ot = vt + tile;
    const long long wt = (long long)w * ntype + t, hdn = (long long)hd * N;
    bf16* dq_dst = dqkv + (wt * 3 * heads + h) * hdn;

    // rows: P32, rowsum(dP P32), dS32 into dbias, dS into X
    for (int sl = warp; sl < nkt; sl += nwarps) {
      const int i0 = 16 * sl;
      if (!kKeepP) bias_init<2 * KT, false>(s, btab, N, i0, N, 2 * nkt);
      sdpa_probs<KT>(s, qt, kt, ldt, i0, N, nkt, dkr, scale_t);
      // dP of keys [16 jp, 16 jp + 16): dO V^T, dO's fragments read per
      // chunk (P32 takes the registers; for np > 144 the hd loop is not
      // unrolled, which keeps that kernel free of spills)
      auto dp_part = [&](float (&dp)[2][4], int jp, int kc) {
        uint32_t a[4], b[2][2];
        load_a_t(a, ot, ldt, 16 * kc, i0);
        load_b_t(b, vt, ldt, 16 * kc, 16 * jp);
        mma_bf16(dp[0], a, b[0]);
        mma_bf16(dp[1], a, b[1]);
      };
      auto dp_chunk = [&](float (&dp)[2][4], int jp) {
        if (KT <= 9) {
#pragma unroll 2
          for (int kc = 0; kc < dkr; ++kc) dp_part(dp, jp, kc);
        } else {
#pragma unroll 1
          for (int kc = 0; kc < dkr; ++kc) dp_part(dp, jp, kc);
        }
      };
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int jp = 0; jp < KT; ++jp)
        if (jp < nkt) {
          float dp[2][4] = {};
          dp_chunk(dp, jp);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float* pp = s[2 * jp + hh];
            rs0 += dp[hh][0] * pp[0] + dp[hh][1] * pp[1];
            rs1 += dp[hh][2] * pp[2] + dp[hh][3] * pp[3];
          }
        }
      rs0 = quad_sum(rs0);
      rs1 = quad_sum(rs1);
#pragma unroll
      for (int jp = 0; jp < KT; ++jp)
        if (jp < nkt) {
          float dp[2][4] = {};
          dp_chunk(dp, jp);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float* pp = s[2 * jp + hh];
            float* d = dp[hh];
            d[0] = pp[0] * (d[0] - rs0);
            d[1] = pp[1] * (d[1] - rs0);
            d[2] = pp[2] * (d[2] - rs1);
            d[3] = pp[3] * (d[3] - rs1);
            const int j = 16 * jp + 8 * hh + 2 * tq;
            if (db_shared) {  // (np, ldt), zeroed: the pads take zeros
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                float2* e = reinterpret_cast<float2*>(
                    db + (i0 + gq + 8 * half) * ldt + j);
                const float2 o = *e;
                *e = make_float2(o.x + d[2 * half], o.y + d[2 * half + 1]);
              }
            } else {
              dbias_add(dglob, i0 + gq, j, N, d[0], d[1], w == 0);
              dbias_add(dglob, i0 + gq + 8, j, N, d[2], d[3], w == 0);
            }
            *reinterpret_cast<uint32_t*>(X + (i0 + gq) * ldt + j) =
                pack_bf16(d[0], d[1]);
            *reinterpret_cast<uint32_t*>(X + (i0 + gq + 8) * ldt + j) =
                pack_bf16(d[2], d[3]);
          }
        }
    }
    __syncthreads();  // X holds dS (rounded)

    // per slab of 16 keys dK = scale dS^T q_raw, and of 16 query rows dQ =
    // scale dS K
    for (int sl = warp; sl < nkt; sl += nwarps)
      sdpa_out<KT, true>(X, qt, kt, ldt, 16 * sl, nkt, dkr, scratch,
                         dq_dst + heads * hdn, dq_dst, hd, N, scale, vec);
    __syncthreads();  // X is read

    // P rounded into X
    for (int sl = warp; sl < nkt; sl += nwarps) {
      const int i0 = 16 * sl;
      if (!kKeepP) {
        bias_init<2 * KT, false>(s, btab, N, i0, N, 2 * nkt);
        sdpa_probs<KT>(s, qt, kt, ldt, i0, N, nkt, dkr, scale_t);
      }
#pragma unroll
      for (int nt = 0; nt < 2 * KT; ++nt) {
        if (nt >= 2 * nkt) continue;
        const int j = 8 * nt + 2 * tq;
        *reinterpret_cast<uint32_t*>(X + (i0 + gq) * ldt + j) =
            pack_bf16(s[nt][0], s[nt][1]);
        *reinterpret_cast<uint32_t*>(X + (i0 + gq + 8) * ldt + j) =
            pack_bf16(s[nt][2], s[nt][3]);
      }
    }
    __syncthreads();  // X holds P

    // keys: dV = P^T dO
    for (int sl = warp; sl < nkt; sl += nwarps)
      sdpa_out<KT, false>(X, ot, nullptr, ldt, 16 * sl, nkt, dkr, scratch,
                          dq_dst + 2 * heads * hdn, nullptr, hd, N, 1.f, vec);
    __syncthreads();  // every warp is done with this buffer and X
    if (nbuf == 1 && w + 1 < nwin)
      sdpa_load(tiles, tile, qkv, g, w + 1, t, h, ntype, heads, hd, N, ldt,
                vec);
  }
  if (db_shared)
    for (int i = warp; i < N; i += nwarps)
      for (int j = lane; j < N; j += 32) dglob[i * N + j] = db[i * ldt + j];
}

// ---- host side ------------------------------------------------------------------
//
// The file builds as two objects compiled in parallel (_build.py): with
// SDPA_PART 1 only the np > 144 instantiations of the bf16 kernels, which
// take most of its compile time, and their accessor; with SDPA_PART 0
// everything else.  Without SDPA_PART it builds whole.

typedef void (*SdpaFwdKernel)(const bf16*, const float*, bf16*, int, int, int,
                              int, int, int, float, int, int);
typedef void (*SdpaBwdKernel)(const bf16*, const float*, const bf16*, bf16*,
                              float*, int, int, int, int, int, float, float,
                              int, int, int);

// the np > 144 kernels
void sdpa_wide_kernels(SdpaFwdKernel* fwd, SdpaBwdKernel* bwd);

#if !defined(SDPA_PART) || SDPA_PART == 1
void sdpa_wide_kernels(SdpaFwdKernel* fwd, SdpaBwdKernel* bwd) {
  *fwd = sdpa_mma_kernel<16>;
  *bwd = sdpa_mma_bwd_kernel<16>;
}
#endif

#if !defined(SDPA_PART) || SDPA_PART == 0

// the launch plan of a bf16 kernel at (hd, N): the template's key chunks,
// warps, tile buffers (2: double-buffered), the bias (forward) or dbias
// partial (backward) in shared memory, dynamic shared bytes; smem 0 where
// the kernels cannot take the shape
struct SdpaPlan {
  int kt, warps, nbuf, shared;
  size_t smem;
};

inline SdpaPlan sdpa_plan(bool bwd, int hd, int N, size_t max_smem) {
  SdpaPlan p{};
  if (hd < 1 || N < 1 || N > 256) return p;
  const int np = pad16(N), ldt = np + 8, hdp = pad16(hd);
  // nine warps leave 168 registers a thread, enough for the 16 x 144 logits
  // a warp keeps; past 144 tokens eight warps stride over the slabs
  p.kt = np <= 144 ? 9 : 16;
  p.warps = p.kt == 9 ? np / 16 : 8;
  const size_t tile = (size_t)hdp * ldt * sizeof(bf16);
  const size_t table = (size_t)np * ldt * sizeof(float);
  const size_t fixed =
      bwd ? (size_t)np * ldt * sizeof(bf16) +
                (size_t)p.warps * 32 * SDPA_LDS * sizeof(bf16)
          : 0;
  for (int shared = 1; shared >= 0; --shared) {
    if (!bwd && shared != (p.kt == 9)) continue;
    for (int nbuf = 2; nbuf >= 1; --nbuf) {
      const size_t s =
          (shared ? table : 0) + fixed + nbuf * (bwd ? 4 : 3) * tile;
      if (s <= max_smem) {
        p.nbuf = nbuf, p.shared = shared, p.smem = s;
        return p;
      }
    }
  }
  return p;
}

inline size_t max_smem_optin() {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (size_t)v;
}

// the kernels of a plan
inline void sdpa_kernels(int kt, SdpaFwdKernel* fwd, SdpaBwdKernel* bwd) {
  if (kt != 9) return sdpa_wide_kernels(fwd, bwd);
  *fwd = sdpa_mma_kernel<9>;
  *bwd = sdpa_mma_bwd_kernel<9>;
}

// the plan with its kernel's shared-memory limit raised, and the blocks of
// it one SM holds
inline cudaError_t sdpa_prepare(bool bwd, int hd, int N, SdpaPlan& p,
                                int* per_sm) {
  p = sdpa_plan(bwd, hd, N, max_smem_optin());
  if (!p.smem) return cudaErrorInvalidValue;
  SdpaFwdKernel f;
  SdpaBwdKernel b;
  sdpa_kernels(p.kt, &f, &b);
  const void* fn = bwd ? (const void*)b : (const void*)f;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (e != cudaSuccess || !per_sm) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn,
                                                       32 * p.warps, p.smem);
}

inline bool aligned16(const void* a) {
  return ((uintptr_t)a & 15) == 0;
}

int sdpa_bf16(const void* qkv, const void* bias, void* out, int nwin,
              int ntype, int heads, int hd, int N, cudaStream_t st) {
  if (nwin < 1) return (int)cudaErrorInvalidValue;
  SdpaPlan p;
  int per_sm = 0, sms = 0, dev = 0;
  cudaError_t e = sdpa_prepare(false, hd, N, p, &per_sm);
  if (e != cudaSuccess) return (int)e;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // split a pair's windows only where the pairs alone fill the card less
  // than twice
  const long long pairs = (long long)ntype * heads;
  const long long want = 2LL * sms * (per_sm > 0 ? per_sm : 1);
  int splits = pairs >= want ? 1 : (int)std::min<long long>(
                                       nwin, (want + pairs - 1) / pairs);
  const int run = (nwin + splits - 1) / splits;
  splits = (nwin + run - 1) / run;
  const int vec = N % 8 == 0 && aligned16(qkv) && aligned16(out);
  const float scale_t = round_host<bf16>(attn_scale(hd));
  dim3 grid((unsigned)pairs, splits);
  SdpaFwdKernel kernel;
  SdpaBwdKernel unused;
  sdpa_kernels(p.kt, &kernel, &unused);
  kernel<<<grid, 32 * p.warps, p.smem, st>>>(
      (const bf16*)qkv, (const float*)bias, (bf16*)out, nwin, run, ntype,
      heads, hd, N, scale_t, p.nbuf, vec);
  return (int)cudaGetLastError();
}

int sdpa_bwd_bf16(const void* qkv, const void* bias, const void* g,
                  void* dqkv, void* dbias, int nwin, int ntype, int heads,
                  int hd, int N, cudaStream_t st) {
  SdpaPlan p;
  cudaError_t e = sdpa_prepare(true, hd, N, p, nullptr);
  if (e != cudaSuccess) return (int)e;
  const int vec = N % 8 == 0 && aligned16(qkv) && aligned16(g) &&
                  aligned16(dqkv);
  const float scale_t = round_host<bf16>(attn_scale(hd));
  const unsigned grid = (unsigned)((long long)ntype * heads);
  SdpaFwdKernel unused;
  SdpaBwdKernel kernel;
  sdpa_kernels(p.kt, &unused, &kernel);
  kernel<<<grid, 32 * p.warps, p.smem, st>>>(
      (const bf16*)qkv, (const float*)bias, (const bf16*)g, (bf16*)dqkv,
      (float*)dbias, nwin, ntype, heads, hd, N, attn_scale(hd), scale_t,
      p.nbuf, p.shared, vec);
  return (int)cudaGetLastError();
}
#endif  // SDPA_PART 0

}  // namespace pangu

using namespace pangu;

#if !defined(SDPA_PART) || SDPA_PART == 0

// The bf16 kernels' plan at (hd, n) on the current device: what 0 = dynamic
// shared bytes (0: the kernels cannot take the shape), 1 = blocks per SM, 2
// = threads per block, 3 = tile buffers, 4 = the bias (forward) or the dbias
// partial (backward) in shared memory; bwd 0 = sdpa, 1 = sdpa_bwd.
extern "C" long long pangu_sdpa_ws(int bwd, int hd, int n, int what) {
  SdpaPlan p;
  int per_sm = 0;
  if (what == 1) {
    if (sdpa_prepare(bwd != 0, hd, n, p, &per_sm) != cudaSuccess) return -1;
  } else {
    p = sdpa_plan(bwd != 0, hd, n, max_smem_optin());
  }
  switch (what) {
    case 0: return (long long)p.smem;
    case 1: return per_sm;
    case 2: return 32LL * p.warps;
    case 3: return p.nbuf;
    case 4: return p.shared;
  }
  return -1;
}

// dtype codes: 0 = float32, 1 = bfloat16 (qkv, out, g, dqkv); bias and dbias
// float32.  Returns a cudaError_t (0 = ok).
extern "C" int pangu_sdpa(int dtype, const void* qkv, const void* bias,
                          void* out, int nwin, int ntype, int heads, int hd,
                          int n, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return sdpa_bf16(qkv, bias, out, nwin, ntype, heads, hd, n, st);
  if (n > 32 * ATT_MAXJ) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return sdpa<float>(qkv, bias, out, nwin, ntype, heads, hd, n, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int pangu_sdpa_bwd(int dtype, const void* qkv, const void* bias,
                              const void* g, void* dqkv, void* dbias, int nwin,
                              int ntype, int heads, int hd, int n,
                              void* stream) {
  if (nwin < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return sdpa_bwd_bf16(qkv, bias, g, dqkv, dbias, nwin, ntype, heads, hd, n,
                         st);
  if (n > 32 * ATT_MAXJ) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return sdpa_bwd<float>(qkv, bias, g, dqkv, dbias, nwin, ntype, heads, hd, n, st);
  return (int)cudaErrorInvalidValue;
}
#endif  // SDPA_PART 0
