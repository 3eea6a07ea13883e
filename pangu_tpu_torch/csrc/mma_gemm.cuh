// The bf16 products on the tensor cores of
//   block_wm.cu    the block kernel's four (fwd_gemm),
//   block_tail.cu  the block tail's two (fwd_gemm),
//   block_bwd.cu   the block backward's (unit_gemm, unit_wgrad),
//   grid_attn.cu   the grid attention's (its qkv product through
//                  fwd_gemm, the rest unit_gemm, unit_wgrad),
//   recovery_bwd.cu  the recovery backward's token cotangents (mma_gemm)
//                  and weight gradients (mma_gemm_launch, transposed A;
//                  bf16 only: its float32 route is its own),
//   updown_wm.cu   DownSample's and UpSample's products (mma_gemm with
//                  PadEpi; bf16 only: their float32 route is their own),
//   updown.cu      the canonical UpSample's products (mma_gemm with
//                  RoundEpi; bf16 only),
//   embed_dw.cu    the upper embed's weight and bias gradient
//                  (mma_gemm_launch, transposed A, the bias row an
//                  indicator column of A; bf16 only),
// and the dispatches that keep float32 on the first version's kernels:
// unit_gemm / unit_wgrad (float32 on grad_gemm.cuh) and fwd_gemm (float32
// on common.cuh's gemm, so the float32 outputs stay bit for bit).
//
//   mma_gemm<kBT>(a, b, M, N, K, epi): out (M x N) = a (M x K, row-major)
//     times b, where b is (K x N) row-major or, kBT, the transpose of a
//     row-major (N x K) matrix (a dense layer's weight: a data gradient
//     multiplies by it transposed); each group of 8 columns goes through
//     epi(0, r, c, v[8]);
//   mma_wgrad(a, Ka, b, N, rows, part, out): out ((Ka + 1) x N, float32) =
//     the sum over rows of [a(r, :), 1]^T b(r, :): a weight gradient with
//     its bias gradient as the last row.  Each split of WG_SPLIT_ROWS rows
//     writes its own float32 partial and split_sum adds them in split
//     order, so the sums are the same bit for bit in every run (no atomics).
//
// What bounds these products on an H100: bytes.  At K = C most of them do
// about 140 FLOP per byte of device memory they must move, under the card's
// ~295 in bf16, so the design moves each operand once and keeps the tensor
// cores fed, rather than chasing the peak rate: mma.sync is enough for that
// (wgmma and TMA buy issue rate, which is not what limits them).
//
// Design: one CTA of 2 x 2 warps computes a 128 x 96 tile of the output
// (every N of the model is a multiple of 96; of the tiles measured on the
// H100 -- 64 x 192 with four or eight warps, 128 x 192 with eight, three or
// four stages -- this one ran the block backward's products fastest, 7%
// ahead of 64 x 192).  Each warp owns 64 rows x 48 columns: 4 x 6 m16n8k16
// products per 16-deep step, float32 accumulators in registers (168
// registers, three CTAs a SM).
// Operands come from pointer + leading dimension: 16-byte cp.async copies
// into a ring of MG_STAGES shared stages (zero-filled past the edges), read
// by ldmatrix, .trans where the operand is stored with k along its rows (a
// weight gradient's activations read transposed, a row-major b).  The
// epilogue stages each warp's accumulators, 16 rows at a time, through its
// own float32 scratch in the (then idle) stages and hands the functor 8
// consecutive columns: 16-byte loads and stores of the activations.
// Requirements (the C entries check them): N, K and Ka multiples of 8, the
// operands 16-byte aligned.
#pragma once

#include <initializer_list>
#include <type_traits>

#include "attn_bwd.cuh"
#include "attn_mma.cuh"
#include "grad_gemm.cuh"

namespace pangu {

constexpr int MG_WM = 2, MG_WN = 2;  // warps along the rows, the columns
constexpr int MG_WARPS = MG_WM * MG_WN, MG_MINB = 3;  // CTAs a SM at least
constexpr int MG_STAGES = 3;
constexpr int MG_MT = 4;  // m16 tiles of a warp (its 16 MG_MT rows)
constexpr int MG_BM = 16 * MG_MT * MG_WM, MG_BN = 96, MG_BK = 32;
constexpr int MG_NT = MG_BN / MG_WN / 8;  // n8 tiles of a warp
constexpr int MG_LDE = 8 * MG_NT + 4;  // float row stride of a warp's scratch

// shared elements of a stage's A tile: (BM, BK) with m along the rows, or
// (BK, BM) transposed; of its B tile: (BK, BN) row-major, or (BN, BK)
template <bool kAT>
__host__ __device__ constexpr int mg_a_ld() { return kAT ? MG_BM + 8 : MG_BK + 8; }
template <bool kAT>
__host__ __device__ constexpr int mg_a_elems() {
  return kAT ? MG_BK * (MG_BM + 8) : MG_BM * (MG_BK + 8);
}
template <bool kBT>
__host__ __device__ constexpr int mg_b_ld() { return kBT ? MG_BK + 8 : MG_BN + 8; }
template <bool kBT>
__host__ __device__ constexpr int mg_b_elems() {
  return kBT ? MG_BN * (MG_BK + 8) : MG_BK * (MG_BN + 8);
}
template <bool kAT, bool kBT>
constexpr size_t mg_smem() {
  return (size_t)MG_STAGES * (mg_a_elems<kAT>() + mg_b_elems<kBT>()) *
         sizeof(bf16);
}
static_assert(MG_NT % 2 == 0, "a warp's columns come in pairs of n8 tiles");
static_assert(MG_WARPS * 16 * MG_LDE * sizeof(float) <= mg_smem<true, false>(),
              "the epilogue scratch fits in the stages");

// 16 bytes src -> dst, or 16 zero bytes where !valid (src not read)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 8 bytes src -> dst, or 8 zero bytes where !valid (src not read); .ca, as
// .cg takes 16-byte copies only
__device__ __forceinline__ void cp_async8_zfill(void* dst, const void* src,
                                                bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

// A's k-slice [k0, k0 + BK) of output rows [m0, m0 + BM), by the whole
// block.  !kAT: element (m, k) = a[m * lda + k], m < M.  kAT (a weight
// gradient): element (i, r) = a[r * lda + i] for columns i < acols; column
// acols reads 1 where ``ones`` (the bias gradient's row), the rest 0.  k
// beyond kend reads 0.
template <bool kAT>
__device__ __forceinline__ void mg_load_a(bf16* s, const bf16* __restrict__ a,
                                          long long lda, int acols, int ones,
                                          long long M, long long m0,
                                          long long k0, long long kend) {
  if (!kAT) {
    for (int idx = threadIdx.x; idx < MG_BM * MG_BK / 8; idx += blockDim.x) {
      const int r = idx / (MG_BK / 8), c = idx % (MG_BK / 8) * 8;
      const bool ok = m0 + r < M && k0 + c < kend;
      cp_async16_zfill(s + r * mg_a_ld<false>() + c,
                       ok ? a + (m0 + r) * lda + k0 + c : a, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < MG_BK * MG_BM / 8; idx += blockDim.x) {
      const int r = idx / (MG_BM / 8), c = idx % (MG_BM / 8) * 8;
      bf16* d = s + r * mg_a_ld<true>() + c;
      const long long i = m0 + c, row = k0 + r;
      if (i < acols) {
        const bool ok = row < kend;
        cp_async16_zfill(d, ok ? a + row * lda + i : a, ok);
      } else {  // a constant chunk: no copy in flight writes it
        *reinterpret_cast<uint4*>(d) =
            make_uint4(i == acols && ones ? 0x3F80u : 0u, 0u, 0u, 0u);
      }
    }
  }
}

// B's k-slice [k0, k0 + BK) of output columns [n0, n0 + BN): !kBT element
// (k, n) = b[k * ldb + n]; kBT element (k, n) = b[n * ldb + k]; n < N
template <bool kBT>
__device__ __forceinline__ void mg_load_b(bf16* s, const bf16* __restrict__ b,
                                          long long ldb, int N, int n0,
                                          long long k0, long long kend) {
  if (!kBT) {
    for (int idx = threadIdx.x; idx < MG_BK * MG_BN / 8; idx += blockDim.x) {
      const int r = idx / (MG_BN / 8), c = idx % (MG_BN / 8) * 8;
      const bool ok = k0 + r < kend && n0 + c < N;
      cp_async16_zfill(s + r * mg_b_ld<false>() + c,
                       ok ? b + (k0 + r) * ldb + n0 + c : b, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < MG_BN * MG_BK / 8; idx += blockDim.x) {
      const int r = idx / (MG_BK / 8), c = idx % (MG_BK / 8) * 8;
      const bool ok = n0 + r < N && k0 + c < kend;
      cp_async16_zfill(s + r * mg_b_ld<true>() + c,
                       ok ? b + (long long)(n0 + r) * ldb + k0 + c : b, ok);
    }
  }
}

// out tile (m, n) = sum over k in the block's split [z kchunk, (z+1) kchunk)
// of A(m, k) B(k, n), handed to epi(z, m, n..n+7, v); row tiles on
// gridDim.y (a block takes blockIdx.y, blockIdx.y + gridDim.y, ...),
// column tiles on gridDim.x, splits on gridDim.z
template <bool kAT, bool kBT, typename Epi>
__global__ void __launch_bounds__(32 * MG_WARPS, MG_MINB)
mma_gemm_kernel(const bf16* __restrict__ a, long long lda, int acols,
                int ones, const bf16* __restrict__ b, long long ldb,
                long long M, int N, long long K, long long kchunk, Epi epi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sa = reinterpret_cast<bf16*>(smem_raw);
  bf16* sb = sa + MG_STAGES * mg_a_elems<kAT>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = 16 * MG_MT * (warp / MG_WN), wn = 8 * MG_NT * (warp % MG_WN);
  const int n0 = blockIdx.x * MG_BN;
  const long long kbeg = blockIdx.z * kchunk;
  const long long kend = min(K, kbeg + kchunk);
  const int nk = (int)((kend - kbeg + MG_BK - 1) / MG_BK);
  float* scratch = reinterpret_cast<float*>(smem_raw) + warp * 16 * MG_LDE;

  for (long long mt = blockIdx.y; mt * MG_BM < M; mt += gridDim.y) {
    const long long m0 = mt * MG_BM;
    auto load = [&](int stage, int kt) {
      const long long k0 = kbeg + (long long)kt * MG_BK;
      mg_load_a<kAT>(sa + stage * mg_a_elems<kAT>(), a, lda, acols, ones, M,
                     m0, k0, kend);
      mg_load_b<kBT>(sb + stage * mg_b_elems<kBT>(), b, ldb, N, n0, k0,
                     kend);
    };
    float acc[MG_MT][MG_NT][4];
#pragma unroll
    for (int i = 0; i < MG_MT; ++i)
#pragma unroll
      for (int j = 0; j < MG_NT; ++j)
        acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
#pragma unroll
    for (int s = 0; s < MG_STAGES - 1; ++s) {
      if (s < nk) load(s, s);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<MG_STAGES - 2>();
      __syncthreads();  // stage kt is in; stage kt - 1 is read by every warp
      if (kt + MG_STAGES - 1 < nk)
        load((kt + MG_STAGES - 1) % MG_STAGES, kt + MG_STAGES - 1);
      cp_async_commit();
      const bf16* as = sa + (kt % MG_STAGES) * mg_a_elems<kAT>();
      const bf16* bs = sb + (kt % MG_STAGES) * mg_b_elems<kBT>();
#pragma unroll
      for (int kk = 0; kk < MG_BK; kk += 16) {
        uint32_t af[MG_MT][4], bfr[MG_NT / 2][2][2];
#pragma unroll
        for (int i = 0; i < MG_MT; ++i) {
          if (kAT)
            load_a_t(af[i], as, mg_a_ld<kAT>(), kk, wm + 16 * i);
          else
            load_a_n(af[i], as, mg_a_ld<kAT>(), kk, wm + 16 * i);
        }
#pragma unroll
        for (int j = 0; j < MG_NT / 2; ++j) {
          const int nn = wn + 16 * j;
          if (kBT)
            load_b_n(bfr[j], bs, mg_b_ld<kBT>(), kk, nn);
          else
            load_b_t(bfr[j], bs, mg_b_ld<kBT>(), kk, nn);
        }
#pragma unroll
        for (int i = 0; i < MG_MT; ++i)
#pragma unroll
          for (int j = 0; j < MG_NT; ++j)
            mma_bf16(acc[i][j], af[i], bfr[j >> 1][j & 1]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the stages are free: the warps' scratch

#pragma unroll
    for (int i = 0; i < MG_MT; ++i) {
#pragma unroll
      for (int j = 0; j < MG_NT; ++j) {
        const int col = 8 * j + 2 * t;
        *reinterpret_cast<float2*>(scratch + g * MG_LDE + col) =
            make_float2(acc[i][j][0], acc[i][j][1]);
        *reinterpret_cast<float2*>(scratch + (g + 8) * MG_LDE + col) =
            make_float2(acc[i][j][2], acc[i][j][3]);
      }
      __syncwarp();
      for (int idx = lane; idx < 16 * MG_NT; idx += 32) {
        const int r = idx / MG_NT, ch = idx % MG_NT;
        const long long gr = m0 + wm + 16 * i + r;
        const int gc = n0 + wn + 8 * ch;
        if (gr < M && gc < N) {
          const float4 lo =
              *reinterpret_cast<const float4*>(scratch + r * MG_LDE + 8 * ch);
          const float4 hi = *reinterpret_cast<const float4*>(
              scratch + r * MG_LDE + 8 * ch + 4);
          const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
          epi((int)blockIdx.z, gr, gc, v);
        }
      }
      __syncwarp();  // the scratch is read before it is written again
    }
    __syncthreads();  // the scratch is read before the next tile's loads
  }
}

template <bool kAT, bool kBT, typename Epi>
inline cudaError_t mma_gemm_launch(const bf16* a, long long lda, int acols,
                                   int ones, const bf16* b, long long ldb,
                                   long long M, int N, long long K,
                                   long long kchunk, int splits, Epi epi,
                                   cudaStream_t st) {
  const size_t smem = mg_smem<kAT, kBT>();
  cudaError_t e = cudaFuncSetAttribute(
      mma_gemm_kernel<kAT, kBT, Epi>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((N + MG_BN - 1) / MG_BN, xgemm_row_blocks(M, MG_BM), splits);
  mma_gemm_kernel<kAT, kBT, Epi><<<grid, 32 * MG_WARPS, smem, st>>>(
      a, lda, acols, ones, b, ldb, M, N, K, kchunk, epi);
  return cudaGetLastError();
}

template <bool kBT, typename Epi>
inline cudaError_t mma_gemm(const bf16* a, const bf16* b, long long M, int N,
                            int K, Epi epi, cudaStream_t st) {
  return mma_gemm_launch<false, kBT>(a, K, K, 0, b, kBT ? K : N, M, N, K, K,
                                     1, epi, st);
}

inline cudaError_t mma_wgrad(const bf16* a, int Ka, const bf16* b, int N,
                             long long rows, float* part, float* out,
                             cudaStream_t st) {
  const int splits = wg_splits(rows);
  cudaError_t e = mma_gemm_launch<true, false>(
      a, Ka, Ka, 1, b, N, Ka + 1, N, rows, WG_SPLIT_ROWS, splits,
      SplitStore{part, Ka + 1, N}, st);
  if (e != cudaSuccess) return e;
  split_sum(part, out, (long long)(Ka + 1) * N, splits, st);
  return cudaGetLastError();
}

// n / d and n % d for 0 <= n < 2^31 by a multiply-high, an add and a
// shift, d (> 0, < 2^31) fixed per launch: the magic number and the shift
// are worked out on the host (Granlund and Montgomery; PyTorch's
// IntDivider does the same)
struct FastDiv {
  unsigned d = 1, magic = 1, shift = 0;
  FastDiv() = default;
  explicit FastDiv(unsigned d_) : d(d_ ? d_ : 1) {
    while ((1u << shift) < d) ++shift;
    magic = (unsigned)(((1ull << 32) * ((1ull << shift) - d)) / d + 1);
  }
  __device__ __forceinline__ unsigned div(unsigned n) const {
    return (__umulhi(n, magic) + n) >> shift;
  }
  __device__ __forceinline__ unsigned mod(unsigned n) const {
    return n - div(n) * d;
  }
};

// out = round_T(acc), the rows ``pad`` flags (common.cuh's PadRows: the
// latitude padding of window-major storage, canon_add >= -hp) written as
// zeros; pad.enabled 0 keeps every row.  Below row 2^31 the test runs on
// FastDivs: is_pad_row's 64-bit divisions, once per 8 columns, took a
// third of UpSample's C' x C' product (0.121 of 0.355 ms at full width on
// an H100 80GB HBM3).
template <typename T>
struct PadEpi {
  T* out;
  int N;
  PadRows pad;
  FastDiv lat_rows, nlat, tokens, ww, wh, hp;  // lat_rows = tokens x nlon
  PadEpi(T* out_, int N_, const PadRows& p)
      : out(out_), N(N_), pad(p), lat_rows(p.s.n * p.s.nlon), nlat(p.s.nlat),
        tokens(p.s.n), ww(p.s.ww), wh(p.s.wh), hp(p.hp) {}
  __device__ bool pad_row(long long r) const {
    if (!pad.enabled) return false;
    if (r >> 31) return is_pad_row(r, pad);
    const unsigned m = (unsigned)r;
    const unsigned lat =
        wh.d * nlat.mod(lat_rows.div(m)) + wh.mod(ww.div(tokens.mod(m)));
    return (int)hp.mod(lat + pad.canon_add + pad.hp) >= pad.h_real;
  }
  __device__ void operator()(int, long long r, int c,
                             const float (&v)[8]) const {
    if (pad_row(r)) {
      const float zero[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      st8(out + r * N + c, zero);
    } else {
      st8(out + r * N + c, v);
    }
  }
};

// every pointer 16-byte aligned (the tiles' cp.async copies need it)
inline bool aligned16_all(std::initializer_list<const void*> ps) {
  for (const void* p : ps)
    if ((uintptr_t)p & 15) return false;
  return true;
}

// ---- the forward's products, by dtype -------------------------------------------

// out = round_T(a w + bias), through GELU (common.cuh's Act: erf or tanh,
// rounded before and after, ZhEpi writing h only) where act says: bf16 on
// the tensor cores, float32 on common.cuh's FMA tiles
template <typename T>
inline int fwd_gemm(const T* a, const T* w, const T* bias, T* out,
                    long long M, int N, int K, int act, cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (act == ACT_NONE)
      return (int)mma_gemm<false>(a, w, M, N, K, BiasEpi<T>{bias, out, N}, st);
    return (int)mma_gemm<false>(
        a, w, M, N, K,
        ZhEpi<T>{bias, nullptr, out, N, act == ACT_GELU_TANH ? 1 : 0}, st);
  } else {
    const PadRows none = {0};
    gemm(a, w, bias, out, (int)M, N, K, act, none, st);
    return (int)cudaGetLastError();
  }
}

// ---- the backward units' products, by dtype ------------------------------------

// out = a b through epi (see mma_gemm): bf16 on the tensor cores, float32 on
// grad_gemm.cuh's FMA tiles
template <bool kBT, typename T, typename Epi>
inline int unit_gemm(const T* a, const T* b, long long M, int N, int K,
                     Epi epi, cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value) {
    return (int)mma_gemm<kBT>(a, b, M, N, K, epi, st);
  } else if constexpr (kBT) {
    xgemm((T*)nullptr, M, N, K, ARows<T>{a, K}, BCols<T>{b, K}, epi, st);
  } else {
    xgemm((T*)nullptr, M, N, K, ARows<T>{a, K}, BRows<T>{b, N}, epi, st);
  }
  return (int)cudaGetLastError();
}

// out ((Ka + 1) x N) = the weight and bias gradient (see mma_wgrad)
template <typename T>
inline int unit_wgrad(const T* a, int Ka, const T* b, int N, long long rows,
                      float* part, float* out, cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value) {
    return (int)mma_wgrad(a, Ka, b, N, rows, part, out, st);
  } else {
    wgrad<T>(rows, Ka + 1, N, ACols<T>{a, Ka, 1}, BRows<T>{b, N}, part, out,
             st);
    return (int)cudaGetLastError();
  }
}

}  // namespace pangu
