// The bf16 edge products on the tensor cores:
//   transition_wm.cu  the token-space transition (one of six matrices per
//                     group, the bias field added after the first rounding);
//   recovery_wm.cu    the patch recovery, upper and surface branches (one
//                     matrix, the bias added in float32, the features
//                     scattered into the field and cropped);
//   embed_wm.cu       the patch embed's upper planes (one matrix, the bias
//                     added in float32, whole rows of wm storage out).
// The first two read the rolled window-major skip/decoder pair (PairA), the
// embed gathers the field's patches (EmbedMma).  Their float32 routes stay
// on edge_gemm.cuh's first kernels.
//
// A group is one (batch, token plane, token-lat row) of the stage-0 grid, as
// in edge_gemm.cuh: its M rows are that row's longitude tokens, all of one
// token type, so one CTA, which covers rows of one group only, multiplies by
// one matrix.  The Op loads the A rows: row r of group g reads the pair's
// storage row that holds its canonical token (rolled_row), whose K = 2C
// features are [skip | dec] of that row, or the embed's patch of token r;
// the output goes where the Op puts it.
//
// What bounds these products on an H100: at full width the transition does
// 7.7e10 FLOP on 812 MB (the pair, the bias field, the output), the upper
// recovery 5.6e10 on 485 MB and the embed 3.4e10 on 368 MB, ~90-115 FLOP
// per byte against the ~295 at which the tensor cores would bind, so bytes
// bound them, but at the ~150-210 TFLOP/s that mma.sync products reach here
// the products take longer than the bytes: the design reads each operand
// once and keeps the tensor cores fed.
//
// Design: one CTA of kWM x kWN warps computes a BM x BN tile (BN the whole
// output width at full width: 192 for the transition and the embed, 160 and
// 64 for the recovery's branches), so each gathered A row is read from
// device memory once.  Once per CTA the rows' source offsets (and their
// destinations) go into a table in shared memory; a cp.async ring like
// mma_gemm.cuh's is fed from it by the Op's load_a (the pair: 16-byte
// copies, a chunk lying wholly in skip or wholly in dec, C being a multiple
// of 8; the embed: 8-byte copies of 4 w_off values) and the kernel's B
// loader, and read by ldmatrix into m16n8k16 products with float32
// accumulators.  Two CTAs of 8 warps a SM (128 registers) ran the
// transition and the upper recovery fastest on an H100: one CTA without the
// cap took 1.5x as long, three of 4 warps (64-row tiles) 1.2x.  The
// epilogue rounds the tile into shared memory (over the idle ring, Op::pre
// giving the value to round) and the Op writes it from there 16 bytes a
// lane: whole output rows for the transition and the embed, lines of
// consecutive longitudes of the field for the recovery.
// Requirements (the C entries check them): C and N multiples of 8, every
// operand 16-byte aligned.
#pragma once

#include "edge_gemm.cuh"
#include "mma_gemm.cuh"

namespace pangu {

constexpr int EM_BK = 32, EM_STAGES = 3;

// a CTA of kWM x kWN warps, each 16 kMT rows x 8 kNT columns of the tile;
// at least kMinB CTAs a SM
template <int kWM, int kWN, int kMT, int kNT, int kMinB>
struct EmTile {
  static constexpr int WM = kWM, WN = kWN, MT = kMT, NT = kNT, MINB = kMinB;
  static constexpr int THREADS = 32 * kWM * kWN;
  static constexpr int BM = 16 * kMT * kWM, BN = 8 * kNT * kWN;
  // shared row strides (elements): odd multiples of 16 bytes (ldmatrix)
  static constexpr int A_LD = EM_BK + 8, B_LD = BN + 8;
  static constexpr int A_ELEMS = BM * A_LD, B_ELEMS = EM_BK * B_LD;
  static constexpr size_t RING =
      (size_t)EM_STAGES * (A_ELEMS + B_ELEMS) * sizeof(bf16);
  static constexpr size_t SMEM = RING + 2 * BM * sizeof(long long);
  static_assert(kNT % 2 == 0, "a warp's columns come in pairs of n8 tiles");
};

// An Op (TransitionMma, RecoveryMma, EmbedMma) describes one product:
//   using Tile = EmTile<...>;  static constexpr int kOutLd;  the staged
//                              tile's row stride (elements)
//   int K, N, M;  long long groups;   depth, width, rows a group, groups
//   bool active(int g);               false: no product (the Op's write
//                                     decides what the rows get)
//   const bf16* mat(int g);           the group's (K x N) row-major matrix
//   long long src(int g, int r);      row r's source offset (the Op's unit)
//   long long dst(int g, int r);      where row r goes (the Op's unit)
//   template <class T> void load_a(as, k0, g, nrows, src);
//                                     the k slice [k0, k0 + EM_BK) of the
//                                     tile's rows into the stage ``as``
//                                     (row stride T::A_LD), zeros past the
//                                     rows and the depth, by the whole CTA
//                                     with cp.async copies
//   float pre(int n, float acc);      the value of column n rounded into
//                                     the staged tile
//   template <int kBN> void write(g, r0, nrows, n0, tile, dst, active);
//                                     the tile's rows out, by the whole CTA

// The A rows of the products that read the rolled pair: row r's K = 2C
// features are [skip | dec] at element offset src[r] of both, 16 bytes a
// copy
struct PairA {
  const bf16* skip;
  const bf16* dec;
  int C;

  template <class T>
  __device__ void load_a(bf16* as, int k0, int, int nrows,
                         const long long* src) const {
    for (int idx = threadIdx.x; idx < T::BM * EM_BK / 8; idx += T::THREADS) {
      const int r = idx / (EM_BK / 8), c = idx % (EM_BK / 8) * 8;
      const int k = k0 + c;
      const bool ok = r < nrows && k < 2 * C;
      const long long s = ok ? src[r] : 0;
      const bf16* p = k < C ? skip + s + k : dec + s + (k - C);
      cp_async16_zfill(as + r * T::A_LD + c, ok ? p : skip, ok);
    }
  }
};

template <class Op>
__global__ void __launch_bounds__(Op::Tile::THREADS, Op::Tile::MINB)
edge_mma_kernel(Op op) {
  using T = typename Op::Tile;
  static_assert(T::BM * Op::kOutLd * sizeof(bf16) <= T::RING,
                "the staged output tile fits in the ring");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sa = reinterpret_cast<bf16*>(smem_raw);
  bf16* sb = sa + EM_STAGES * T::A_ELEMS;
  long long* src = reinterpret_cast<long long*>(smem_raw + T::RING);
  long long* dst = src + T::BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mtiles = (op.M + T::BM - 1) / T::BM;
  const int ntiles = (op.N + T::BN - 1) / T::BN;
  long long x = blockIdx.x;
  const int n0 = (int)(x % ntiles) * T::BN;  // a row tile's column tiles
  x /= ntiles;                                // are neighbours in the grid
  const int r0 = (int)(x % mtiles) * T::BM;
  const int g = (int)(x / mtiles);
  const int nrows = min(T::BM, op.M - r0);
  const bool active = op.active(g);
  for (int i = tid; i < nrows; i += T::THREADS) {
    src[i] = op.src(g, r0 + i);
    dst[i] = op.dst(g, r0 + i);
  }
  __syncthreads();

  if (active) {
    const bf16* __restrict__ B = op.mat(g);
    const int wm = 16 * T::MT * (warp / T::WN), wn = 8 * T::NT * (warp % T::WN);
    const int nk = (op.K + EM_BK - 1) / EM_BK;
    auto load = [&](int stage, int kt) {
      const int k0 = kt * EM_BK;
      op.template load_a<T>(sa + stage * T::A_ELEMS, k0, g, nrows, src);
      bf16* bs = sb + stage * T::B_ELEMS;
      for (int idx = tid; idx < EM_BK * T::BN / 8; idx += T::THREADS) {
        const int r = idx / (T::BN / 8), c = idx % (T::BN / 8) * 8;
        const bool ok = k0 + r < op.K && n0 + c < op.N;
        cp_async16_zfill(bs + r * T::B_LD + c,
                         ok ? B + (long long)(k0 + r) * op.N + n0 + c : B, ok);
      }
    };
    float acc[T::MT][T::NT][4];
#pragma unroll
    for (int i = 0; i < T::MT; ++i)
#pragma unroll
      for (int j = 0; j < T::NT; ++j)
        acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
#pragma unroll
    for (int s = 0; s < EM_STAGES - 1; ++s) {
      if (s < nk) load(s, s);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<EM_STAGES - 2>();
      __syncthreads();  // stage kt is in; stage kt - 1 is read by every warp
      if (kt + EM_STAGES - 1 < nk)
        load((kt + EM_STAGES - 1) % EM_STAGES, kt + EM_STAGES - 1);
      cp_async_commit();
      const bf16* as = sa + (kt % EM_STAGES) * T::A_ELEMS;
      const bf16* bs = sb + (kt % EM_STAGES) * T::B_ELEMS;
#pragma unroll
      for (int kk = 0; kk < EM_BK; kk += 16) {
        uint32_t af[T::MT][4];
#pragma unroll
        for (int i = 0; i < T::MT; ++i)
          load_a_n(af[i], as, T::A_LD, kk, wm + 16 * i);
#pragma unroll
        for (int j = 0; j < T::NT / 2; ++j) {
          uint32_t bfr[2][2];
          load_b_t(bfr, bs, T::B_LD, kk, wn + 16 * j);
#pragma unroll
          for (int i = 0; i < T::MT; ++i) {
            mma_bf16(acc[i][2 * j], af[i], bfr[0]);
            mma_bf16(acc[i][2 * j + 1], af[i], bfr[1]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free: the staged output tile
    const int gq = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int i = 0; i < T::MT; ++i)
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
        const int row = wm + 16 * i + gq, col = wn + 8 * j + 2 * t4;
        const int n = n0 + col;
        *reinterpret_cast<uint32_t*>(sa + row * Op::kOutLd + col) =
            pack_bf16(op.pre(n, acc[i][j][0]), op.pre(n + 1, acc[i][j][1]));
        *reinterpret_cast<uint32_t*>(sa + (row + 8) * Op::kOutLd + col) =
            pack_bf16(op.pre(n, acc[i][j][2]), op.pre(n + 1, acc[i][j][3]));
      }
  }
  __syncthreads();
  op.template write<T::BN>(g, r0, nrows, n0, sa, dst, active);
}

// one launch over every group: the grid's x dimension holds the tiles (up
// to 2^31 - 1, past the 65,535 of y at any batch a card holds)
template <class Op>
inline cudaError_t edge_mma(const Op& op, cudaStream_t st) {
  using T = typename Op::Tile;
  cudaError_t e = cudaFuncSetAttribute(
      edge_mma_kernel<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)T::SMEM);
  if (e != cudaSuccess) return e;
  const long long blocks = op.groups * ((op.M + T::BM - 1) / T::BM) *
                           ((op.N + T::BN - 1) / T::BN);
  if (blocks == 0) return cudaSuccess;
  edge_mma_kernel<Op><<<(unsigned)blocks, T::THREADS, T::SMEM, st>>>(op);
  return cudaGetLastError();
}

}  // namespace pangu
