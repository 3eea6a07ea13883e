// The one GEMM shape of the edge kernels (embed, token-space transition,
// recovery) in float32: a product whose rows are GATHERED and whose outputs
// are SCATTERED, with one (K x N) matrix chosen per group of rows.
//
// A group is one (batch, token plane, token-lat row) of the stage-0 grid:
// its rows are that row's longitude tokens, which all have the same token
// type, so the matrix is chosen once per group, never per row.  (The TPU
// kernels run the interior matrix on whole windows and correct the edge rows
// afterwards, because a Mosaic program covers whole windows.)
//
// An Op describes one kernel:
//   int K, N, M;                       depth, output width, rows per group
//   static constexpr bool kLonOrder;   epilogue order (below)
//   struct Row;                        what a row needs, decoded once per tile
//   bool active(int g);                false: the group's rows are written as
//                                      zeros and no product is formed
//   const T* mat(int g);               the group's (K x N) row-major matrix
//   Row row(int g, int r);             row r of group g
//   T load(const Row&, int k);         element k of the row (gather)
//   void store(const Row&, int n, float acc);   output n of the row (scatter)
//
// Epilogue order: kLonOrder = false writes each tile row by row (outputs that
// are rows of a row-major matrix); kLonOrder = true runs w_off fastest, then
// the row, then n / 4, so that row r and w_off wo -- longitude 4r + wo of the
// recovered field -- are written by neighbouring threads.
//
// The float32 route of the embed, the transition and the recovery: smem-tiled
// FMA (64x64x16, 4x4 per thread), as the shared GEMM of common.cuh, handing
// the float32 sum to the Op's store.  Their bf16 routes run on the tensor
// cores (edge_mma.cuh).
#pragma once

#include "common.cuh"

namespace pangu {

constexpr int EG_M = 64, EG_N = 64;

struct EgTile {
  int g, r0, n0, nrows;
};

template <class Op>
__device__ __forceinline__ EgTile eg_tile(const Op& op) {
  const int ntn = (op.N + EG_N - 1) / EG_N;
  const int ntm = (op.M + EG_M - 1) / EG_M;
  const long long x = blockIdx.x;
  EgTile t;
  t.n0 = (int)(x % ntn) * EG_N;
  t.r0 = (int)((x / ntn) % ntm) * EG_M;
  t.g = (int)(x / ((long long)ntn * ntm));
  t.nrows = min(EG_M, op.M - t.r0);
  return t;
}

template <class Op>
__device__ __forceinline__ void eg_epilogue(const Op& op, const EgTile& t,
                                            const typename Op::Row* rows,
                                            float (*Cs)[EG_N + 4], bool active) {
  for (int idx = threadIdx.x; idx < EG_M * EG_N; idx += blockDim.x) {
    int r, c;
    if (Op::kLonOrder) {
      r = (idx / 4) % EG_M;
      c = (idx / (4 * EG_M)) * 4 + idx % 4;
    } else {
      r = idx / EG_N;
      c = idx % EG_N;
    }
    if (r < t.nrows && t.n0 + c < op.N)
      op.store(rows[r], t.n0 + c, active ? Cs[r][c] : 0.f);
  }
}

// float32: smem-tiled FMA
template <class Op>
__global__ void __launch_bounds__(256) edge_gemm_f32(Op op) {
  using Row = typename Op::Row;
  __shared__ float As[FK][EG_M + 4];
  __shared__ float Bs[FK][EG_N + 4];
  __shared__ float Cs[EG_M][EG_N + 4];
  __shared__ Row rows[EG_M];
  const EgTile t = eg_tile(op);
  const int tid = threadIdx.x;
  for (int i = tid; i < t.nrows; i += blockDim.x) rows[i] = op.row(t.g, t.r0 + i);
  const bool active = op.active(t.g);
  __syncthreads();
  if (active) {
    const float* B = op.mat(t.g);
    const int tx = tid % 16, ty = tid / 16;
    float acc[4][4] = {};
    for (int k0 = 0; k0 < op.K; k0 += FK) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int idx = tid + i * 256;
        int r = idx / FK, c = idx % FK;
        As[c][r] = (r < t.nrows && k0 + c < op.K) ? to_f(op.load(rows[r], k0 + c)) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int idx = tid + i * 256;
        int r = idx / EG_N, c = idx % EG_N;
        int gr = k0 + r, gc = t.n0 + c;
        Bs[r][c] = (gr < op.K && gc < op.N) ? B[(long long)gr * op.N + gc] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < FK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Cs[ty * 4 + i][tx * 4 + j] = acc[i][j];
    __syncthreads();
  }
  eg_epilogue(op, t, rows, Cs, active);
}

// one launch over ``groups`` groups
template <class Op>
inline void edge_gemm(const Op& op, int groups, cudaStream_t st) {
  const long long blocks = (long long)groups * ((op.M + EG_M - 1) / EG_M) *
                           ((op.N + EG_N - 1) / EG_N);
  edge_gemm_f32<Op><<<(unsigned)blocks, 256, 0, st>>>(op);
}

// the rolled-storage row of canonical stage-0 token (z, lat, lon): storage
// position p holds canonical token p + off, so token t sits at t - off
__device__ __forceinline__ long long rolled_row(int b, int z, int lat, int lon,
                                                const WmShape& s, int oz, int olat,
                                                int olon) {
  return wm_row(b, pmod(z - oz, s.nz * s.wz), pmod(lat - olat, s.nlat * s.wh),
                pmod(lon - olon, s.nlon * s.ww), s);
}

}  // namespace pangu
