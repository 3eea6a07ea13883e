// The bf16 row passes that the window-major (updown_wm.cu) and canonical
// (updown.cu) DownSample and UpSample share: a LayerNorm row held in
// registers and written 16 bytes a lane, and UpSample's fused gather +
// LayerNorm kernel, templated on a row map (where a stage-3 row reads its
// C' slice of the expand product e): the window-major map rolls the
// coordinates back and zeroes latitude-pad rows (updown_wm.cu, UpWmMap),
// the canonical one halves the coordinates of a cropped grid that has no
// pad rows (updown.cu, UpCanonMap).  Both UpSample routes run one kernel.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace pangu {

// A row pass holds a LayerNorm row in registers: lane j the 8-value chunks
// j, j + 32, ..., NJ of them (chunk k = columns [8k, 8k + 8)).
constexpr int LN_MAX_NJ = 8;

// v (the lane's chunks of a row of `width` values, `chunks` = width / 8
// in all) -> out = round_bf16(LN(v)), float32 statistics (the sums run 8
// values a lane first, as block_common.cuh's ln_rows16_kernel)
template <int NJ>
__device__ __forceinline__ void ln_store_row(float (&v)[NJ][8], int chunks,
                                             int width,
                                             const bf16* __restrict__ scale,
                                             const bf16* __restrict__ shift,
                                             bf16* out, int lane) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    if (lane + 32 * j < chunks)
#pragma unroll
      for (int e = 0; e < 8; ++e) s += v[j][e];
  const float mu = warp_sum(s) / width;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    if (lane + 32 * j < chunks)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = v[j][e] - mu;
        q += d * d;
      }
  const float rs = rsqrtf(warp_sum(q) / width + 1e-5f);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int k = lane + 32 * j;
    if (k >= chunks) continue;
    float g[8], b[8];
    ld8(scale + 8 * k, g);
    ld8(shift + 8 * k, b);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[j][e] = (v[j][e] - mu) * rs * g[e] + b[e];
    st8(out + 8 * k, v[j]);
  }
}

__device__ __forceinline__ void zero_row16(bf16* out, int chunks, int lane) {
  for (int k = lane; k < chunks; k += 32)
    *reinterpret_cast<uint4*>(out + 8 * k) = make_uint4(0u, 0u, 0u, 0u);
}

// UpSample's gather + LayerNorm: one warp per up_rows<NJ>() consecutive
// stage-3 rows, y[m] = round_bf16(LN(the C' slice of e that m takes)); a
// row the map calls padding (-1) is written as zeros, and no pad row of e
// is read.  A C' = 192 row is 384 bytes, so a warp takes four: lane j works
// out where row j % 4 reads (the index arithmetic of four rows in one pass)
// and the four rows' loads are all in flight before the first reduction.
// Map: ``long long operator()(long long m)``, the element offset in e of
// row m's slice, or -1.
template <int NJ>
__host__ __device__ constexpr int up_rows() { return NJ < 4 ? 4 / NJ : 1; }

template <int NJ, typename Map>
__global__ void __launch_bounds__(256)
up_gather_ln_kernel(const bf16* __restrict__ e, bf16* __restrict__ y,
                    long long M3, int C, Map map,
                    const bf16* __restrict__ scale,
                    const bf16* __restrict__ shift) {
  constexpr int R = up_rows<NJ>();
  const int lane = threadIdx.x % 32, chunks = C / 8;
  const long long m0 = ((long long)blockIdx.x * 8 + threadIdx.x / 32) * R;
  if (m0 >= M3) return;
  // where row m0 + lane % R reads in e; -1: a pad row (zeros), -2: past M3
  long long mine = -2;
  {
    const long long m = m0 + lane % R;
    if (m < M3) mine = map(m);
  }
  long long src[R];
  float v[R][NJ][8];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    src[r] = __shfl_sync(0xffffffffu, mine, r);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (lane + 32 * j < chunks && src[r] >= 0)
        ld8(e + src[r] + 8 * (lane + 32 * j), v[r][j]);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    bf16* dst = y + (m0 + r) * C;
    if (src[r] == -1)
      zero_row16(dst, chunks, lane);
    else if (src[r] >= 0)
      ln_store_row<NJ>(v[r], chunks, C, scale, shift, dst, lane);
  }
}

// launch(std::integral_constant<int, nj>) for 1 <= nj <= LN_MAX_NJ, the
// row kernels' instantiation that holds nj chunks a lane
template <int NJ = 1, typename Launch>
inline int with_nj(int nj, Launch launch) {
  if constexpr (NJ > LN_MAX_NJ) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (nj == NJ) return launch(std::integral_constant<int, NJ>{});
    return with_nj<NJ + 1>(nj, launch);
  }
}

inline int row_nj(int chunks) { return (chunks + 31) / 32; }

}  // namespace pangu
