// The bf16 row passes that the window-major (updown_wm.cu) and canonical
// (updown.cu) DownSample and UpSample share: a LayerNorm row held in
// registers and written 16 bytes a lane, and the fused gather + LayerNorm
// kernels of both, templated on a row map (where an output row reads its
// values): the window-major maps roll the coordinates back and mark
// latitude-pad rows (updown_wm.cu, DownWmMap, UpWmMap), the canonical ones
// work on a grid without pad rows (updown.cu, DownCanonMap: a zero part
// past an odd latitude count; UpCanonMap: the coordinates of a cropped
// grid halved).  Both DownSamples run one kernel, and both UpSamples.
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

// DownSample's gather + LayerNorm: one warp per stage-1 row m, cat[m] =
// round_bf16(LN([the four parts' C values in (h_off, w_off) order])), 4C
// values in registers, each part read 16 bytes a lane.  Lane j asks the
// map for part j % 4 once (the index arithmetic of a row in one pass) and
// each lane takes its chunks' offsets by shuffle.  Map: ``long long
// operator()(long long m, int part)``, the element offset in x of part
// ``part`` (h_off = part / 2, w_off = part % 2) of row m, -1 for a part
// read as zeros, or -2 for every part of a padding row (written as zeros).
template <int NJ, typename Map>
__global__ void __launch_bounds__(256)
down_gather_ln_kernel(const bf16* __restrict__ x, bf16* __restrict__ cat,
                      long long M1, int C, Map map,
                      const bf16* __restrict__ scale,
                      const bf16* __restrict__ shift) {
  const int lane = threadIdx.x % 32, cpr = C / 8, chunks = 4 * cpr;
  const long long m = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (m >= M1) return;
  const long long mine = map(m, lane % 4);
  bf16* dst = cat + m * 4 * C;
  if (__shfl_sync(0xffffffffu, mine, 0) == -2) {
    zero_row16(dst, chunks, lane);
    return;
  }
  float v[NJ][8];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int k = lane + 32 * j, part = min(k / cpr, 3);
    const long long src = __shfl_sync(0xffffffffu, mine, part);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[j][e] = 0.f;
    if (k < chunks && src >= 0) ld8(x + src + 8 * (k - part * cpr), v[j]);
  }
  ln_store_row<NJ>(v, chunks, 4 * C, scale, shift, dst, lane);
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
