// Canonical-layout DownSample and UpSample, on the (B, Z, H, W, C) token grid.
//
// Replace the Pallas kernels pangu_tpu/ops/updown.py::_down_pallas (kernel
// _make_down_kernel) and ::_up_pallas (_make_up_kernel), which the
// canonical-layout forward (forward_core, the ``taps`` path) runs between its
// stages.  They compute what the window-major pair in updown_wm.cu computes,
// on the canonical grid and without a roll: the TPU kernels' lane-offset
// scratch writes and sublane interleaves are one gather here.
//
// DownSample (merge order (h_off, w_off, C), reference layers.py:449-451):
//   1. gather  cat[(b, z, i, j), (2*ho+wo)*C + c] = x[b, z, 2i+ho, 2j+wo, c],
//              zero where 2i+ho >= H (the odd-latitude pad row, which the
//              JAX wrapper adds as a zero row before its kernel)
//   2. LN      cat = round_T(LN(cat))            over 4C, float32 statistics
//   3. GEMM    out = round_T(cat @ Wreduce)      (4C -> 2C, no bias)
// UpSample:
//   1. GEMM    e = round_T(x @ Wexpand)          (2C -> 4C', no bias)
//   2. gather  y[(b, z, i, j), :] = e[(b, z, i/2, j/2), (2*(i%2)+(j%2))*C' : +C']
//              for i < out_h (the crop)
//   3. LN      y = round_T(LN(y))                over C'
//   4. GEMM    out = round_T(y @ Wmix)           (C' -> C', no bias)
//
// What bounds them on an H100: UpSample does 1.16e11 FLOP at full width
// (bf16, (1, 8, 91, 180, 384) -> (1, 8, 181, 360, 192)) on ~0.2 GB, just
// above the bf16 balance point (operations); DownSample ~8e10 FLOP on
// ~0.3 GB, just below it (bytes).  So each pass should move its bytes once
// and the products should run on the tensor cores.
//
// In bf16 (the perf config) both run the window-major pair's plan
// (updown_wm.cu) with canonical row maps.  DownSample: one fused gather +
// LayerNorm pass (updown_rows.cuh's down_gather_ln_kernel with
// DownCanonMap: a warp a stage-1 row, its 4C values in registers, read 16
// bytes a lane; the zero latitude row of an odd H is a zero part, so no
// padded copy of x is made), then the reduce product on mma_gemm.cuh (128
// x 96 mma.sync tiles, a plain rounding store: the canonical grid has no
// pad rows).  UpSample: the expand and mix products on mma_gemm.cuh and
// between them one fused gather + LayerNorm pass (up_gather_ln_kernel with
// UpCanonMap: four rows a warp for C' = 192, 16 bytes a lane).  So the
// bf16 route takes channel counts that are multiples of 8, LayerNorm rows
// of at most 256 * LN_MAX_NJ values and 16-byte aligned operands (the
// entries refuse the rest; the wrappers check first).  float32 (the
// parity config) keeps the first version: an element-a-lane gather, then
// common.cuh's ln_rows in place and its gemm (64 x 64 tiles, no
// pipeline), which adds a round trip of the intermediate through device
// memory.
#include "mma_gemm.cuh"
#include "updown_rows.cuh"

namespace pangu {

// one warp per output row (b, z, i, j) of the (B, Z, H2, W2) grid
template <typename T>
__global__ void __launch_bounds__(256)
down_canon_gather_kernel(const T* __restrict__ x, T* __restrict__ cat,
                         long long M1, int C, int H, int W, int H2, int W2) {
  const int lane = threadIdx.x % 32;
  const long long m = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (m >= M1) return;
  const int j = (int)(m % W2);
  const int i = (int)((m / W2) % H2);
  const long long bz = m / ((long long)W2 * H2);
  T* dst = cat + m * 4 * C;
  for (int k = 0; k < 4; ++k) {
    const int lat = 2 * i + k / 2, lon = 2 * j + k % 2;
    T* d = dst + k * C;
    if (lat >= H) {
      for (int c = lane; c < C; c += 32) d[c] = from_f<T>(0.f);
      continue;
    }
    const T* src = x + ((bz * H + lat) * W + lon) * C;
    for (int c = lane; c < C; c += 32) d[c] = src[c];
  }
}

// one warp per output row (b, z, i, j) of the (B, Z, out_h, 2W) grid
template <typename T>
__global__ void __launch_bounds__(256)
up_canon_gather_kernel(const T* __restrict__ e, T* __restrict__ y, long long M3,
                       int C, int H, int W, int out_h) {
  const int lane = threadIdx.x % 32;
  const long long m = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (m >= M3) return;
  const int W3 = 2 * W;
  const int j = (int)(m % W3);
  const int i = (int)((m / W3) % out_h);
  const long long bz = m / ((long long)W3 * out_h);
  const T* src = e + ((bz * H + i / 2) * W + j / 2) * 4 * C +
                 (2 * (i % 2) + j % 2) * C;
  T* dst = y + m * C;
  for (int c = lane; c < C; c += 32) dst[c] = src[c];
}

// the float32 DownSample (the first version; bf16 runs down_sample_bf16 below)
template <typename T>
int down_sample(const void* x, void* out, void* ws, const void* ns,
                const void* nb, const void* wr, int BZ, int H, int W, int C,
                cudaStream_t st) {
  const int H2 = (H + 1) / 2, W2 = W / 2;
  const long long M1 = (long long)BZ * H2 * W2;
  T* cat = (T*)ws;  // M1 * 4C
  down_canon_gather_kernel<T><<<row_blocks(M1), 256, 0, st>>>(
      (const T*)x, cat, M1, C, H, W, H2, W2);
  PANGU_CHECK_LAUNCH();
  ln_rows<T>(cat, nullptr, cat, (const T*)ns, (const T*)nb, M1, 4 * C, st);
  PANGU_CHECK_LAUNCH();
  const PadRows none = {0};
  gemm((const T*)cat, (const T*)wr, (const T*)nullptr, (T*)out, (int)M1, 2 * C,
       4 * C, ACT_NONE, none, st);
  PANGU_CHECK_LAUNCH();
  return 0;
}

// the float32 UpSample (the first version; bf16 runs up_sample_bf16 below)
template <typename T>
int up_sample(const void* x, void* out, void* ws, const void* we,
              const void* ns, const void* nb, const void* wm, int BZ, int H,
              int W, int c_in, int c_out, int out_h, cudaStream_t st) {
  const long long M2 = (long long)BZ * H * W;
  const long long M3 = (long long)BZ * out_h * 2 * W;
  T* e = (T*)ws;              // M2 * 4C'
  T* y = e + M2 * 4 * c_out;  // M3 * C'
  const PadRows none = {0};
  gemm((const T*)x, (const T*)we, (const T*)nullptr, e, (int)M2, 4 * c_out, c_in,
       ACT_NONE, none, st);
  PANGU_CHECK_LAUNCH();
  up_canon_gather_kernel<T><<<row_blocks(M3), 256, 0, st>>>(e, y, M3, c_out, H,
                                                           W, out_h);
  PANGU_CHECK_LAUNCH();
  ln_rows<T>(y, nullptr, y, (const T*)ns, (const T*)nb, M3, c_out, st);
  PANGU_CHECK_LAUNCH();
  gemm((const T*)y, (const T*)wm, (const T*)nullptr, (T*)out, (int)M3, c_out,
       c_out, ACT_NONE, none, st);
  PANGU_CHECK_LAUNCH();
  return 0;
}

// ---- the bf16 DownSample ---------------------------------------------------

// DownSample's canonical row map (down_gather_ln_kernel): part (h_off,
// w_off) of row (bz, i, j) of the (BZ, H2, W2) grid reads x at (bz, 2i +
// h_off, 2j + w_off); past an odd H the part is zero (-1), the zero row
// the JAX wrapper pads; no row is padding
struct DownCanonMap {
  int H, W, H2, W2, C;
  __device__ long long operator()(long long m, int part) const {
    const int j = (int)(m % W2);
    const long long q = m / W2;
    const int i = (int)(q % H2);
    const long long bz = q / H2;
    const int lat = 2 * i + part / 2;
    if (lat >= H) return -1;
    return ((bz * H + lat) * W + 2 * j + part % 2) * C;
  }
};

static int down_sample_bf16(const bf16* x, bf16* out, bf16* cat,
                            const bf16* ns, const bf16* nb, const bf16* wr,
                            int BZ, int H, int W, int C, cudaStream_t st) {
  const int H2 = (H + 1) / 2, W2 = W / 2;
  const long long M1 = (long long)BZ * H2 * W2;
  int err = with_nj(row_nj(C / 2), [&](auto nj) {
    constexpr int NJ = decltype(nj)::value;
    down_gather_ln_kernel<NJ, DownCanonMap><<<row_blocks(M1), 256, 0, st>>>(
        x, cat, M1, C, DownCanonMap{H, W, H2, W2, C}, ns, nb);
    return (int)cudaGetLastError();
  });
  if (err) return err;
  return (int)mma_gemm<false>(cat, wr, M1, 2 * C, 4 * C,
                              RoundEpi<bf16>{out, 2 * C}, st);
}

// ---- the bf16 UpSample -----------------------------------------------------

// UpSample's canonical row map (up_gather_ln_kernel): y row (bz, i, j) of
// the (BZ, out_h, 2W) grid reads part (i % 2, j % 2) of e row (bz, i / 2,
// j / 2); the crop keeps i < out_h <= 2H, so no row is padding
struct UpCanonMap {
  int H, W, out_h, C;
  __device__ long long operator()(long long m) const {
    const int W3 = 2 * W;
    const int j = (int)(m % W3);
    const long long q = m / W3;
    const int i = (int)(q % out_h);
    const long long bz = q / out_h;
    return ((bz * H + i / 2) * W + j / 2) * 4 * C + (2 * (i % 2) + j % 2) * C;
  }
};

static int up_sample_bf16(const bf16* x, bf16* out, bf16* ws, const bf16* we,
                          const bf16* ns, const bf16* nb, const bf16* wm,
                          int BZ, int H, int W, int c_in, int c_out,
                          int out_h, cudaStream_t st) {
  const long long M2 = (long long)BZ * H * W;
  const long long M3 = (long long)BZ * out_h * 2 * W;
  bf16* e = ws;                  // M2 * 4C'
  bf16* y = e + M2 * 4 * c_out;  // M3 * C'
  int err = (int)mma_gemm<false>(x, we, M2, 4 * c_out, c_in,
                                 RoundEpi<bf16>{e, 4 * c_out}, st);
  if (err) return err;
  err = with_nj(row_nj(c_out / 8), [&](auto nj) {
    constexpr int NJ = decltype(nj)::value;
    const long long warps = (M3 + up_rows<NJ>() - 1) / up_rows<NJ>();
    up_gather_ln_kernel<NJ, UpCanonMap><<<row_blocks(warps), 256, 0, st>>>(
        e, y, M3, c_out, UpCanonMap{H, W, out_h, c_out}, ns, nb);
    return (int)cudaGetLastError();
  });
  if (err) return err;
  return (int)mma_gemm<false>(y, wm, M3, c_out, c_out,
                              RoundEpi<bf16>{out, c_out}, st);
}

}  // namespace pangu

using namespace pangu;

// dtype: 0 = float32, 1 = bfloat16.  x: (B, Z, H, W, C), BZ = B * Z.
// Returns a cudaError_t (0 = ok; cudaErrorInvalidValue for an odd W and,
// in bf16, for a channel count that is not a multiple of 8, a LayerNorm row
// the row pass cannot hold or an operand off a 16-byte boundary).
extern "C" int pangu_down_sample(int dtype, const void* x, void* out,
                                 void* workspace, const void* ns,
                                 const void* nb, const void* wr, int BZ, int H,
                                 int W, int C, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (W % 2 != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return down_sample<float>(x, out, workspace, ns, nb, wr, BZ, H, W, C, st);
  // bf16: the tensor-core tiles and the 16-byte row pass
  if (dtype != 1 || C % 8 || row_nj(C / 2) > LN_MAX_NJ ||
      !aligned16_all({x, out, workspace, ns, nb, wr}))
    return (int)cudaErrorInvalidValue;
  return down_sample_bf16((const bf16*)x, (bf16*)out, (bf16*)workspace,
                          (const bf16*)ns, (const bf16*)nb, (const bf16*)wr,
                          BZ, H, W, C, st);
}

// x: (B, Z, H, W, c_in) -> out (B, Z, out_h, 2W, c_out), out_h <= 2H.
// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = ok;
// cudaErrorInvalidValue for a bf16 channel count that is not a multiple of
// 8, a LayerNorm row the row pass cannot hold or an operand off a 16-byte
// boundary).
extern "C" int pangu_up_sample(int dtype, const void* x, void* out,
                               void* workspace, const void* we, const void* ns,
                               const void* nb, const void* wm, int BZ, int H,
                               int W, int c_in, int c_out, int out_h,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (out_h > 2 * H) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return up_sample<float>(x, out, workspace, we, ns, nb, wm, BZ, H, W, c_in,
                            c_out, out_h, st);
  // bf16: the tensor-core tiles and the 16-byte row pass
  if (dtype != 1 || c_in % 8 || c_out % 8 || row_nj(c_out / 8) > LN_MAX_NJ ||
      !aligned16_all({x, out, workspace, we, ns, nb, wm}))
    return (int)cudaErrorInvalidValue;
  return up_sample_bf16((const bf16*)x, (bf16*)out, (bf16*)workspace,
                        (const bf16*)we, (const bf16*)ns, (const bf16*)nb,
                        (const bf16*)wm, BZ, H, W, c_in, c_out, out_h, st);
}
