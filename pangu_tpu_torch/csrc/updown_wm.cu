// Window-major DownSample and UpSample between the trunk's stages.
//
// Replace the Pallas kernels pangu_tpu/ops/updown_wm.py::down_sample_wm
// (kernel _make_down_wm_kernel) and ::up_sample_wm (_make_up_wm_kernel).  Both
// read the previous stage's ROLLED window-major storage, in which storage
// position p holds canonical token p + off, and write the next stage's
// window-major entry storage in canonical coordinates.  The TPU kernels stitch
// 6 (down) or 2 (up) chunks through index maps and transpose tiles in VMEM;
// here the roll-back, the latitude crop and the 2x2 space-to-depth /
// depth-to-space are index arithmetic in one gather.
//
// DownSample (merge order (h_off, w_off, C)):
//   1. gather  cat[t1, (2*ho+wo)*C + c] = x0[canonical (z, 2*lat1+ho, 2*w1+wo) - off],
//              zero where 2*lat1+ho >= h0
//   2. LN      cat = round_T(LN(cat))            over 4C, float32 statistics
//   3. GEMM    out = round_T(cat @ Wreduce), rows with lat1 >= h1 zeroed
// UpSample:
//   1. GEMM    e = round_T(x2 @ Wexpand), in storage row order (2C -> 4C')
//   2. gather  y[t3, :] = e[canonical (z, lat3/2, w3/2) - off, (2*(lat3%2)+(w3%2))*C' : +C'],
//              zero where lat3 >= h3
//   3. LN      y = round_T(LN(y))                over C'
//   4. GEMM    out = round_T(y @ Wmix), rows with lat3 >= h3 zeroed
// (The TPU kernel leaves junk in UpSample's latitude-pad rows, which the next
// block zero-synthesises on read; here they are zeros.)  LayerNorm is not
// folded into the weights: its output rounds to T before the product, as in
// the JAX kernels.
//
// What bounds them on an H100: at full width DownSample does ~8.2e10 FLOP
// on ~0.2 GB in and ~0.1 GB out (bf16), UpSample ~8e10 FLOP on similar
// bytes: both sit near the bf16 balance point, so each pass should move its
// bytes once and the products should run on the tensor cores.
//
// float32 (the parity config) runs the first version's kernels: an element
// a lane gather, common.cuh's ln_rows in place, common.cuh's FMA gemm (the
// outputs stay the same bit for bit).  bf16 (the perf config) runs
//   DownSample  one fused gather + LayerNorm pass (updown_rows.cuh's
//               down_gather_ln_kernel with the rolled row map DownWmMap:
//               a warp a stage-1 row, its 4C values in registers, read 16
//               bytes a lane from the four source rows, whose offsets are
//               computed once a row and shuffled to the lanes; the
//               canonical DownSample of updown.cu runs the same kernel),
//               then one mma_gemm.cuh product (128 x 96 mma.sync tiles)
//               whose epilogue (PadEpi) zeroes the latitude-pad rows;
//   UpSample    the expand product on mma_gemm (PadEpi, every row kept),
//               one fused gather + LayerNorm pass (updown_rows.cuh's
//               up_gather_ln_kernel with the rolled row map UpWmMap: four
//               stage-3 rows a warp, each reading its C' slice of e 16
//               bytes a lane; the canonical UpSample of updown.cu runs the
//               same kernel), the mix product on mma_gemm with PadEpi.
// So the bf16 route takes channel counts that are multiples of 8, 16-byte
// aligned operands and LayerNorm rows of at most 256 * LN_MAX_NJ values
// (the C entries refuse the rest; the wrappers check first).
#include "mma_gemm.cuh"
#include "updown_rows.cuh"

namespace pangu {

struct Roll {
  int z, lat, lon;  // off: storage p holds canonical token p + off
};

// ---- the float32 route (the first version) -----------------------------------------

// one warp per stage-1 row
template <typename T>
__global__ void __launch_bounds__(256)
down_gather_kernel(const T* __restrict__ x, T* __restrict__ cat, long long M1,
                   int C, WmShape s0, WmShape s1, Roll off, int h0) {
  const int lane = threadIdx.x % 32;
  const long long m = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (m >= M1) return;
  const WmPos p = wm_split(m, s1);
  const int Z = s0.nz * s0.wz, hp0 = s0.nlat * s0.wh, W0 = s0.nlon * s0.ww;
  const int z = s1.wz * p.zz + p.rz;
  const int lat1 = s1.wh * p.hh + p.rh;
  const int w1 = s1.ww * p.l + p.rw;
  T* dst = cat + m * 4 * C;
  for (int k = 0; k < 4; ++k) {
    const int lat0 = 2 * lat1 + k / 2, w0 = 2 * w1 + k % 2;
    T* d = dst + k * C;
    if (lat0 >= h0) {
      for (int c = lane; c < C; c += 32) d[c] = from_f<T>(0.f);
      continue;
    }
    const T* src = x + wm_row(p.b, pmod(z - off.z, Z), pmod(lat0 - off.lat, hp0),
                              pmod(w0 - off.lon, W0), s0) * C;
    for (int c = lane; c < C; c += 32) d[c] = src[c];
  }
}

// one warp per stage-3 row
template <typename T>
__global__ void __launch_bounds__(256)
up_gather_kernel(const T* __restrict__ e, T* __restrict__ y, long long M3,
                 int C, WmShape s2, WmShape s3, Roll off, int h2, int h3) {
  const int lane = threadIdx.x % 32;
  const long long m = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (m >= M3) return;
  const WmPos p = wm_split(m, s3);
  const int Z = s2.nz * s2.wz, hp2 = s2.nlat * s2.wh, W2 = s2.nlon * s2.ww;
  const int z = s3.wz * p.zz + p.rz;
  const int lat3 = s3.wh * p.hh + p.rh;
  const int w3 = s3.ww * p.l + p.rw;
  T* dst = y + m * C;
  if (lat3 >= h3 || lat3 / 2 >= h2) {
    for (int c = lane; c < C; c += 32) dst[c] = from_f<T>(0.f);
    return;
  }
  const long long row = wm_row(p.b, pmod(z - off.z, Z), pmod(lat3 / 2 - off.lat, hp2),
                               pmod(w3 / 2 - off.lon, W2), s2);
  const T* src = e + row * 4 * C + (2 * (lat3 % 2) + w3 % 2) * C;
  for (int c = lane; c < C; c += 32) dst[c] = src[c];
}

template <typename T>
int down_sample_wm(const void* x, void* out, void* ws, const void* ns,
                   const void* nb, const void* wr, int B, WmShape s0, WmShape s1,
                   int C, Roll off, int h0, int h1, cudaStream_t st) {
  const long long M1 = (long long)B * s1.nz * s1.nlat * s1.nlon * s1.n;
  T* cat = (T*)ws;  // M1 * 4C
  down_gather_kernel<T><<<row_blocks(M1), 256, 0, st>>>((const T*)x, cat, M1, C,
                                                       s0, s1, off, h0);
  PANGU_CHECK_LAUNCH();
  ln_rows<T>(cat, nullptr, cat, (const T*)ns, (const T*)nb, M1, 4 * C, st);
  PANGU_CHECK_LAUNCH();
  const PadRows pad = {1, s1, s1.nlat * s1.wh, h1, 0};
  gemm((const T*)cat, (const T*)wr, (const T*)nullptr, (T*)out, (int)M1, 2 * C,
       4 * C, ACT_NONE, pad, st);
  PANGU_CHECK_LAUNCH();
  return 0;
}

template <typename T>
int up_sample_wm(const void* x, void* out, void* ws, const void* we,
                 const void* ns, const void* nb, const void* wm, int B,
                 WmShape s2, WmShape s3, int c_in, int c_out, Roll off, int h2,
                 int h3, cudaStream_t st) {
  const long long M2 = (long long)B * s2.nz * s2.nlat * s2.nlon * s2.n;
  const long long M3 = (long long)B * s3.nz * s3.nlat * s3.nlon * s3.n;
  T* e = (T*)ws;           // M2 * 4C'
  T* y = e + M2 * 4 * c_out;  // M3 * C'
  const PadRows none = {0};
  gemm((const T*)x, (const T*)we, (const T*)nullptr, e, (int)M2, 4 * c_out, c_in,
       ACT_NONE, none, st);
  PANGU_CHECK_LAUNCH();
  up_gather_kernel<T><<<row_blocks(M3), 256, 0, st>>>(e, y, M3, c_out, s2, s3,
                                                     off, h2, h3);
  PANGU_CHECK_LAUNCH();
  ln_rows<T>(y, nullptr, y, (const T*)ns, (const T*)nb, M3, c_out, st);
  PANGU_CHECK_LAUNCH();
  const PadRows pad = {1, s3, s3.nlat * s3.wh, h3, 0};
  gemm((const T*)y, (const T*)wm, (const T*)nullptr, (T*)out, (int)M3, c_out,
       c_out, ACT_NONE, pad, st);
  PANGU_CHECK_LAUNCH();
  return 0;
}

// ---- the bf16 route ---------------------------------------------------------------

// DownSample's row map (down_gather_ln_kernel, updown_rows.cuh): part
// (h_off, w_off) of stage-1 row m reads x0 at canonical (z, 2 lat1 + h_off,
// 2 w1 + w_off) - off; a part past h0 is -1 (zeros), an output
// latitude-pad row (lat1 >= h1, zeroed by the product) -2 (zeros)
struct DownWmMap {
  WmShape s0, s1;
  Roll off;
  int h0, h1, C;
  __device__ long long operator()(long long m, int part) const {
    const WmPos p = wm_split(m, s1);
    const int lat1 = s1.wh * p.hh + p.rh;
    if (lat1 >= h1) return -2;
    const int lat0 = 2 * lat1 + part / 2;
    if (lat0 >= h0) return -1;
    const int Z = s0.nz * s0.wz, hp0 = s0.nlat * s0.wh, W0 = s0.nlon * s0.ww;
    const int w0 = 2 * (s1.ww * p.l + p.rw) + part % 2;
    return wm_row(p.b, pmod(s1.wz * p.zz + p.rz - off.z, Z),
                  pmod(lat0 - off.lat, hp0), pmod(w0 - off.lon, W0), s0) * C;
  }
};

// UpSample's row map (up_gather_ln_kernel, updown_rows.cuh): stage-3 row m
// reads the C' slice of e at canonical (z, lat3 / 2, w3 / 2) - off, part
// (lat3 % 2, w3 % 2); a latitude-pad row (lat3 >= h3) is -1 (zeros)
struct UpWmMap {
  WmShape s2, s3;
  Roll off;
  int h2, h3, C;
  __device__ long long operator()(long long m) const {
    const WmPos p = wm_split(m, s3);
    const int lat3 = s3.wh * p.hh + p.rh, w3 = s3.ww * p.l + p.rw;
    const int Z = s2.nz * s2.wz, hp2 = s2.nlat * s2.wh, W2 = s2.nlon * s2.ww;
    if (lat3 >= h3 || lat3 / 2 >= h2) return -1;
    return wm_row(p.b, pmod(s3.wz * p.zz + p.rz - off.z, Z),
                  pmod(lat3 / 2 - off.lat, hp2), pmod(w3 / 2 - off.lon, W2),
                  s2) * 4 * C + (2 * (lat3 % 2) + w3 % 2) * C;
  }
};

static int down_sample_wm_bf16(const bf16* x, bf16* out, bf16* cat,
                               const bf16* ns, const bf16* nb,
                               const bf16* wr, int B, WmShape s0, WmShape s1,
                               int C, Roll off, int h0, int h1,
                               cudaStream_t st) {
  const long long M1 = (long long)B * s1.nz * s1.nlat * s1.nlon * s1.n;
  int e = with_nj(row_nj(C / 2), [&](auto nj) {
    constexpr int NJ = decltype(nj)::value;
    down_gather_ln_kernel<NJ, DownWmMap><<<row_blocks(M1), 256, 0, st>>>(
        x, cat, M1, C, DownWmMap{s0, s1, off, h0, h1, C}, ns, nb);
    return (int)cudaGetLastError();
  });
  if (e) return e;
  const PadRows pad = {1, s1, s1.nlat * s1.wh, h1, 0};
  return (int)mma_gemm<false>(cat, wr, M1, 2 * C, 4 * C,
                              PadEpi<bf16>{out, 2 * C, pad}, st);
}

static int up_sample_wm_bf16(const bf16* x, bf16* out, bf16* ws,
                             const bf16* we, const bf16* ns, const bf16* nb,
                             const bf16* wm, int B, WmShape s2, WmShape s3,
                             int c_in, int c_out, Roll off, int h2, int h3,
                             cudaStream_t st) {
  const long long M2 = (long long)B * s2.nz * s2.nlat * s2.nlon * s2.n;
  const long long M3 = (long long)B * s3.nz * s3.nlat * s3.nlon * s3.n;
  bf16* e = ws;                   // M2 * 4C'
  bf16* y = e + M2 * 4 * c_out;   // M3 * C'
  const PadRows none = {0};
  int err = (int)mma_gemm<false>(x, we, M2, 4 * c_out, c_in,
                                 PadEpi<bf16>{e, 4 * c_out, none}, st);
  if (err) return err;
  err = with_nj(row_nj(c_out / 8), [&](auto nj) {
    constexpr int NJ = decltype(nj)::value;
    const long long warps = (M3 + up_rows<NJ>() - 1) / up_rows<NJ>();
    up_gather_ln_kernel<NJ, UpWmMap><<<row_blocks(warps), 256, 0, st>>>(
        e, y, M3, c_out, UpWmMap{s2, s3, off, h2, h3, c_out}, ns, nb);
    return (int)cudaGetLastError();
  });
  if (err) return err;
  const PadRows pad = {1, s3, s3.nlat * s3.wh, h3, 0};
  return (int)mma_gemm<false>(y, wm, M3, c_out, c_out,
                              PadEpi<bf16>{out, c_out, pad}, st);
}

}  // namespace pangu

using namespace pangu;

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = ok).
extern "C" int pangu_down_sample_wm(int dtype, const void* x, void* out,
                                    void* workspace, const void* ns,
                                    const void* nb, const void* wr, int B,
                                    int nz, int nlat0, int nlon0, int nlat1,
                                    int nlon1, int n, int C, int wz, int wh,
                                    int ww, int off_z, int off_lat, int off_lon,
                                    int h0, int h1, void* stream) {
  WmShape s0 = {nz, nlat0, nlon0, n, wz, wh, ww};
  WmShape s1 = {nz, nlat1, nlon1, n, wz, wh, ww};
  Roll off = {off_z, off_lat, off_lon};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return down_sample_wm<float>(x, out, workspace, ns, nb, wr, B, s0, s1, C, off,
                                 h0, h1, st);
  // bf16: the tensor-core tiles and the 16-byte row pass
  if (dtype != 1 || C % 8 || row_nj(C / 2) > LN_MAX_NJ ||
      !aligned16_all({x, out, workspace, ns, nb, wr}))
    return (int)cudaErrorInvalidValue;
  return down_sample_wm_bf16((const bf16*)x, (bf16*)out, (bf16*)workspace,
                             (const bf16*)ns, (const bf16*)nb, (const bf16*)wr,
                             B, s0, s1, C, off, h0, h1, st);
}

extern "C" int pangu_up_sample_wm(int dtype, const void* x, void* out,
                                  void* workspace, const void* we,
                                  const void* ns, const void* nb, const void* wm,
                                  int B, int nz, int nlat2, int nlon2, int nlat3,
                                  int nlon3, int n, int c_in, int c_out, int wz,
                                  int wh, int ww, int off_z, int off_lat,
                                  int off_lon, int h2, int h3, void* stream) {
  WmShape s2 = {nz, nlat2, nlon2, n, wz, wh, ww};
  WmShape s3 = {nz, nlat3, nlon3, n, wz, wh, ww};
  Roll off = {off_z, off_lat, off_lon};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return up_sample_wm<float>(x, out, workspace, we, ns, nb, wm, B, s2, s3, c_in,
                               c_out, off, h2, h3, st);
  // bf16: the tensor-core tiles and the 16-byte row pass
  if (dtype != 1 || c_in % 8 || c_out % 8 || row_nj(c_out / 8) > LN_MAX_NJ ||
      !aligned16_all({x, out, workspace, we, ns, nb, wm}))
    return (int)cudaErrorInvalidValue;
  return up_sample_wm_bf16((const bf16*)x, (bf16*)out, (bf16*)workspace,
                           (const bf16*)we, (const bf16*)ns, (const bf16*)nb,
                           (const bf16*)wm, B, s2, s3, c_in, c_out, off, h2, h3,
                           st);
}
