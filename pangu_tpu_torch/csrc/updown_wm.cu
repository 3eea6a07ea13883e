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
// block zero-synthesises on read; here they are zeros.)
//
// What bounds them on an H100: memory traffic.  At full width DownSample does
// ~8e10 FLOP on ~0.2 GB in and ~0.1 GB out (bf16), UpSample ~8e10 FLOP on
// similar bytes: both sit near the bf16 balance point, and this first version
// adds a round trip of the 4C-wide intermediate through device memory.
#include "common.cuh"

namespace pangu {

struct Roll {
  int z, lat, lon;  // off: storage p holds canonical token p + off
};

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
  if (dtype == 1)
    return down_sample_wm<bf16>(x, out, workspace, ns, nb, wr, B, s0, s1, C, off,
                                h0, h1, st);
  return (int)cudaErrorInvalidValue;
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
  if (dtype == 1)
    return up_sample_wm<bf16>(x, out, workspace, we, ns, nb, wm, B, s2, s3, c_in,
                              c_out, off, h2, h3, st);
  return (int)cudaErrorInvalidValue;
}
