// Weight and bias gradients of the upper patch embed, straight from the
// window-major cotangent.
//
// Replaces the Pallas kernel pangu_tpu/ops/embed_wm.py::embed_dw_upper
// (kernel _make_dw_kernel).  Inputs: the cotangent dxs of the stage-0 wm
// entry storage (B, nz, nlat, nlon, N, C), canonical coordinates; the
// upper field normalised in the compute dtype (B, V, levels, lat, lon),
// recomputed by the caller as the forward's prepass computes it; const_h
// (levels, lat, lon) in the compute dtype.  Output, float32:
//
//   dK[k, c] = sum over (b, zp, h, wt) of a[k] * dxs[wm row of (zp+1, h, wt), c]
//   db[c]    = sum over the same tokens of dxs[..., c]
//
// with a[k] the forward's patch gather, k = (v, zo, ho, wo) -- the ONNX row
// order of the kernel, v < V the normalised variables and v = V const_h,
// zero beyond the levels and latitudes of the field.  Token plane 0 (the
// surface) and the token-lat pad rows (h >= HT) are not summed: the forward
// wrote the surface plane and zeros there.  dK and db are one split-K
// weight-gradient product (grad_gemm.cuh, the bias a row of ones): each split
// of rows keeps its own float32 partial and a second pass adds them in order,
// so the result is the same in every run, as the TPU kernel's serial
// accumulation over its grid is.
//
// What bounds it on an H100: memory traffic.  At full width (bf16) it reads
// the 135 MB normalised field and 175 MB of the cotangent for 3.4e10 FLOP.
#include "grad_gemm.cuh"

namespace pangu {

constexpr int EPZ = 2, EPH = 4, EPW = 4;  // the patch (embed_supported)

// upper token r -> (b, zp, h, wt), in 32-bit arithmetic (fewer than 2^31
// tokens)
__device__ __forceinline__ void token(long long r, int ZP, int HT, int WT,
                                      int& b, int& zp, int& h, int& wt) {
  int q = (int)r;
  wt = q % WT;
  q /= WT;
  h = q % HT;
  q /= HT;
  zp = q % ZP;
  b = q / ZP;
}

// a[k] of upper token r = (b, zp, h, wt); row K reads 1 (the bias)
template <typename T>
struct PatchCols {
  static constexpr bool kKFast = false;
  const T* up;  // (B, V, levels, lat, lon)
  const T* ch;  // (levels, lat, lon)
  int V, levels, lat, lon, ZP, HT, WT, K;
  __device__ T operator()(long long k, long long r) const {
    if (k == K) return from_f<T>(1.f);
    int b, zp, h, wt;
    token(r, ZP, HT, WT, b, zp, h, wt);
    const int ki = (int)k;
    const int v = ki / (EPZ * EPH * EPW), zo = (ki / (EPH * EPW)) % EPZ;
    const int ho = (ki / EPW) % EPH, wo = ki % EPW;
    const int lev = EPZ * zp + zo, la = EPH * h + ho, lo = EPW * wt + wo;
    if (lev >= levels || la >= lat) return from_f<T>(0.f);
    const long long pix = ((long long)lev * lat + la) * lon + lo;
    if (v == V) return ch[pix];
    return up[((long long)b * V + v) * levels * lat * lon + pix];
  }
};

// dxs row of upper token r, element c
template <typename T>
struct TokenRows {
  static constexpr bool kKFast = false;
  const T* dxs;
  WmShape s;
  int C, ZP, HT, WT;
  __device__ T operator()(long long r, long long c) const {
    int b, zp, h, wt;
    token(r, ZP, HT, WT, b, zp, h, wt);
    return dxs[wm_row(b, zp + 1, h, wt, s) * C + c];
  }
};

inline long long embed_dw_rows(int B, WmShape s, int HT) {
  return (long long)B * (s.nz * s.wz - 1) * HT * s.nlon * s.ww;
}

template <typename T>
int embed_dw(const void* dxs, const void* up, const void* ch, void* part,
             void* out, int B, WmShape s, int C, int HT, int V, int levels,
             int lat, int lon, cudaStream_t st) {
  const int ZP = s.nz * s.wz - 1, WT = s.nlon * s.ww;
  const int K = (V + 1) * EPZ * EPH * EPW;
  const long long rows = embed_dw_rows(B, s, HT);
  wgrad<T>(rows, K + 1, C,
           PatchCols<T>{(const T*)up, (const T*)ch, V, levels, lat, lon, ZP,
                        HT, WT, K},
           TokenRows<T>{(const T*)dxs, s, C, ZP, HT, WT}, (float*)part,
           (float*)out, st);
  PANGU_CHECK_LAUNCH();
  return 0;
}

}  // namespace pangu

using namespace pangu;

// float32 elements of the split partials the entry below needs
extern "C" long long pangu_embed_dw_ws(int B, int nz, int nlat, int nlon,
                                       int n, int wz, int wh, int ww, int C,
                                       int HT, int V) {
  WmShape s = {nz, nlat, nlon, n, wz, wh, ww};
  return (long long)wg_splits(embed_dw_rows(B, s, HT)) *
         ((V + 1) * EPZ * EPH * EPW + 1) * C;
}

// dtype: 0 = float32, 1 = bfloat16.  out: float32 ((V+1)*32 + 1, C), the
// kernel gradient in ONNX row order and, last, the bias gradient.  Returns a
// cudaError_t (0 = ok).
extern "C" int pangu_embed_dw(int dtype, const void* dxs, const void* up,
                              const void* ch, void* part, void* out, int B,
                              int nz, int nlat, int nlon, int n, int wz,
                              int wh, int ww, int C, int HT, int V, int levels,
                              int lat, int lon, void* stream) {
  WmShape s = {nz, nlat, nlon, n, wz, wh, ww};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return embed_dw<float>(dxs, up, ch, part, out, B, s, C, HT, V, levels, lat,
                           lon, st);
  if (dtype == 1)
    return embed_dw<bf16>(dxs, up, ch, part, out, B, s, C, HT, V, levels, lat,
                          lon, st);
  return (int)cudaErrorInvalidValue;
}
