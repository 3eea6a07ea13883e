// The backward of patch recovery from the rolled window-major pair.
//
// Replaces the Pallas kernel pangu_tpu/ops/recovery_wm.py::
// recovery_bwd_pallas (kernel _make_bwd_kernel).  Inputs: the field
// cotangents dU (B, V, levels, lat, lon) and dS (B, S, lat, lon), in the
// pair's dtype; the saved pair skip / dec (B, nz, nlat, nlon, N, C), rolled
// by ``off`` (storage position p holds canonical token p + off); the heads'
// kernels Ku (2C, V*32) and Ks (2C, S*16).  The feature cotangent of
// canonical token t = (z, h, w) is the forward's scatter read back:
//
//   upper   (z = zp + 1): dF[(v, zo, ho, wo)] = dU[v, 2zp + zo, 4h + ho, 4w + wo]
//   surface (z = 0):      dF[(s, ho, wo)]     = dS[s, 4h + ho, 4w + wo]
//
// zero beyond the levels and latitudes of the field and on the token-lat pad
// rows (h >= HT).  Outputs:
//
//   1. token cotangents, one launch per head over every canonical token of
//      its planes, pad rows included (they get zeros), each written to its
//      storage row t - off (the inverse of the forward's modular read):
//        d_skip[t - off] = round_T(dF @ K[:C]^T),  d_dec = round_T(dF @ K[C:]^T)
//   2. the heads' gradients, float32, one split-K weight-gradient product per
//      head over the real tokens (grad_gemm.cuh; the bias a row of ones):
//        dK[c, f] = sum_t [skip | dec][t - off][c] * dF[t][f],  db[f] = sum_t dF[t][f]
//      each split keeps its own partial and a second pass adds them in
//      order, so the sums are the same in every run.
//
// The TPU kernel walks storage blocks and runs the lon interleave as a
// transposed selection matmul; here the interleave and the roll-back are
// index arithmetic in the loaders.
//
// What bounds it on an H100: memory traffic.  At full width (bf16) it reads
// the field cotangents (143 MB) twice and the pair (412 MB), and writes the
// pair's cotangents (412 MB), for about 1.5e11 FLOP.
#include "edge_gemm.cuh"
#include "grad_gemm.cuh"

namespace pangu {

constexpr int RPZ = 2, RPH = 4, RPW = 4;  // the patch (recovery_supported)

// canonical tokens of one head's planes: upper planes z = 1..Z-1 (surface
// = 0: the plane z = 0), h over ``hrows`` token-lat rows
struct HeadTokens {
  int surface, planes, hrows, WT;
  // 32-bit index arithmetic: a head has fewer than 2^31 tokens
  __device__ __forceinline__ void split(long long r, int& b, int& z, int& h,
                                        int& w) const {
    int q = (int)r;
    w = q % WT;
    q /= WT;
    h = q % hrows;
    q /= hrows;
    const int zp = q % planes;
    b = q / planes;
    z = surface ? 0 : zp + 1;
  }
};

// dF[t][f] of canonical token r of a head
template <typename T>
struct FieldCot {
  static constexpr bool kKFast = false;
  const T* d;  // dU or dS
  HeadTokens tk;
  int V, levels, lat, lon, HT;
  __device__ T operator()(long long r, long long f) const {
    int b, z, h, w;
    tk.split(r, b, z, h, w);
    if (h >= HT) return from_f<T>(0.f);
    const int fi = (int)f;
    const int wo = fi % RPW, ho = (fi / RPW) % RPH;
    int v, lev;
    if (tk.surface) {
      v = fi / (RPH * RPW);
      lev = 0;
    } else {
      v = fi / (RPZ * RPH * RPW);
      lev = RPZ * (z - 1) + (fi / (RPH * RPW)) % RPZ;
    }
    const int la = RPH * h + ho;
    if (lev >= levels || la >= lat) return from_f<T>(0.f);
    return d[(((long long)b * V + v) * levels + lev) * lat * lon +
             (long long)la * lon + RPW * w + wo];
  }
};

// dF as the A operand of the token-cotangent product
template <typename T>
struct FieldCotA {
  static constexpr bool kKFast = true;
  FieldCot<T> f;
  __device__ T operator()(long long r, long long k) const { return f(r, k); }
};

// the pair's row of token r as the transposed A operand of the head
// gradient: element i < C of skip, C <= i < 2C of dec, i == 2C reads 1
template <typename T>
struct PairCols {
  static constexpr bool kKFast = false;
  const T* skip;
  const T* dec;
  HeadTokens tk;
  WmShape s;
  int C, oz, olat, olon;
  __device__ T operator()(long long i, long long r) const {
    if (i == 2 * C) return from_f<T>(1.f);
    int b, z, h, w;
    tk.split(r, b, z, h, w);
    const long long row = rolled_row(b, z, h, w, s, oz, olat, olon);
    return i < C ? skip[row * C + i] : dec[row * C + i - C];
  }
};

// token-cotangent epilogue: columns < C to d_skip, the rest to d_dec, at the
// token's storage row
template <typename T>
struct PairStore {
  T* dskip;
  T* ddec;
  HeadTokens tk;
  WmShape s;
  int C, oz, olat, olon;
  __device__ void operator()(int, long long r, int c, float acc) const {
    int b, z, h, w;
    tk.split(r, b, z, h, w);
    const long long row = rolled_row(b, z, h, w, s, oz, olat, olon);
    if (c < C)
      dskip[row * C + c] = from_f<T>(acc);
    else
      ddec[row * C + c - C] = from_f<T>(acc);
  }
};

inline long long head_rows(int B, HeadTokens tk) {
  return (long long)B * tk.planes * tk.hrows * tk.WT;
}

template <typename T>
int recovery_bwd(const T* du, const T* ds, const T* skip, const T* dec,
                 const T* ku, const T* ks, T* dskip, T* ddec, float* part,
                 float* dku, float* dks, int B, WmShape s, int C, int HT,
                 int V, int S, int levels, int lat, int lon, int oz, int olat,
                 int olon, cudaStream_t st) {
  const int Z = s.nz * s.wz, HP = s.nlat * s.wh, WT = s.nlon * s.ww;
  for (int surface = 0; surface < 2; ++surface) {
    const T* d = surface ? ds : du;
    const T* k = surface ? ks : ku;
    const int F = surface ? S * RPH * RPW : V * RPZ * RPH * RPW;
    const int planes = surface ? 1 : Z - 1;
    const int lev = surface ? 1 : levels;
    const int nv = surface ? S : V;
    // 1. token cotangents over every token (pad rows too)
    const HeadTokens all = {surface, planes, HP, WT};
    xgemm((T*)nullptr, head_rows(B, all), 2 * C, F,
          FieldCotA<T>{FieldCot<T>{d, all, nv, lev, lat, lon, HT}},
          BCols<T>{k, F}, PairStore<T>{dskip, ddec, all, s, C, oz, olat, olon},
          st);
    PANGU_CHECK_LAUNCH();
    // 2. the head's gradients over the real tokens
    const HeadTokens real = {surface, planes, HT, WT};
    wgrad<T>(head_rows(B, real), 2 * C + 1, F,
             PairCols<T>{skip, dec, real, s, C, oz, olat, olon},
             FieldCot<T>{d, real, nv, lev, lat, lon, HT}, part,
             surface ? dks : dku, st);
    PANGU_CHECK_LAUNCH();
  }
  return 0;
}

}  // namespace pangu

using namespace pangu;

// float32 elements of the split partials the entry below needs
extern "C" long long pangu_recovery_bwd_ws(int B, int nz, int wz, int HT,
                                           int WT, int C, int V) {
  const HeadTokens real = {0, nz * wz - 1, HT, WT};
  return (long long)wg_splits(head_rows(B, real)) * (2 * C + 1) *
         (V * RPZ * RPH * RPW);
}

// dtype: 0 = float32, 1 = bfloat16.  Outputs: d_skip, d_dec (the pair's
// storage, rolled by off like the pair), float32 dku (2C+1, V*32) and
// dks (2C+1, S*16), the last row the bias gradient.  The surface partials
// fit in the upper ones (S*16 <= V*32).  Returns a cudaError_t (0 = ok).
extern "C" int pangu_recovery_bwd(
    int dtype, const void* du, const void* ds, const void* skip,
    const void* dec, const void* ku, const void* ks, void* dskip, void* ddec,
    void* part, void* dku, void* dks, int B, int nz, int nlat, int nlon, int n,
    int C, int wz, int wh, int ww, int HT, int V, int S, int levels, int lat,
    int lon, int off_z, int off_lat, int off_lon, void* stream) {
  WmShape s = {nz, nlat, nlon, n, wz, wh, ww};
  cudaStream_t st = (cudaStream_t)stream;
#define PANGU_RBWD(T)                                                          \
  return recovery_bwd<T>((const T*)du, (const T*)ds, (const T*)skip,          \
                         (const T*)dec, (const T*)ku, (const T*)ks, (T*)dskip, \
                         (T*)ddec, (float*)part, (float*)dku, (float*)dks, B,  \
                         s, C, HT, V, S, levels, lat, lon, off_z, off_lat,     \
                         off_lon, st)
  if (dtype == 0) PANGU_RBWD(float);
  if (dtype == 1) PANGU_RBWD(bf16);
#undef PANGU_RBWD
  return (int)cudaErrorInvalidValue;
}
