// Patch recovery straight from the rolled window-major skip/decoder pair.
//
// Replaces the two Pallas kernels of pangu_tpu/ops/recovery_wm.py::
// recovery_wm: the upper kernel (_make_upper_kernel) and the surface kernel
// (_make_surface_kernel).  One C entry, one launch per call, ``surface``
// picking the branch.  For canonical token t = (z, h, w), read from storage
// at t - off (storage position p holds canonical token p + off):
//
//   y = round_T([skip | dec][t - off] @ W + b)     float32 sum, skip rows of
//                                                  W are [:C], dec rows [C:]
//   upper   (z = zp + 1, features (var, zo, ho, wo)):
//     out[var, 2zp + zo, 4h + ho, 4w + wo] = y[(var, zo, ho, wo)]
//   surface (z = 0, features (var, ho, wo)):
//     out[var, 4h + ho, 4w + wo] = y[(var, ho, wo)]
//
// with levels >= 13 and lat >= 721 cropped (never written).  Only the real
// token-lat rows h < HT are groups.  The TPU kernels stitch two lat-window
// chunks, pad the features to 256 lanes, transpose per token row and
// interleave w_off with a 0/1 selection matmul; here the roll-back is a
// modular index and the interleave a scattered store, ordered so that
// neighbouring threads write neighbouring longitudes.
//
// What bounds it on an H100: memory traffic.  At full width (bf16) the upper
// branch reads 7/8 of the pair's real rows (350 MB) and writes the 135 MB
// field for 5.6e10 FLOP; the surface branch reads plane 0 (50 MB) and
// writes 8.3 MB for 3.2e9 FLOP.  bf16 runs on the tensor cores
// (edge_mma.cuh: one CTA a tile of one group and all the branch's features,
// 128 rows x 160 (upper) or 64 rows x 64 (surface: 1086 CTAs of 4 warps at
// full width, no spills; 543 CTAs of 128 rows and 8 warps ran as fast on an
// H100), each gathered row read once, 16 bytes a copy; y rounded into
// shared memory, then each (var, zo, ho) line of the tile's consecutive
// longitudes written 16 bytes a lane).  float32 keeps the first version
// (edge_gemm.cuh: the element-a-lane gather, 64 x 64 tiles, 4-byte
// scattered stores).
#include "edge_mma.cuh"

namespace pangu {

constexpr int PZ = 2, PH = 4, PW = 4;  // the patch (recovery_supported)

template <typename T>
struct RecoveryOp {
  static constexpr bool kLonOrder = true;
  struct Row {
    long long src, dst;
    int lev0, lat0;
  };
  const T* skip;
  const T* dec;
  const T* w;     // (2C, N)
  const T* bias;  // (N)
  T* out;         // upper (B, V, levels, lat, lon); surface (B, V, lat, lon)
  WmShape s;
  int C, surface, planes, HT, V, levels, lat, lon, oz, olat, olon;
  int K, N, M;

  __device__ bool active(int) const { return true; }
  __device__ const T* mat(int) const { return w; }
  __device__ Row row(int g, int r) const {
    const int h = g % HT, zp = (g / HT) % planes, b = g / (HT * planes);
    Row q;
    q.src = rolled_row(b, surface ? 0 : zp + 1, h, r, s, oz, olat, olon) * C;
    q.lev0 = PZ * zp;
    q.lat0 = PH * h;
    q.dst = ((((long long)b * V) * levels + q.lev0) * lat + q.lat0) * lon + PW * r;
    return q;
  }
  __device__ T load(const Row& q, int k) const {
    return k < C ? skip[q.src + k] : dec[q.src + k - C];
  }
  __device__ void store(const Row& q, int n, float acc) const {
    const int wo = n % PW, ho = (n / PW) % PH;
    int var, zo;
    if (surface) {
      var = n / (PH * PW);
      zo = 0;
    } else {
      var = n / (PZ * PH * PW);
      zo = (n / (PH * PW)) % PZ;
    }
    if (q.lev0 + zo >= levels || q.lat0 + ho >= lat) return;
    out[q.dst + (((long long)var * levels + zo) * lat + ho) * lon + wo] =
        from_f<T>(acc + to_f(bias[n]));
  }
};

template <typename T>
int recovery_wm(int surface, const void* skip, const void* dec, const void* w,
                const void* bias, void* out, int B, WmShape s, int C, int HT,
                int V, int levels, int lat, int lon, int oz, int olat, int olon,
                cudaStream_t st) {
  RecoveryOp<T> op;
  op.skip = (const T*)skip;
  op.dec = (const T*)dec;
  op.w = (const T*)w;
  op.bias = (const T*)bias;
  op.out = (T*)out;
  op.s = s;
  op.C = C;
  op.surface = surface;
  op.planes = surface ? 1 : s.nz * s.wz - 1;
  op.HT = HT;
  op.V = V;
  op.levels = surface ? 1 : levels;
  op.lat = lat;
  op.lon = lon;
  op.oz = oz;
  op.olat = olat;
  op.olon = olon;
  op.K = 2 * C;
  op.N = V * (surface ? 1 : PZ) * PH * PW;
  op.M = s.nlon * s.ww;
  edge_gemm(op, B * op.planes * HT, st);
  PANGU_CHECK_LAUNCH();
  return 0;
}

// the bf16 branches on the tensor cores (edge_mma.cuh): y staged as
// round_T(acc + b), then each (var, zo, ho) line of the field (zo = 0 for
// the surface) written as the tile's consecutive longitudes 4r + wo, two
// rows (16 bytes) a lane
template <bool kSurface>
struct RecoveryMma : PairA {
  // upper: 128 rows x 160 features (var, zo, ho, wo); surface: 64 rows x
  // 64 features (var, ho, wo)
  using Tile = std::conditional_t<kSurface, EmTile<2, 2, 2, 4, 4>,
                                  EmTile<4, 2, 2, 10, 2>>;
  static constexpr int kZo = kSurface ? 1 : PZ;  // level offsets a feature
  // a lane reads 8 bytes of rows 2q and 2q + 1: a row of BN / 2 + 2 words
  // puts a half-warp's 16 reads on 8 bank pairs (BN + 8: 4)
  static constexpr int kOutLd = Tile::BN + 4;
  const bf16* w;     // (2C, N)
  const bf16* bias;  // (N)
  bf16* out;  // upper (B, V, levels, lat, lon); surface (B, V, lat, lon)
  WmShape s;
  int planes, HT, V, levels, lat, lon, oz, olat, olon, vec16;
  int K, N, M;
  long long groups;

  __device__ bool active(int) const { return true; }
  __device__ const bf16* mat(int) const { return w; }
  __device__ long long src(int g, int r) const {  // token plane zp + 1, or 0
    const int h = g % HT, zp = (g / HT) % planes, b = g / (HT * planes);
    return rolled_row(b, kSurface ? 0 : zp + 1, h, r, s, oz, olat, olon) * C;
  }
  __device__ long long dst(int g, int r) const {  // out[b, 0, 2zp, 4h, 4r]
    const int h = g % HT, zp = (g / HT) % planes, b = g / (HT * planes);
    return ((((long long)b * V) * levels + PZ * zp) * lat + PH * h) * lon +
           PW * r;
  }
  __device__ float pre(int n, float acc) const {  // the bias in float32
    return n < N ? acc + to_f(bias[n]) : 0.f;
  }
  // feature n = (var, zo, ho, wo) of row r to out[var, 2zp + zo, 4h + ho,
  // 4r + wo], a level or latitude past the field's cropped
  template <int kBN>
  __device__ void write(int g, int, int nrows, int n0, const bf16* tile,
                        const long long* dst, bool) const {
    const int h = g % HT, zp = (g / HT) % planes;
    const int lines = min(kBN, N - n0) / PW, pairs = (nrows + 1) / 2;
    const long long plane = (long long)lat * lon;
    for (int idx = threadIdx.x; idx < lines * pairs; idx += blockDim.x) {
      const int q = idx % pairs, ln = idx / pairs, l = n0 / PW + ln;
      const int ho = l % PH, zo = (l / PH) % kZo, var = l / (kZo * PH);
      if (PZ * zp + zo >= levels || PH * h + ho >= lat) continue;
      const int r = 2 * q;
      bf16* o = out + dst[r] + ((long long)var * levels + zo) * plane +
                (long long)ho * lon;
      const bf16* y = tile + r * kOutLd + PW * ln;
      const uint2 lo = *reinterpret_cast<const uint2*>(y);
      if (r + 1 >= nrows) {
        *reinterpret_cast<uint2*>(o) = lo;
      } else {
        const uint2 hi = *reinterpret_cast<const uint2*>(y + kOutLd);
        if (vec16) {
          *reinterpret_cast<uint4*>(o) = make_uint4(lo.x, lo.y, hi.x, hi.y);
        } else {
          *reinterpret_cast<uint2*>(o) = lo;
          *reinterpret_cast<uint2*>(o + PW) = hi;
        }
      }
    }
  }
};

template <bool kSurface>
static int recovery_bf16(const bf16* skip, const bf16* dec, const bf16* w,
                         const bf16* bias, bf16* out, int B, WmShape s, int C,
                         int HT, int V, int levels, int lat, int lon, int oz,
                         int olat, int olon, cudaStream_t st) {
  RecoveryMma<kSurface> op;
  op.skip = skip;
  op.dec = dec;
  op.w = w;
  op.bias = bias;
  op.out = out;
  op.s = s;
  op.C = C;
  op.planes = kSurface ? 1 : s.nz * s.wz - 1;
  op.HT = HT;
  op.V = V;
  op.levels = kSurface ? 1 : levels;
  op.lat = lat;
  op.lon = lon;
  op.oz = oz;
  op.olat = olat;
  op.olon = olon;
  op.vec16 = lon % 8 == 0;  // every line's 16-byte chunks then aligned
  op.K = 2 * C;
  op.N = V * RecoveryMma<kSurface>::kZo * PH * PW;
  op.M = s.nlon * s.ww;
  op.groups = (long long)B * op.planes * HT;
  return (int)edge_mma(op, st);
}

}  // namespace pangu

using namespace pangu;

// dtype: 0 = float32, 1 = bfloat16; surface: 0 = upper branch, 1 = surface
// branch.  Returns a cudaError_t (0 = ok; cudaErrorInvalidValue for a bf16
// C that is not a multiple of 8, a longitude count that is not a multiple
// of 4, or an operand off a 16-byte boundary).
extern "C" int pangu_recovery_wm(int dtype, int surface, const void* skip,
                                 const void* dec, const void* w, const void* bias,
                                 void* out, int B, int nz, int nlat, int nlon,
                                 int n, int C, int wz, int wh, int ww, int HT,
                                 int V, int levels, int lat, int lon, int off_z,
                                 int off_lat, int off_lon, void* stream) {
  WmShape s = {nz, nlat, nlon, n, wz, wh, ww};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return recovery_wm<float>(surface, skip, dec, w, bias, out, B, s, C, HT, V,
                              levels, lat, lon, off_z, off_lat, off_lon, st);
  // bf16, both branches: the tensor-core tiles
  if (dtype != 1 || C % 8 || lon % 4 || !aligned16_all({skip, dec, w, out}))
    return (int)cudaErrorInvalidValue;
  return (surface ? recovery_bf16<true> : recovery_bf16<false>)(
      (const bf16*)skip, (const bf16*)dec, (const bf16*)w, (const bf16*)bias,
      (bf16*)out, B, s, C, HT, V, levels, lat, lon, off_z, off_lat, off_lon,
      st);
}
