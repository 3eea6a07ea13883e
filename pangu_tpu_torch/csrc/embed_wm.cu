// Patch embedding straight into stage-0 window-major entry storage.
//
// Replaces the Pallas kernel pangu_tpu/ops/embed_wm.py::embed_wm (kernel
// _make_kernel).  Inputs, prepared in PyTorch as the JAX package prepares
// them in XLA: the upper field normalised in the compute dtype
// (B, V, levels, lat, lon), const_h (levels, lat, lon), and the surface token
// plane (B, HT, WT, C), already projected.  Two launches:
//
//   1. upper planes: one group per (batch, upper token plane zp, token-lat
//      row h); row wt of the group is the patch of token (zp, h, wt):
//        a[k] = x6[v, 2zp + zo, 4h + ho, 4wt + wo],  k = (v, zo, ho, wo),
//      v < V the normalised upper variables and v = V const_h, zero where
//      the level or the latitude lies beyond the field (the zero padding of
//      levels 13 -> 14 and lat 721 -> 724);
//        out[wm row of (zp + 1, h, wt)] = round_T(a @ W + b)
//      with the sum in float32.  Token-lat pad rows (h >= HT) are zeros.
//   2. surface plane: token plane 0 is the surface token plane, copied into
//      its wm rows, zeros on the pad rows.
//
// The TPU kernel pads longitude 1440 -> 1536, reorders the weights to
// (pw, 48, C) and transposes a lane tile so that its matrix unit can gather
// the patch; here the gather is index arithmetic in the tile load.
//
// What bounds it on an H100: memory traffic.  At full width (bf16) it reads
// the 135 MB normalised field (and the 2 MB const_h) and writes 206 MB of
// storage for 3.4e10 FLOP (2 x 456k upper-plane rows x 192 x 192).
#include "edge_gemm.cuh"

namespace pangu {

constexpr int PZ = 2, PH = 4, PW = 4;  // the patch (embed_supported)

template <typename T>
struct EmbedOp {
  static constexpr bool kLonOrder = false;
  struct Row {
    long long u, c, dst;
    int lev0, lat0, zero;
  };
  const T* up;    // (B, V, levels, lat, lon), normalised
  const T* ch;    // (levels, lat, lon)
  const T* w;     // (K, C)
  const T* bias;  // (C)
  T* out;         // (B, nz, nlat, nlon, N, C)
  WmShape s;
  int V, levels, lat, lon, ZP, Hp, HT;
  int K, N, M;

  __device__ bool active(int g) const { return g % Hp < HT; }
  __device__ const T* mat(int) const { return w; }
  __device__ Row row(int g, int r) const {
    const int h = g % Hp, zp = (g / Hp) % ZP, b = g / (Hp * ZP);
    Row q;
    q.lev0 = PZ * zp;
    q.lat0 = PH * h;
    q.zero = h >= HT;
    q.c = ((long long)q.lev0 * lat + q.lat0) * lon + PW * r;
    q.u = (long long)b * V * levels * lat * lon + q.c;
    q.dst = wm_row(b, zp + 1, h, r, s) * N;
    return q;
  }
  __device__ T load(const Row& q, int k) const {
    const int v = k / (PZ * PH * PW), zo = (k / (PH * PW)) % PZ;
    const int ho = (k / PW) % PH, wo = k % PW;
    if (q.lev0 + zo >= levels || q.lat0 + ho >= lat) return from_f<T>(0.f);
    const long long o = ((long long)zo * lat + ho) * lon + wo;
    return v < V ? up[q.u + (long long)v * levels * lat * lon + o] : ch[q.c + o];
  }
  __device__ void store(const Row& q, int n, float acc) const {
    out[q.dst + n] = q.zero ? from_f<T>(0.f) : from_f<T>(acc + to_f(bias[n]));
  }
};

// 2. one thread per element of token plane 0
template <typename T>
__global__ void __launch_bounds__(256)
embed_surface_kernel(const T* __restrict__ st, T* __restrict__ out, long long total,
                     int C, int WT, int Hp, int HT, WmShape s) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int c = (int)(i % C);
  const long long row = i / C;
  const int wt = (int)(row % WT);
  const int h = (int)((row / WT) % Hp);
  const int b = (int)(row / ((long long)WT * Hp));
  out[wm_row(b, 0, h, wt, s) * C + c] =
      h < HT ? st[(((long long)b * HT + h) * WT + wt) * C + c] : from_f<T>(0.f);
}

template <typename T>
int embed_wm(const void* up, const void* ch, const void* st, const void* w,
             const void* bias, void* out, int B, WmShape s, int C, int V,
             int levels, int lat, int lon, int HT, cudaStream_t stream) {
  EmbedOp<T> op;
  op.up = (const T*)up;
  op.ch = (const T*)ch;
  op.w = (const T*)w;
  op.bias = (const T*)bias;
  op.out = (T*)out;
  op.s = s;
  op.V = V;
  op.levels = levels;
  op.lat = lat;
  op.lon = lon;
  op.ZP = s.nz * s.wz - 1;
  op.Hp = s.nlat * s.wh;
  op.HT = HT;
  op.K = (V + 1) * PZ * PH * PW;
  op.N = C;
  op.M = s.nlon * s.ww;
  edge_gemm(op, B * op.ZP * op.Hp, (T*)nullptr, stream);
  PANGU_CHECK_LAUNCH();
  const long long total = (long long)B * op.Hp * op.M * C;
  embed_surface_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      (const T*)st, (T*)out, total, C, op.M, op.Hp, HT, s);
  PANGU_CHECK_LAUNCH();
  return 0;
}

}  // namespace pangu

using namespace pangu;

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = ok).
extern "C" int pangu_embed_wm(int dtype, const void* upper, const void* const_h,
                              const void* surface_tokens, const void* w,
                              const void* bias, void* out, int B, int nz,
                              int nlat, int nlon, int n, int C, int wz, int wh,
                              int ww, int V, int levels, int lat, int lon, int HT,
                              void* stream) {
  WmShape s = {nz, nlat, nlon, n, wz, wh, ww};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return embed_wm<float>(upper, const_h, surface_tokens, w, bias, out, B, s, C, V,
                           levels, lat, lon, HT, st);
  if (dtype == 1)
    return embed_wm<bf16>(upper, const_h, surface_tokens, w, bias, out, B, s, C, V,
                          levels, lat, lon, HT, st);
  return (int)cudaErrorInvalidValue;
}
