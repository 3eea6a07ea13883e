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
// the 135 MB normalised field (and the 27 MB const_h) and writes 206 MB of
// storage for 3.4e10 FLOP (2 x 456k upper-plane rows x 192 x 192).  bf16
// runs the upper planes on the tensor cores (edge_mma.cuh, EmbedMma: one
// CTA a 128-token tile of one (batch, plane, lat row) group and all C
// output columns, so each patch is read once; in the ONNX feature order a
// token's 4 w_off values are 8 contiguous bytes of the field, so a 32-wide
// k slice -- one variable -- is 8 (zo, ho) runs copied 8 bytes a cp.async,
// a warp's lanes on neighbouring tokens of one run (256 contiguous bytes),
// zero-filled past level 13 and latitude 721; round(acc + b) staged and
// whole rows written 16 bytes a lane) and plane 0 in a second launch, 16
// bytes a lane.  float32 keeps the first version (edge_gemm.cuh: the
// element-a-lane gather, 64 x 64 tiles; plane 0 an element a thread).
#include "edge_mma.cuh"

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
  edge_gemm(op, B * op.ZP * op.Hp, stream);
  PANGU_CHECK_LAUNCH();
  const long long total = (long long)B * op.Hp * op.M * C;
  embed_surface_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      (const T*)st, (T*)out, total, C, op.M, op.Hp, HT, s);
  PANGU_CHECK_LAUNCH();
  return 0;
}

// the bf16 upper planes on the tensor cores (edge_mma.cuh): row r of group
// (b, zp, h) is the patch of token (zp, h, r), gathered 8 bytes (4 w_off
// values) a copy; round_T(acc + b) staged and written as whole wm rows, 16
// bytes a lane, zeros on the lat-pad groups
struct EmbedMma {
  using Tile = EmTile<4, 2, 2, 12, 2>;         // 128 rows x 192 columns
  static constexpr int kOutLd = Tile::BN + 8;  // rows read 16 bytes a lane
  const bf16* up;    // (B, V, levels, lat, lon), normalised
  const bf16* ch;    // (levels, lat, lon)
  const bf16* w;     // (K, C)
  const bf16* bias;  // (C)
  bf16* out;         // (B, nz, nlat, nlon, N, C)
  WmShape s;
  int V, levels, lat, lon, ZP, Hp, HT;
  int K, N, M;
  long long groups;

  __device__ bool active(int g) const { return g % Hp < HT; }
  __device__ const bf16* mat(int) const { return w; }
  // the patch corner of token (zp, h, r) -- level 2zp, lat 4h, lon 4r -- in
  // one (levels, lat, lon) volume
  __device__ long long src(int g, int r) const {
    const int h = g % Hp, zp = (g / Hp) % ZP;
    return ((long long)PZ * zp * lat + PH * h) * lon + PW * r;
  }
  __device__ long long dst(int g, int r) const {  // the wm row of token r
    const int h = g % Hp, zp = (g / Hp) % ZP, b = g / (Hp * ZP);
    return wm_row(b, zp + 1, h, r, s);
  }
  // the k slice [k0, k0 + 32) is variable v = k0 / 32 (v = V: const_h):
  // its 8 (zo, ho) runs of 4 w_off values, 8 bytes a copy, idx % BM the
  // row, so that a warp's lanes copy one run of neighbouring tokens (on an
  // H100 10% faster than a loop over one row's runs a thread, which
  // spilled more)
  template <class T>
  __device__ void load_a(bf16* as, int k0, int g, int nrows,
                         const long long* src) const {
    static_assert(EM_BK == PZ * PH * PW, "a k slice is one variable's patch");
    const int h = g % Hp, zp = (g / Hp) % ZP, b = g / (Hp * ZP);
    const int v = k0 / EM_BK;
    const bf16* base =
        v < V ? up + ((long long)b * V + v) * levels * lat * lon : ch;
    for (int idx = threadIdx.x; idx < T::BM * PZ * PH; idx += T::THREADS) {
      const int r = idx % T::BM, j = idx / T::BM;  // j = (zo, ho)
      const int zo = j / PH, ho = j % PH;
      const bool ok = r < nrows && PZ * zp + zo < levels && PH * h + ho < lat;
      const bf16* p =
          ok ? base + src[r] + ((long long)zo * lat + ho) * lon : base;
      cp_async8_zfill(as + r * T::A_LD + PW * j, p, ok);
    }
  }
  __device__ float pre(int n, float acc) const {  // the bias in float32
    return n < N ? acc + to_f(bias[n]) : 0.f;
  }
  // the staged rows, or zeros on a lat-pad group, 8 columns a lane
  template <int kBN>
  __device__ void write(int, int, int nrows, int n0, const bf16* tile,
                        const long long* dst, bool act) const {
    const int chunks = min(kBN, N - n0) / 8;
    for (int idx = threadIdx.x; idx < nrows * chunks; idx += blockDim.x) {
      const int r = idx / chunks, c = idx % chunks * 8;
      const uint4 v =
          act ? *reinterpret_cast<const uint4*>(tile + r * kOutLd + c)
              : make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(out + dst[r] * N + n0 + c) = v;
    }
  }
};

// token plane 0 in bf16: one lane per 8 channels (16 bytes) of a row
__global__ void __launch_bounds__(256)
embed_plane0_kernel(const bf16* __restrict__ st, bf16* __restrict__ out,
                    long long chunks, int C, int WT, int Hp, int HT,
                    WmShape s) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= chunks) return;
  const int cpr = C / 8, c = (int)(i % cpr) * 8;
  const long long row = i / cpr;
  const int wt = (int)(row % WT);
  const int h = (int)((row / WT) % Hp);
  const int b = (int)(row / ((long long)WT * Hp));
  const uint4 v =
      h < HT ? __ldg(reinterpret_cast<const uint4*>(
                   st + (((long long)b * HT + h) * WT + wt) * C + c))
             : make_uint4(0u, 0u, 0u, 0u);
  *reinterpret_cast<uint4*>(out + wm_row(b, 0, h, wt, s) * C + c) = v;
}

static int embed_wm_bf16(const bf16* up, const bf16* ch, const bf16* st,
                         const bf16* w, const bf16* bias, bf16* out, int B,
                         WmShape s, int C, int V, int levels, int lat, int lon,
                         int HT, cudaStream_t stream) {
  EmbedMma op;
  op.up = up;
  op.ch = ch;
  op.w = w;
  op.bias = bias;
  op.out = out;
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
  op.groups = (long long)B * op.ZP * op.Hp;
  const cudaError_t e = edge_mma(op, stream);
  if (e != cudaSuccess) return (int)e;
  const long long chunks = (long long)B * op.Hp * op.M * (C / 8);
  if (chunks == 0) return 0;
  embed_plane0_kernel<<<(unsigned)((chunks + 255) / 256), 256, 0, stream>>>(
      st, out, chunks, C, op.M, op.Hp, HT, s);
  return (int)cudaGetLastError();
}

}  // namespace pangu

using namespace pangu;

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = ok;
// cudaErrorInvalidValue for a bf16 C that is not a multiple of 8, a
// longitude count that is not a multiple of 4, or an operand off a 16-byte
// boundary).
extern "C" int pangu_embed_wm(int dtype, const void* upper, const void* const_h,
                              const void* surface_tokens, const void* w,
                              const void* bias, void* out, int B, int nz,
                              int nlat, int nlon, int n, int C, int wz, int wh,
                              int ww, int V, int levels, int lat, int lon, int HT,
                              void* stream) {
  WmShape s = {nz, nlat, nlon, n, wz, wh, ww};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return embed_wm<float>(upper, const_h, surface_tokens, w, bias, out, B, s,
                           C, V, levels, lat, lon, HT, st);
  // bf16: the tensor-core tiles
  if (dtype != 1 || C % 8 || lon % PW ||
      !aligned16_all({upper, const_h, surface_tokens, w, out}))
    return (int)cudaErrorInvalidValue;
  return embed_wm_bf16((const bf16*)upper, (const bf16*)const_h,
                       (const bf16*)surface_tokens, (const bf16*)w,
                       (const bf16*)bias, (bf16*)out, B, s, C, V, levels, lat,
                       lon, HT, st);
}
