// Token-space transition between chained forecast steps: the composed
// patch recovery -> de-norm -> re-norm -> patch embed as one per-token affine
// map, read from the rolled window-major skip/decoder pair and written as the
// next step's stage-0 window-major entry storage in canonical coordinates.
//
// Replaces the Pallas kernel pangu_tpu/engine/transition_wm.py::
// apply_transition_wm (kernel _make_transition_wm_kernel).  For canonical
// token t = (z, lat, lon):
//
//   out[t] = round_T( round_T([skip | dec][t - off] @ M_type(z, lat))
//                     + bias_field_wm[t] )
//
// where storage position p holds canonical token p + off (so t is read at
// t - off, each coordinate modulo its extent) and the type is
//   plane 0:         M_s,  or M_sh  on the last real lat row h - 1;
//   planes 1..Z-2:   M_u,  or M_uh;
//   plane Z-1:       M_uz, or M_uzh.
// On a tp z shard (the Pallas kernel's z_scalar=True variant) the pair, the
// bias field and the output are the shard's own z windows and z is the
// GLOBAL plane: the entry's z0 (first global window) and nz_global type the
// surface and top-plane rows; one device passes 0 and nz, which is the
// single-device kernel exactly.  The read offset's z component is then 0.
// Latitude-pad rows (lat >= h) are written as zeros by select.  The TPU
// kernel runs the interior matrix everywhere and corrects the edge rows with
// a second product (its rounding differs by a bf16 ulp on those rows); here
// one group is one (batch, plane, lat row), so its matrix is chosen once and
// the rounding is the plain version's (engine/transition_wm.py).
//
// What bounds it on an H100: memory traffic.  At full width (bf16) it reads
// the skip/decoder pair of the real rows (400 MB) and the bias field (206
// MB) and writes 206 MB for 7.7e10 FLOP, ~95 FLOP per byte against the ~295
// at which the tensor cores would bind.  bf16 runs on the tensor cores
// (edge_mma.cuh: one CTA a 128-row tile of one group, all 192 output
// columns, so each gathered row is read once, 16 bytes a copy; the first
// rounding into shared memory, the bias field added and the row stored 16
// bytes a lane).  float32 keeps the first version (edge_gemm.cuh: 64 x 64
// tiles that re-read each gathered row once per output tile and load it
// element by element).
#include "edge_mma.cuh"

namespace pangu {

template <typename T>
struct TransitionOp {
  static constexpr bool kLonOrder = false;
  struct Row {
    long long src, dst, bias;
    int zero;
  };
  const T* skip;
  const T* dec;
  const T* bias;  // (1, nz, nlat, nlon, N, C)
  T* out;
  const T* mats[6];  // M_s, M_sh, M_u, M_uh, M_uz, M_uzh
  WmShape s;
  int C, Z, Hp, h_real, oz, olat, olon;
  int z0, Zg;  // the first local plane's global index, the global planes
  int K, N, M;

  __device__ bool active(int g) const { return g % Hp < h_real; }
  __device__ const T* mat(int g) const {
    const int lat = g % Hp, z = (g / Hp) % Z + z0;
    const int kind = z == 0 ? 0 : (z == Zg - 1 ? 4 : 2);
    return mats[kind + (lat == h_real - 1 ? 1 : 0)];
  }
  __device__ Row row(int g, int r) const {
    const int lat = g % Hp, z = (g / Hp) % Z, b = g / (Hp * Z);
    Row w;
    w.zero = lat >= h_real;
    w.src = rolled_row(b, z, lat, r, s, oz, olat, olon) * C;
    w.dst = wm_row(b, z, lat, r, s) * C;
    w.bias = wm_row(0, z, lat, r, s) * C;
    return w;
  }
  __device__ T load(const Row& w, int k) const {
    return k < C ? skip[w.src + k] : dec[w.src + k - C];
  }
  __device__ void store(const Row& w, int n, float acc) const {
    out[w.dst + n] = w.zero ? from_f<T>(0.f)
                            : from_f<T>(round_t<T>(acc) + to_f(bias[w.bias + n]));
  }
};

template <typename T>
int transition_wm(const void* skip, const void* dec, const void* bias,
                  const void* const* mats, void* out, int B, WmShape s, int C,
                  int h_real, int oz, int olat, int olon, int z0, int nzg,
                  cudaStream_t st) {
  TransitionOp<T> op;
  op.skip = (const T*)skip;
  op.dec = (const T*)dec;
  op.bias = (const T*)bias;
  op.out = (T*)out;
  for (int i = 0; i < 6; ++i) op.mats[i] = (const T*)mats[i];
  op.s = s;
  op.C = C;
  op.Z = s.nz * s.wz;
  op.Hp = s.nlat * s.wh;
  op.h_real = h_real;
  op.oz = oz;
  op.olat = olat;
  op.olon = olon;
  op.z0 = z0 * s.wz;
  op.Zg = nzg * s.wz;
  op.K = 2 * C;
  op.N = C;
  op.M = s.nlon * s.ww;
  edge_gemm(op, B * op.Z * op.Hp, st);
  PANGU_CHECK_LAUNCH();
  return 0;
}

// the bf16 route on the tensor cores (edge_mma.cuh): the same contract, the
// output written from the staged tile as whole rows, 16 bytes a lane
struct TransitionMma : PairA {
  using Tile = EmTile<4, 2, 2, 12, 2>;       // 128 rows x 192 columns
  static constexpr int kOutLd = Tile::BN + 8;  // rows read 16 bytes a lane
  const bf16* bias;  // (1, nz, nlat, nlon, N, C)
  bf16* out;
  const bf16* mats[6];  // M_s, M_sh, M_u, M_uh, M_uz, M_uzh
  WmShape s;
  int Z, Hp, h_real, oz, olat, olon;
  int z0, Zg;  // the first local plane's global index, the global planes
  int K, N, M;
  long long groups, sample_rows;

  __device__ bool active(int g) const { return g % Hp < h_real; }
  __device__ const bf16* mat(int g) const {
    const int lat = g % Hp, z = (g / Hp) % Z + z0;
    const int kind = z == 0 ? 0 : (z == Zg - 1 ? 4 : 2);
    return mats[kind + (lat == h_real - 1 ? 1 : 0)];
  }
  __device__ long long src(int g, int r) const {
    const int lat = g % Hp, z = (g / Hp) % Z, b = g / (Hp * Z);
    return rolled_row(b, z, lat, r, s, oz, olat, olon) * C;
  }
  __device__ long long dst(int g, int r) const {  // the output row
    const int lat = g % Hp, z = (g / Hp) % Z, b = g / (Hp * Z);
    return wm_row(b, z, lat, r, s);
  }
  __device__ float pre(int, float acc) const { return acc; }  // round_T(acc)
  __device__ const bf16* bias_row(int g, long long row) const {  // sample 0's
    return bias + (row - (long long)(g / (Hp * Z)) * sample_rows) * N;
  }
  // out = round_T(tile + bias), or zeros on a pad group, 8 columns a lane;
  // each lane's kLoads bias loads are in flight together
  template <int kBN>
  __device__ void write(int g, int, int nrows, int n0, const bf16* tile,
                        const long long* dst, bool act) const {
    constexpr int kLoads = 6;
    const int chunks = min(kBN, N - n0) / 8, total = nrows * chunks;
    for (int base = threadIdx.x; base < total; base += kLoads * blockDim.x) {
      uint4 braw[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int idx = base + u * blockDim.x;
        if (act && idx < total)
          braw[u] = __ldg(reinterpret_cast<const uint4*>(
              bias_row(g, dst[idx / chunks]) + n0 + idx % chunks * 8));
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int idx = base + u * blockDim.x;
        if (idx >= total) break;
        const int r = idx / chunks, c = idx % chunks * 8;
        float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (act) {
          float b[8];
          ld8(tile + r * kOutLd + c, v);
          unpack8(braw[u], b);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] += b[e];
        }
        st8(out + dst[r] * N + n0 + c, v);
      }
    }
  }
};

static int transition_wm_bf16(const bf16* skip, const bf16* dec,
                              const bf16* bias, const void* const* mats,
                              bf16* out, int B, WmShape s, int C, int h_real,
                              int oz, int olat, int olon, int z0, int nzg,
                              cudaStream_t st) {
  TransitionMma op;
  op.skip = skip;
  op.dec = dec;
  op.bias = bias;
  op.out = out;
  for (int i = 0; i < 6; ++i) op.mats[i] = (const bf16*)mats[i];
  op.s = s;
  op.C = C;
  op.Z = s.nz * s.wz;
  op.Hp = s.nlat * s.wh;
  op.h_real = h_real;
  op.oz = oz;
  op.olat = olat;
  op.olon = olon;
  op.z0 = z0 * s.wz;
  op.Zg = nzg * s.wz;
  op.K = 2 * C;
  op.N = C;
  op.M = s.nlon * s.ww;
  op.groups = (long long)B * op.Z * op.Hp;
  op.sample_rows = (long long)s.nz * s.nlat * s.nlon * s.n;
  return (int)edge_mma(op, st);
}

}  // namespace pangu

using namespace pangu;

// dtype: 0 = float32, 1 = bfloat16.  z0: the global index of the first
// local z window, nz_global: the global z windows (one device: 0 and nz; a
// tp z shard: its own window range, whose surface / top-plane rows are
// typed by the global plane).  Returns a cudaError_t (0 = ok;
// cudaErrorInvalidValue for a bf16 C that is not a multiple of 8, an
// operand off a 16-byte boundary or a window range outside nz_global).
extern "C" int pangu_transition_wm(int dtype, const void* skip, const void* dec,
                                   const void* bias, const void* m_s,
                                   const void* m_sh, const void* m_u,
                                   const void* m_uh, const void* m_uz,
                                   const void* m_uzh, void* out, int B, int nz,
                                   int nlat, int nlon, int n, int C, int wz,
                                   int wh, int ww, int h_real, int off_z,
                                   int off_lat, int off_lon, int z0,
                                   int nz_global, void* stream) {
  WmShape s = {nz, nlat, nlon, n, wz, wh, ww};
  const void* mats[6] = {m_s, m_sh, m_u, m_uh, m_uz, m_uzh};
  cudaStream_t st = (cudaStream_t)stream;
  if (z0 < 0 || z0 + nz > nz_global) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return transition_wm<float>(skip, dec, bias, mats, out, B, s, C, h_real, off_z,
                                off_lat, off_lon, z0, nz_global, st);
  // bf16: the tensor-core tiles
  if (dtype != 1 || C % 8 ||
      !aligned16_all({skip, dec, bias, m_s, m_sh, m_u, m_uh, m_uz, m_uzh, out}))
    return (int)cudaErrorInvalidValue;
  return transition_wm_bf16((const bf16*)skip, (const bf16*)dec,
                            (const bf16*)bias, mats, (bf16*)out, B, s, C, h_real,
                            off_z, off_lat, off_lon, z0, nz_global, st);
}
