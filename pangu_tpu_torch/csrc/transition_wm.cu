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
// Latitude-pad rows (lat >= h) are written as zeros by select.  The TPU
// kernel runs the interior matrix everywhere and corrects the edge rows with
// a second product (its rounding differs by a bf16 ulp on those rows); here
// one group is one (batch, plane, lat row), so its matrix is chosen once and
// the rounding is the plain version's (engine/transition_wm.py).
//
// What bounds it on an H100: memory traffic.  At full width (bf16) it reads
// the skip/decoder pair and the bias field (3 x 206 MB) and writes 206 MB for
// 7.9e10 FLOP, a few FLOP per byte against the ~295 at which the tensor cores
// would bind.  This first version re-reads each gathered row once per
// 64-column output tile (from L2) and loads element by element.
#include "edge_gemm.cuh"

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
  int K, N, M;

  __device__ bool active(int g) const { return g % Hp < h_real; }
  __device__ const T* mat(int g) const {
    const int lat = g % Hp, z = (g / Hp) % Z;
    const int kind = z == 0 ? 0 : (z == Z - 1 ? 4 : 2);
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
                  int h_real, int oz, int olat, int olon, cudaStream_t st) {
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
  op.K = 2 * C;
  op.N = C;
  op.M = s.nlon * s.ww;
  edge_gemm(op, B * op.Z * op.Hp, (T*)nullptr, st);
  PANGU_CHECK_LAUNCH();
  return 0;
}

}  // namespace pangu

using namespace pangu;

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = ok).
extern "C" int pangu_transition_wm(int dtype, const void* skip, const void* dec,
                                   const void* bias, const void* m_s,
                                   const void* m_sh, const void* m_u,
                                   const void* m_uh, const void* m_uz,
                                   const void* m_uzh, void* out, int B, int nz,
                                   int nlat, int nlon, int n, int C, int wz,
                                   int wh, int ww, int h_real, int off_z,
                                   int off_lat, int off_lon, void* stream) {
  WmShape s = {nz, nlat, nlon, n, wz, wh, ww};
  const void* mats[6] = {m_s, m_sh, m_u, m_uh, m_uz, m_uzh};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return transition_wm<float>(skip, dec, bias, mats, out, B, s, C, h_real, off_z,
                                off_lat, off_lon, st);
  if (dtype == 1)
    return transition_wm<bf16>(skip, dec, bias, mats, out, B, s, C, h_real, off_z,
                               off_lat, off_lon, st);
  return (int)cudaErrorInvalidValue;
}
