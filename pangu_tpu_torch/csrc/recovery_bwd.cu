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
//   1. token cotangents, pad rows included (they get zeros), each written to
//      its storage row t - off (the inverse of the forward's modular read):
//        d_skip[t - off] = round_T(dF @ K[:C]^T),  d_dec = round_T(dF @ K[C:]^T)
//   2. the heads' gradients, float32 (the bias a row of ones):
//        dK[c, f] = sum_t [skip | dec][t - off][c] * dF[t][f],  db[f] = sum_t dF[t][f]
//      each split of rows keeps its own partial and a second pass adds them
//      in order, so the sums are the same in every run (no atomics).
//
// The TPU kernel walks storage blocks and runs the lon interleave as a
// transposed selection matmul.
//
// What bounds it on an H100: memory traffic.  At full width (bf16) it reads
// the field cotangents (143 MB) and the pair (412 MB), and writes the pair's
// cotangents (412 MB), for about 1.5e11 FLOP.
//
// bf16 (the perf config) takes the gathers out of the products:
//   a. relayout: one bytes-bound pass writes the feature cotangents in the
//      pair's storage-row order as a dense (rows, Fu + Fs) matrix dF_wm (the
//      upper head's V*32 columns, then the surface head's S*16; a row is
//      zero in the head its token does not belong to, and on pad rows).  A
//      block stages 32 tokens of one storage lon line in shared memory:
//      lanes on neighbouring tokens read dU / dS 8 bytes (4 longitudes) each
//      along longitude, and the rows go out 16 bytes a lane;
//   b. token cotangents: d_skip | d_dec = dF_wm [Ku | Ks]^T, one mma_gemm.cuh
//      product over every storage row (the pair's order is the output's, so
//      no row map), its epilogue splitting the columns between the outputs;
//   c. weight gradients: mma_gemm.cuh's transposed-A product of skip and of
//      dec (the bias row with dec) against dF_wm over every storage row, in
//      deterministic splits of WG_SPLIT_ROWS rows, then a sum in split order
//      that writes the two heads' columns to dKu and dKs.
// Rows outside a head (the other plane, pad rows) add exact zeros: their dF
// is 0 and every caller's pair is finite there (the trunk's pad rows are
// LayerNorm outputs of zero-synthesised rows), so 0 x pair = 0.  The route
// takes C a multiple of 8 and 16-byte aligned operands (the wrapper checks).
// float32 (the parity config) keeps the first version: grad_gemm.cuh's
// xgemm / wgrad with the gathers in the operand functors, bit for bit.
#include "edge_gemm.cuh"
#include "mma_gemm.cuh"

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

// ---- the bf16 route -------------------------------------------------------

constexpr int RL_TOK = 32;  // tokens of a relayout block

// storage rows and feature columns of the bf16 route's dF_wm
struct CotShape {
  WmShape s;
  int HT, V, S, levels, lat, lon, oz, olat, olon;
  __host__ __device__ int fu() const { return V * RPZ * RPH * RPW; }
  __host__ __device__ int f() const { return fu() + S * RPH * RPW; }
};

// a. dF_wm of 32 storage tokens (b, z_s, lat_s, lon_s = 32 blockIdx.y + j):
// blockIdx.x = (b * Z + z_s) * HP + lat_s.  Item (column group ch of 8
// features, token j): two 8-byte reads, latitudes la and la + 1 at
// longitudes 4w .. 4w + 3, lanes on neighbouring tokens; then each row is
// written 16 bytes a lane.
static __global__ void __launch_bounds__(256)
field_cot_wm_kernel(const bf16* __restrict__ du, const bf16* __restrict__ ds,
                    bf16* __restrict__ out, CotShape cs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* tile = reinterpret_cast<bf16*>(smem_raw);
  const WmShape& s = cs.s;
  const int Z = s.nz * s.wz, HP = s.nlat * s.wh, WT = s.nlon * s.ww;
  const int F = cs.f(), ld = F + 8, nch = F / 8, nchu = cs.fu() / 8;
  const int lat_s = blockIdx.x % HP, z_s = (blockIdx.x / HP) % Z;
  const int b = blockIdx.x / (HP * Z);
  const int w0 = blockIdx.y * RL_TOK;
  const int z = pmod(z_s + cs.oz, Z), h = pmod(lat_s + cs.olat, HP);
  for (int idx = threadIdx.x; idx < nch * RL_TOK; idx += blockDim.x) {
    const int ch = idx / RL_TOK, j = idx % RL_TOK;
    if (w0 + j >= WT) continue;
    const int w = pmod(w0 + j + cs.olon, WT);
    const bf16* plane = nullptr;  // null: the group reads zeros
    int la = 0;
    if (h < cs.HT && ch < nchu && z > 0) {
      const int f0 = 8 * ch, lev = RPZ * (z - 1) + (f0 / (RPH * RPW)) % RPZ;
      la = RPH * h + (f0 / RPW) % RPH;
      if (lev < cs.levels)
        plane = du + (((long long)b * cs.V + f0 / (RPZ * RPH * RPW)) *
                          cs.levels + lev) * cs.lat * cs.lon;
    } else if (h < cs.HT && ch >= nchu && z == 0) {
      const int f0 = 8 * (ch - nchu);
      la = RPH * h + (f0 / RPW) % RPH;
      plane = ds + ((long long)b * cs.S + f0 / (RPH * RPW)) * cs.lat * cs.lon;
    }
    uint2 lo = make_uint2(0u, 0u), hi = make_uint2(0u, 0u);
    if (plane) {
      const bf16* p = plane + (long long)la * cs.lon + RPW * w;
      if (la < cs.lat) lo = *reinterpret_cast<const uint2*>(p);
      if (la + 1 < cs.lat) hi = *reinterpret_cast<const uint2*>(p + cs.lon);
    }
    *reinterpret_cast<uint4*>(tile + j * ld + 8 * ch) =
        make_uint4(lo.x, lo.y, hi.x, hi.y);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nch * RL_TOK; idx += blockDim.x) {
    const int j = idx / nch, ch = idx % nch;
    if (w0 + j >= WT) continue;
    const long long row = wm_row(b, z_s, lat_s, w0 + j, s);
    *reinterpret_cast<uint4*>(out + row * F + 8 * ch) =
        *reinterpret_cast<const uint4*>(tile + j * ld + 8 * ch);
  }
}

inline int field_cot_wm(const bf16* du, const bf16* ds, bf16* out, int B,
                        const CotShape& cs, cudaStream_t st) {
  const WmShape& s = cs.s;
  const long long lines = (long long)B * s.nz * s.wz * s.nlat * s.wh;
  const int chunks = (s.nlon * s.ww + RL_TOK - 1) / RL_TOK;
  const size_t smem = (size_t)RL_TOK * (cs.f() + 8) * sizeof(bf16);
  cudaError_t e = cudaFuncSetAttribute(
      field_cot_wm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  field_cot_wm_kernel<<<dim3((unsigned)lines, chunks), 256, smem, st>>>(
      du, ds, out, cs);
  return (int)cudaGetLastError();
}

// [Ku | Ks] (2C, Fu + Fs): the B operand of the token-cotangent product
static __global__ void concat_heads_kernel(const bf16* __restrict__ ku,
                                           const bf16* __restrict__ ks,
                                           bf16* __restrict__ k, int rows,
                                           int fu, int fs) {
  const int f = fu + fs;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)rows * f) return;
  const int r = (int)(i / f), c = (int)(i % f);
  k[i] = c < fu ? ku[(long long)r * fu + c] : ks[(long long)r * fs + c - fu];
}

// b's epilogue: columns < C to d_skip, the rest to d_dec, the same row
struct PairSplitEpi {
  bf16* dskip;
  bf16* ddec;
  int C;
  __device__ void operator()(int, long long r, int c,
                             const float (&v)[8]) const {
    if (c < C)
      st8(dskip + r * C + c, v);
    else
      st8(ddec + r * C + c - C, v);
  }
};

// c's sum of the split partials (splits x (2C + 1) x F) in split order,
// the upper head's columns to dku, the surface head's to dks
static __global__ void head_sum_kernel(const float* __restrict__ part,
                                       float* __restrict__ dku,
                                       float* __restrict__ dks, int rows,
                                       int fu, int fs, int splits) {
  const int f = fu + fs;
  const long long size = (long long)rows * f;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  float acc = 0.f;
  for (int z = 0; z < splits; ++z) acc += part[(long long)z * size + i];
  const int r = (int)(i / f), c = (int)(i % f);
  if (c < fu)
    dku[(long long)r * fu + c] = acc;
  else
    dks[(long long)r * fs + c - fu] = acc;
}

inline long long cot_rows(int B, const WmShape& s) {
  return (long long)B * s.nz * s.nlat * s.nlon * s.n;
}

// the route's workspace, in float32 elements: the split partials, then
// dF_wm (rows x F bf16), then [Ku | Ks] (2C x F bf16)
inline long long cot_ws_floats(int B, const CotShape& cs, int C) {
  const long long rows = cot_rows(B, cs.s);
  return (long long)wg_splits(rows) * (2 * C + 1) * cs.f() +
         (rows * cs.f() + 2LL * C * cs.f() + 1) / 2;
}

static int recovery_bwd_bf16(const bf16* du, const bf16* ds, const bf16* skip,
                             const bf16* dec, const bf16* ku, const bf16* ks,
                             bf16* dskip, bf16* ddec, float* ws, float* dku,
                             float* dks, int B, const CotShape& cs, int C,
                             cudaStream_t st) {
  const long long rows = cot_rows(B, cs.s);
  const int F = cs.f(), fu = cs.fu(), splits = wg_splits(rows);
  float* part = ws;
  bf16* dF =
      reinterpret_cast<bf16*>(part + (long long)splits * (2 * C + 1) * F);
  bf16* kcat = dF + rows * F;
  int e = field_cot_wm(du, ds, dF, B, cs, st);
  if (e) return e;
  concat_heads_kernel<<<(2 * C * F + 255) / 256, 256, 0, st>>>(
      ku, ks, kcat, 2 * C, fu, F - fu);
  PANGU_CHECK_LAUNCH();
  cudaError_t r = mma_gemm<true>(dF, kcat, rows, 2 * C, F,
                                 PairSplitEpi{dskip, ddec, C}, st);
  if (r != cudaSuccess) return (int)r;
  r = mma_gemm_launch<true, false>(skip, C, C, 0, dF, F, C, F, rows,
                                   WG_SPLIT_ROWS, splits,
                                   SplitStore{part, 2 * C + 1, F}, st);
  if (r != cudaSuccess) return (int)r;
  r = mma_gemm_launch<true, false>(dec, C, C, 1, dF, F, C + 1, F, rows,
                                   WG_SPLIT_ROWS, splits,
                                   SplitStore{part + (long long)C * F,
                                              2 * C + 1, F}, st);
  if (r != cudaSuccess) return (int)r;
  const long long size = (long long)(2 * C + 1) * F;
  head_sum_kernel<<<(unsigned)((size + 255) / 256), 256, 0, st>>>(
      part, dku, dks, 2 * C + 1, fu, F - fu, splits);
  return (int)cudaGetLastError();
}

// ---- float32: the first version -------------------------------------------

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

// float32 elements of the workspace the entry below needs: float32, the
// upper head's split partials (the surface head's fit in them); bf16, the
// route's partials, dF_wm and [Ku | Ks] (cot_ws_floats)
extern "C" long long pangu_recovery_bwd_ws(int dtype, int B, int nz, int nlat,
                                           int nlon, int n, int wz, int wh,
                                           int ww, int HT, int C, int V,
                                           int S) {
  if (dtype == 1) {
    const CotShape cs = {{nz, nlat, nlon, n, wz, wh, ww}, HT, V, S};
    return cot_ws_floats(B, cs, C);
  }
  const HeadTokens real = {0, nz * wz - 1, HT, nlon * ww};
  return (long long)wg_splits(head_rows(B, real)) * (2 * C + 1) *
         (V * RPZ * RPH * RPW);
}

// The bf16 route's relayout (step a) alone: out (B, nz, nlat, nlon, N,
// V*32 + S*16) = dF_wm.  Returns a cudaError_t (0 = ok).
extern "C" int pangu_recovery_cot_wm(const void* du, const void* ds, void* out,
                                     int B, int nz, int nlat, int nlon, int n,
                                     int wz, int wh, int ww, int HT, int V,
                                     int S, int levels, int lat, int lon,
                                     int off_z, int off_lat, int off_lon,
                                     void* stream) {
  const CotShape cs = {{nz, nlat, nlon, n, wz, wh, ww}, HT, V, S, levels,
                       lat, lon, off_z, off_lat, off_lon};
  if (lon % RPW || !aligned16_all({du, ds, out}))
    return (int)cudaErrorInvalidValue;
  return field_cot_wm((const bf16*)du, (const bf16*)ds, (bf16*)out, B, cs,
                      (cudaStream_t)stream);
}

// dtype: 0 = float32, 1 = bfloat16.  Outputs: d_skip, d_dec (the pair's
// storage, rolled by off like the pair), float32 dku (2C+1, V*32) and
// dks (2C+1, S*16), the last row the bias gradient.  ``workspace``:
// pangu_recovery_bwd_ws float32 elements.  Returns a cudaError_t (0 = ok).
extern "C" int pangu_recovery_bwd(
    int dtype, const void* du, const void* ds, const void* skip,
    const void* dec, const void* ku, const void* ks, void* dskip, void* ddec,
    void* workspace, void* dku, void* dks, int B, int nz, int nlat, int nlon,
    int n, int C, int wz, int wh, int ww, int HT, int V, int S, int levels,
    int lat, int lon, int off_z, int off_lat, int off_lon, void* stream) {
  WmShape s = {nz, nlat, nlon, n, wz, wh, ww};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return recovery_bwd<float>(
        (const float*)du, (const float*)ds, (const float*)skip,
        (const float*)dec, (const float*)ku, (const float*)ks, (float*)dskip,
        (float*)ddec, (float*)workspace, (float*)dku, (float*)dks, B, s, C, HT,
        V, S, levels, lat, lon, off_z, off_lat, off_lon, st);
  // bf16: the tensor-core tiles take 8-column groups and 16-byte aligned
  // operands, the relayout 4-longitude groups
  if (dtype != 1 || C % 8 || lon % RPW ||
      !aligned16_all({du, ds, skip, dec, dskip, ddec, workspace}))
    return (int)cudaErrorInvalidValue;
  const CotShape cs = {s, HT, V, S, levels, lat, lon, off_z, off_lat, off_lon};
  return recovery_bwd_bf16((const bf16*)du, (const bf16*)ds,
                           (const bf16*)skip, (const bf16*)dec,
                           (const bf16*)ku, (const bf16*)ks, (bf16*)dskip,
                           (bf16*)ddec, (float*)workspace, (float*)dku,
                           (float*)dks, B, cs, C, st);
}
