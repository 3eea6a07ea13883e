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
// wrote the surface plane and zeros there.  Each split of rows keeps its
// own float32 partial and a second pass adds them in split order, so the
// result is the same in every run, as the TPU kernel's serial accumulation
// over its grid is.
//
// What bounds it on an H100: memory traffic.  At full width (bf16) it reads
// the 135 MB normalised field, the 27 MB const_h and 175 MB of the 206 MB
// cotangent for 3.4e10 FLOP (456,120 upper tokens x 193 x 192 x 2), ~100
// FLOP a byte, under the card's ~295.
//
// bf16 (the perf config) takes the gathers out of the product, as the
// recovery backward does (recovery_bwd.cu):
//   a. relayout: one bytes-bound pass writes the patch matrix A (rows, KA)
//      in the cotangent's wm row order, over every stage-0 storage row: an
//      upper token's row holds its K = (V+1)*32 patch values, then an
//      indicator 1, then zeros to KA = K + 8 (16-byte rows); plane 0's rows
//      and the token-lat pad rows are all zeros, indicator included.  A
//      block stages 32 tokens of one canonical lon line in shared memory:
//      lanes on neighbouring tokens read the field 8 bytes (a token's 4 wo
//      values) each, two latitudes an item, and the rows go out 16 bytes a
//      lane;
//   b. one transposed-A weight-gradient product of mma_gemm.cuh over every
//      storage row, dxs read in place as the dense (rows, C) B operand (no
//      copy of the cotangent, no row table), in deterministic splits (at
//      least WG_SPLIT_ROWS rows, as many as fill whole waves of the card:
//      dw_chunk): [dK; db] = A[:, :K+1]^T dxs.  The indicator
//      column stands where mma_wgrad's row of ones would, so db sums the
//      upper tokens only: a row of ones would add plane 0's cotangent and
//      the pad rows' into db.  Rows outside the upper planes add exact
//      zeros as long as dxs is finite there;
//   c. split_sum in split order; the last row of the result is db.
// The route takes C a multiple of 8, a longitude count that is a multiple
// of 4 and 16-byte aligned operands (the wrapper checks).  float32 (the
// parity config) keeps the first version: grad_gemm.cuh's wgrad with the
// patch gather and the row map in the operand functors, bit for bit.
#include <algorithm>

#include "mma_gemm.cuh"

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

// the float32 route (the first version; bf16 runs embed_dw_bf16 below)
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

// ---- the bf16 route -------------------------------------------------------

constexpr int DW_TOK = 32;  // tokens of a relayout block

// the field, const_h and the storage the relayout reads and writes
struct PatchShape {
  WmShape s;
  int V, levels, lat, lon, HT;
  __host__ __device__ int k() const { return (V + 1) * EPZ * EPH * EPW; }
  __host__ __device__ int ka() const { return k() + 8; }  // A's row
};

// a. A's rows of 32 storage tokens (b, z, h, w = 32 blockIdx.y + j):
// blockIdx.x = (b * Z + z) * HP + h.  Item (column group c of 8 features
// (v, zo, ho | ho + 1, wo), token j): two 8-byte reads, latitudes la and
// la + 1 at longitudes 4w .. 4w + 3, lanes on neighbouring tokens; then
// each row is written 16 bytes a lane, the indicator in the group after
// the patch.  A's row stride in shared memory, KA = 8 (mod 16) values, puts
// a quarter-warp's eight 16-byte stores on distinct banks.
static __global__ void __launch_bounds__(256)
patch_rows_kernel(const bf16* __restrict__ up, const bf16* __restrict__ ch,
                  bf16* __restrict__ a, PatchShape ps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* tile = reinterpret_cast<bf16*>(smem_raw);
  __shared__ long long dst[DW_TOK];
  const WmShape& s = ps.s;
  const int Z = s.nz * s.wz, HP = s.nlat * s.wh, WT = s.nlon * s.ww;
  const int ka = ps.ka(), nk = ps.k() / 8, nch = ka / 8;
  const int h = blockIdx.x % HP, z = (blockIdx.x / HP) % Z;
  const int b = blockIdx.x / (HP * Z);
  const int w0 = blockIdx.y * DW_TOK;
  const bool upper = z > 0 && h < ps.HT;  // else: rows of zeros
  if (threadIdx.x < DW_TOK && w0 + threadIdx.x < WT)
    dst[threadIdx.x] = wm_row(b, z, h, w0 + threadIdx.x, s) * ka;
  if (upper) {
    const long long vol = (long long)ps.levels * ps.lat * ps.lon;
    for (int idx = threadIdx.x; idx < nk * DW_TOK; idx += blockDim.x) {
      const int c = idx / DW_TOK, j = idx % DW_TOK;
      if (w0 + j >= WT) continue;
      const int f0 = 8 * c, v = f0 / (EPZ * EPH * EPW);
      const int lev = EPZ * (z - 1) + (f0 / (EPH * EPW)) % EPZ;
      const int la = EPH * h + (f0 / EPW) % EPH;
      uint2 lo = make_uint2(0u, 0u), hi = make_uint2(0u, 0u);
      if (lev < ps.levels) {
        const bf16* plane =
            v < ps.V ? up + ((long long)b * ps.V + v) * vol : ch;
        const bf16* p =
            plane + ((long long)lev * ps.lat + la) * ps.lon + EPW * (w0 + j);
        if (la < ps.lat) lo = *reinterpret_cast<const uint2*>(p);
        if (la + 1 < ps.lat) hi = *reinterpret_cast<const uint2*>(p + ps.lon);
      }
      *reinterpret_cast<uint4*>(tile + j * ka + f0) =
          make_uint4(lo.x, lo.y, hi.x, hi.y);
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nch * DW_TOK; idx += blockDim.x) {
    const int j = idx / nch, c = idx % nch;
    if (w0 + j >= WT) continue;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (upper && c < nk)
      v = *reinterpret_cast<const uint4*>(tile + j * ka + 8 * c);
    else if (upper)
      v.x = 0x3F80u;  // the indicator: bf16 1.0, then 7 zeros
    *reinterpret_cast<uint4*>(a + dst[j] + 8 * c) = v;
  }
}

inline long long patch_rows_count(int B, const WmShape& s) {
  return (long long)B * s.nz * s.nlat * s.nlon * s.n;
}

inline int patch_rows(const bf16* up, const bf16* ch, bf16* a, int B,
                      const PatchShape& ps, cudaStream_t st) {
  const WmShape& s = ps.s;
  const long long lines = (long long)B * s.nz * s.wz * s.nlat * s.wh;
  const int chunks = (s.nlon * s.ww + DW_TOK - 1) / DW_TOK;
  const size_t smem = (size_t)DW_TOK * ps.ka() * sizeof(bf16);
  cudaError_t e = cudaFuncSetAttribute(
      patch_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  patch_rows_kernel<<<dim3((unsigned)lines, chunks), 256, smem, st>>>(
      up, ch, a, ps);
  return (int)cudaGetLastError();
}

// the route's workspace, in float32 elements: the split partials, then A
// (rows x KA bf16)
inline long long patch_ws_floats(int B, const PatchShape& ps, int C) {
  const long long rows = patch_rows_count(B, ps.s);
  return (long long)wg_splits(rows) * (ps.k() + 1) * C +
         (rows * ps.ka() + 1) / 2;
}

// The product's row chunk: the fewest splits of at least WG_SPLIT_ROWS
// rows that fill whole waves of the card's CTA slots (its SMs x the
// product's CTAs a SM; a split takes ``tiles`` CTAs), so that no wave runs
// part-empty -- at full width 99 splits of 5,440 rows on an H100's 132 x 3
// slots, where 131 splits of 4,096 took a wave and a third.  At most
// wg_splits(rows) splits, as the workspace holds.
static cudaError_t dw_chunk(long long rows, int tiles, long long* kchunk,
                            int* splits) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mma_gemm_kernel<true, false, SplitStore>, 32 * MG_WARPS,
        mg_smem<true, false>());
  if (e != cudaSuccess) return e;
  const long long most = wg_splits(rows);
  const long long per_wave = std::max(1LL, (long long)sms * per_sm / tiles);
  const long long want =
      std::min(most, std::max(1LL, most / per_wave) * per_wave);
  *kchunk = ((rows + want - 1) / want + MG_BK - 1) / MG_BK * MG_BK;
  *splits = (int)((rows + *kchunk - 1) / *kchunk);
  return cudaSuccess;
}

static int embed_dw_bf16(const bf16* dxs, const bf16* up, const bf16* ch,
                         float* ws, float* out, int B, const PatchShape& ps,
                         int C, cudaStream_t st) {
  const long long rows = patch_rows_count(B, ps.s);
  const int k = ps.k();
  float* part = ws;
  bf16* a = reinterpret_cast<bf16*>(part + (long long)wg_splits(rows) *
                                                   (k + 1) * C);
  long long kchunk = 0;
  int splits = 0;
  cudaError_t r = dw_chunk(
      rows, ((k + 1 + MG_BM - 1) / MG_BM) * ((C + MG_BN - 1) / MG_BN),
      &kchunk, &splits);
  if (r != cudaSuccess) return (int)r;
  int e = patch_rows(up, ch, a, B, ps, st);
  if (e) return e;
  // [dK; db] = A[:, :K+1]^T dxs: the patch columns, then the indicator
  // (ones = 0: no constant row of ones, which would count every row)
  r = mma_gemm_launch<true, false>(a, ps.ka(), ps.ka(), 0, dxs, C, k + 1, C,
                                   rows, kchunk, splits,
                                   SplitStore{part, k + 1, C}, st);
  if (r != cudaSuccess) return (int)r;
  split_sum(part, out, (long long)(k + 1) * C, splits, st);
  return (int)cudaGetLastError();
}

}  // namespace pangu

using namespace pangu;

// float32 elements of the workspace the entry below needs: the bf16
// route's split partials and A, whose partials alone hold the float32
// route's (those run over the upper tokens, a subset of the storage rows)
extern "C" long long pangu_embed_dw_ws(int B, int nz, int nlat, int nlon,
                                       int n, int wz, int wh, int ww, int C,
                                       int HT, int V) {
  const PatchShape ps = {{nz, nlat, nlon, n, wz, wh, ww}, V, 0, 0, 0, HT};
  return patch_ws_floats(B, ps, C);
}

// dtype: 0 = float32, 1 = bfloat16.  out: float32 ((V+1)*32 + 1, C), the
// kernel gradient in ONNX row order and, last, the bias gradient.  Returns a
// cudaError_t (0 = ok; cudaErrorInvalidValue for a bf16 C that is not a
// multiple of 8, a longitude count that is not a multiple of 4, or an
// operand off a 16-byte boundary).
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
  // bf16: the relayout's 4-longitude groups and the tensor-core tiles
  if (dtype != 1 || C % 8 || lon % EPW ||
      !aligned16_all({dxs, up, ch, part}))
    return (int)cudaErrorInvalidValue;
  const PatchShape ps = {s, V, levels, lat, lon, HT};
  return embed_dw_bf16((const bf16*)dxs, (const bf16*)up, (const bf16*)ch,
                       (float*)part, (float*)out, B, ps, C, st);
}
