// Tensor-core building blocks of the attention kernels: mma.sync m16n8k16
// bf16 products with float32 accumulators, their fragments in registers and
// shared memory, the row softmax of a C fragment, and the cp.async tile
// loads with the padding the products need.
//
// Fragments (lane = 4 g + t: g = lane / 4 the row in an 8-row group, t =
// lane % 4), as the PTX ISA lays out mma.m16n8k16 with .bf16 inputs:
//   A, 16 x 16 (rows m, cols k), four registers of two bf16 each:
//     a[0] (g, 2t..2t+1)  a[1] (g+8, 2t..)  a[2] (g, 2t+8..)  a[3] (g+8, 2t+8..)
//   B, 16 x 8 (rows k, cols n), two registers:
//     b[0] (2t..2t+1, g)  b[1] (2t+8..2t+9, g)
//   C, 16 x 8 float32, four values:
//     c[0], c[1] (g, 2t..2t+1)   c[2], c[3] (g+8, 2t..2t+1)
// A row of a C tile lives in the four lanes of one quad (one g), so a row
// reduction is two shuffles.  Two C tiles side by side (n 0-7 and 8-15),
// rounded to bf16, are one A fragment of the next product with k over those
// 16 columns (c_to_a): P or dS go from one product into the next without
// shared memory.
//
// Shared tiles are bf16, row-major with a row stride `ld` (elements) whose
// byte size is an odd multiple of 16 (ld = 16 k + 8): the eight 16-byte rows
// of an ldmatrix phase then fall in distinct banks, and so do the 32-bit
// stores of a C tile's bf16 pairs.  Every operand is read with ldmatrix,
// `.trans` where the tile is stored with the product's k along its rows.
//
// Padding: a head dim hd enters a product as k (padded to 16) or n (padded
// to 8, then 16), and N tokens as rows or k (padded to 16).  The tiles are
// zeroed once (zero_smem) and the loads write only the real rows and
// columns, so every pad holds 0; a pad key column enters the logits at
// -inf (the bias initialiser of the caller), so its probability is 0.
#pragma once

#include "common.cuh"

namespace pangu {

__host__ __device__ constexpr int pad16(int n) { return (n + 15) / 16 * 16; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- fragments from shared memory ------------------------------------------

// A[m][k] = s[m * ld + k], m in [m0, m0+16), k in [k0, k0+16): a row-major
// tile (dS read by its query rows)
__device__ __forceinline__ void load_a_n(uint32_t (&a)[4], const bf16* s,
                                         int ld, int k0, int m0) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, r = lane & 7;
  const bf16* p = s + (m0 + r + (mi & 1) * 8) * ld + k0 + (mi >> 1) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_u32(p)));
}

// A[m][k] = s[k * ld + m], m in [m0, m0+16), k in [k0, k0+16): a tile stored
// with k along its rows (q^T and dO^T as (hd, N); dS and P read as their
// transposes)
__device__ __forceinline__ void load_a_t(uint32_t (&a)[4], const bf16* s,
                                         int ld, int k0, int m0) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, r = lane & 7;
  const bf16* p = s + (k0 + r + (mi >> 1) * 8) * ld + m0 + (mi & 1) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_u32(p)));
}

// B[k][n] = s[k * ld + n] for two n tiles, b[0] n in [n0, n0+8), b[1] in
// [n0+8, n0+16), k in [k0, k0+16): k along the rows (K^T, V^T as (hd, N))
__device__ __forceinline__ void load_b_t(uint32_t (&b)[2][2], const bf16* s,
                                         int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, r = lane & 7;
  const bf16* p = s + (k0 + r + (mi & 1) * 8) * ld + n0 + (mi >> 1) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(b[0][0]), "=r"(b[0][1]), "=r"(b[1][0]), "=r"(b[1][1])
      : "r"(smem_u32(p)));
}

// B[k][n] = s[n * ld + k] for two n tiles: n along the rows (V, K, q, dO as
// (hd, N) with k over tokens)
__device__ __forceinline__ void load_b_n(uint32_t (&b)[2][2], const bf16* s,
                                         int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, r = lane & 7;
  const bf16* p = s + (n0 + r + (mi >> 1) * 8) * ld + k0 + (mi & 1) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(b[0][0]), "=r"(b[0][1]), "=r"(b[1][0]), "=r"(b[1][1])
      : "r"(smem_u32(p)));
}

// ---- the product and fragment arithmetic -------------------------------------

// c += a b, bf16 inputs, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two floats rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// every element of an A fragment times s, rounded to bf16 (the product of
// two bf16 values is exact in float32, so this is the rounded bf16 product)
__device__ __forceinline__ void scale_a(uint32_t (&a)[4], float s) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float2 f = unpack_bf16(a[r]);
    a[r] = pack_bf16(f.x * s, f.y * s);
  }
}

// the A fragment (k over 16 columns) of two C tiles side by side, rounded
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// 2^x by the MUFU unit (subnormal results flushed to zero; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

constexpr float kLog2e = 1.4426950408889634f;

// the maxima of the 16 rows of C tiles s[0 .. live), times log2 e, folded
// into ml0 (row g) and ml1 (row g + 8), by quad shuffles
template <int NT>
__device__ __forceinline__ void row_max(const float (&s)[NT][4], int live,
                                        float& ml0, float& ml1) {
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    if (nt < live) {
      m0 = fmaxf(m0, fmaxf(s[nt][0], s[nt][1]));
      m1 = fmaxf(m1, fmaxf(s[nt][2], s[nt][3]));
    }
  ml0 = fmaxf(ml0, quad_max(m0) * kLog2e);
  ml1 = fmaxf(ml1, quad_max(m1) * kLog2e);
}

// s = exp(s - max) in place, as 2^(s log2 e - ml) by ex2; the thread's part
// of each row's sum added into l0, l1
template <int NT>
__device__ __forceinline__ void row_exp(float (&s)[NT][4], int live, float ml0,
                                        float ml1, float& l0, float& l1) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    if (nt < live) {
      s[nt][0] = ex2(fmaf(s[nt][0], kLog2e, -ml0));
      s[nt][1] = ex2(fmaf(s[nt][1], kLog2e, -ml0));
      s[nt][2] = ex2(fmaf(s[nt][2], kLog2e, -ml1));
      s[nt][3] = ex2(fmaf(s[nt][3], kLog2e, -ml1));
      l0 += s[nt][0] + s[nt][1];
      l1 += s[nt][2] + s[nt][3];
    }
}

template <int NT>
__device__ __forceinline__ void row_scale(float (&s)[NT][4], int live,
                                          float r0, float r1) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    if (nt < live) {
      s[nt][0] *= r0;
      s[nt][1] *= r0;
      s[nt][2] *= r1;
      s[nt][3] *= r1;
    }
}

// the float32 softmax of the 16 rows of C tiles s[0 .. live) in place: row
// max and sum by quad shuffles, exp(s - max) times one reciprocal of the
// row's sum (tiles past `live` are not touched)
template <int NT>
__device__ __forceinline__ void row_softmax(float (&s)[NT][4], int live) {
  float ml0 = -INFINITY, ml1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  row_max(s, live, ml0, ml1);
  row_exp(s, live, ml0, ml1, l0, l1);
  row_scale(s, live, 1.f / quad_sum(l0), 1.f / quad_sum(l1));
}

// ---- C tiles out --------------------------------------------------------------

// mul * c of C tiles (rows r0 + (g, g+8), cols 8 nt + 2t..) rounded to bf16
// and stored transposed, st[col * ld + row - r0 + c0], for col < ncol and
// local row < nrow
template <int NT>
__device__ __forceinline__ void stage_t(const float (&c)[NT][4], bf16* st,
                                        int ld, int c0, int ncol, int nrow,
                                        float mul) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = 8 * nt + 2 * t;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = g + (e >> 1) * 8, cc = col + (e & 1);
      if (cc < ncol && row < nrow)
        st[cc * ld + c0 + row] = __float2bfloat16(mul * c[nt][e]);
    }
  }
}

// a warp's 16 staged columns st[r * ld + c0 ..], rows r < rows, to dst (row
// stride N) columns [col0, col0 + 16) that are < N: 16-byte stores where vec
// (N % 8 == 0, 16-byte aligned), else element by element
__device__ __forceinline__ void store_cols(const bf16* st, int ld, int c0,
                                           bf16* __restrict__ dst, int col0,
                                           int rows, int N, bool vec) {
  const int lane = threadIdx.x & 31;
  if (vec) {
    for (int idx = lane; idx < rows * 2; idx += 32) {
      const int r = idx >> 1, k = (idx & 1) * 8;
      if (col0 + k < N)
        *reinterpret_cast<uint4*>(dst + (long long)r * N + col0 + k) =
            *reinterpret_cast<const uint4*>(st + r * ld + c0 + k);
    }
  } else {
    for (int idx = lane; idx < rows * 16; idx += 32) {
      const int r = idx >> 4, k = idx & 15;
      if (col0 + k < N) dst[(long long)r * N + col0 + k] = st[r * ld + c0 + k];
    }
  }
}

// ---- tile loads ------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// every 32-bit word of [p, p + bytes) set to 0 by the whole block
__device__ __forceinline__ void zero_smem(void* p, size_t bytes) {
  uint32_t* w = static_cast<uint32_t*>(p);
  for (size_t i = threadIdx.x; i < bytes / 4; i += blockDim.x) w[i] = 0u;
}

// rows x N bf16 (row stride N in global memory) into shared rows of stride
// ld, by the whole block: 16-byte cp.async copies where vec (N % 8 == 0,
// 16-byte aligned), else element by element (synchronous); the pad columns
// [N, ld) are not written
__device__ __forceinline__ void load_rows(bf16* dst, int ld,
                                          const bf16* __restrict__ src,
                                          int rows, int N, bool vec) {
  if (vec) {
    const int cpr = N / 8;
    for (int idx = threadIdx.x; idx < rows * cpr; idx += blockDim.x) {
      const int r = idx / cpr, c = (idx % cpr) * 8;
      cp_async16(dst + r * ld + c, src + (long long)r * N + c);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * N; idx += blockDim.x) {
      const int r = idx / N, c = idx % N;
      dst[r * ld + c] = src[(long long)r * N + c];
    }
  }
}

}  // namespace pangu
