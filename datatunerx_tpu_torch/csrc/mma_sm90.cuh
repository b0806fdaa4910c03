// The tensor-core skeleton the bf16 attention kernels share (flash K1-K3 in
// flash_attention.cu, paged K8 in paged_attention.cu): cp.async copies into
// shared memory, ldmatrix fragment loads, mma.sync.m16n8k16 (bf16 in, f32
// accumulate), and the packing of f32 C fragments into bf16 A fragments.
//
// Tiles live in shared memory as bf16 rows with a pitch of D + 8 elements:
// rows stay 16-byte aligned for 16-byte cp.async, and the 8 rows an ldmatrix
// phase reads fall into 8 distinct 16-byte bank groups.
//
// Fragments of mma.m16n8k16 follow the PTX layout (lane = 4 g + t): a C
// fragment c[4] holds rows g (c[0], c[1]) and g + 8 (c[2], c[3]) at columns
// 2t and 2t + 1 of its n8 tile.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace dtx_mma {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16, 8 or 4 bytes global -> shared, asynchronous; zero-filled if !ok
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp8(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The x4 loads give an A fragment (rows r0.., k c0..) of a [row][k] tile,
// or, with .trans, the B fragments of n tiles c0 and c0 + 8 (k rows r0..)
// of a [k][n] tile; the lane address pattern is the same.
__device__ __forceinline__ void ldsm_x4(const bf16* tile, int pitch, int r0,
                                        int c0, uint32_t* f) {
  const int lane = threadIdx.x & 31;
  const uint32_t a =
      smem_u32(tile + (r0 + (lane & 15)) * pitch + c0 + (lane >> 4) * 8);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(f[0]), "=r"(f[1]), "=r"(f[2]), "=r"(f[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(const bf16* tile, int pitch, int r0,
                                          int c0, uint32_t* f) {
  const int lane = threadIdx.x & 31;
  const uint32_t a =
      smem_u32(tile + (r0 + (lane & 15)) * pitch + c0 + (lane >> 4) * 8);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(f[0]), "=r"(f[1]), "=r"(f[2]), "=r"(f[3])
      : "r"(a));
}
// The B fragments of n tiles n0 and n0 + 8 (k columns k0..) of an [n][k]
// tile: f[0], f[1] for n0, f[2], f[3] for n0 + 8.
__device__ __forceinline__ void ldsm_b_x4(const bf16* tile, int pitch, int n0,
                                          int k0, uint32_t* f) {
  const int lane = threadIdx.x & 31;
  const uint32_t a = smem_u32(tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) *
                                         pitch +
                              k0 + ((lane >> 3) & 1) * 8);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(f[0]), "=r"(f[1]), "=r"(f[2]), "=r"(f[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The C fragments of n8 tiles 2kk and 2kk + 1 (16 rows x 16 columns) as
// the bf16 A fragment of k step kk.
__device__ __forceinline__ void c_to_a(const float (*c)[4], int kk,
                                       uint32_t* a) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// c_to_a's fragment split in two: hi = the bf16 rounding of each f32 value
// and lo = the bf16 rounding of what hi left (x - hi is exact in f32), so
// hi + lo carries 16 of the value's 24 significant bits. Two products into
// one f32 accumulator then take the operand at that precision (flash K3).
__device__ __forceinline__ void split_pack(float x0, float x1, uint32_t* hi,
                                           uint32_t* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  *hi = *reinterpret_cast<const uint32_t*>(&h);
  *lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}
__device__ __forceinline__ void c_to_a_split(const float (*c)[4], int kk,
                                             uint32_t* hi, uint32_t* lo) {
  split_pack(c[2 * kk][0], c[2 * kk][1], hi, lo);
  split_pack(c[2 * kk][2], c[2 * kk][3], hi + 1, lo + 1);
  split_pack(c[2 * kk + 1][0], c[2 * kk + 1][1], hi + 2, lo + 2);
  split_pack(c[2 * kk + 1][2], c[2 * kk + 1][3], hi + 3, lo + 3);
}

// The A fragments of 16 rows (r0..) x D of a [row][D + 8] tile, for every
// k step of a product over D: what a kernel holds in registers for the
// whole of its key loop.
template <int D>
__device__ __forceinline__ void load_a_rows(const bf16* tile, int r0,
                                            uint32_t (*a)[4]) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) ldsm_x4(tile, D + 8, r0, ks * 16, a[ks]);
}

// x[16, N] = A[16, D] @ tb[N][D]^T with A held as register fragments
// a[D/16] (the scores of 16 query rows against N staged key rows). Each k
// step loads its B fragments before its products, which then issue back to
// back.
template <int D, int N>
__device__ __forceinline__ void mma_scores_a(float (*x)[4],
                                             const uint32_t (*a)[4],
                                             const bf16* tb) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t fb[N / 16][4];
#pragma unroll
    for (int np = 0; np < N / 16; ++np)
      ldsm_b_x4(tb, D + 8, np * 16, ks * 16, fb[np]);
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      mma_bf16(x[2 * np], a[ks], fb[np][0], fb[np][1]);
      mma_bf16(x[2 * np + 1], a[ks], fb[np][2], fb[np][3]);
    }
  }
}

// acc[16 rows, D] += P[16, N] @ tile[N][D]: P from the f32 C fragments p,
// packed to a bf16 A fragment one k step at a time (P rounds to bf16 as the
// operand), the tile row-major [k][n] read through ldmatrix.trans.
template <int D, int N>
__device__ __forceinline__ void mma_pv(float (*acc)[4], const float (*p)[4],
                                       const bf16* tile) {
  constexpr int DC = D / 16 < 4 ? D / 16 : 4;  // 16-column pairs per batch
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    uint32_t pa[4];
    c_to_a(p, kk, pa);
#pragma unroll
    for (int d0 = 0; d0 < D / 16; d0 += DC) {
      uint32_t f[DC][4];
#pragma unroll
      for (int dn = 0; dn < DC; ++dn)
        ldsm_x4_t(tile, D + 8, kk * 16, (d0 + dn) * 16, f[dn]);
#pragma unroll
      for (int dn = 0; dn < DC; ++dn) {
        mma_bf16(acc[2 * (d0 + dn)], pa, f[dn][0], f[dn][1]);
        mma_bf16(acc[2 * (d0 + dn) + 1], pa, f[dn][2], f[dn][3]);
      }
    }
  }
}

// acc[16 rows, D] += A-fragments a[N/16] [16, N] @ tile[N][D] (row-major
// [k][n], read through ldmatrix.trans), for one (acc, a, tile) set or two
// interleaved (flash K2, K3). Each k step loads its B fragments (up to 64
// columns of d at a time) before its products, which then issue back to
// back.
template <int D, int N, int SETS>
__device__ __forceinline__ void mma_rows_t(float (*acc0)[4],
                                           const uint32_t (*a0)[4],
                                           const bf16* tile0,
                                           float (*acc1)[4],
                                           const uint32_t (*a1)[4],
                                           const bf16* tile1) {
  constexpr int DC = D / 16 < 4 ? D / 16 : 4;  // 16-column pairs per batch
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int d0 = 0; d0 < D / 16; d0 += DC) {
      uint32_t f0[DC][4], f1[DC][4];
#pragma unroll
      for (int dn = 0; dn < DC; ++dn) {
        ldsm_x4_t(tile0, D + 8, kk * 16, (d0 + dn) * 16, f0[dn]);
        if constexpr (SETS == 2)
          ldsm_x4_t(tile1, D + 8, kk * 16, (d0 + dn) * 16, f1[dn]);
      }
#pragma unroll
      for (int dn = 0; dn < DC; ++dn) {
        mma_bf16(acc0[2 * (d0 + dn)], a0[kk], f0[dn][0], f0[dn][1]);
        mma_bf16(acc0[2 * (d0 + dn) + 1], a0[kk], f0[dn][2], f0[dn][3]);
        if constexpr (SETS == 2) {
          mma_bf16(acc1[2 * (d0 + dn)], a1[kk], f1[dn][0], f1[dn][1]);
          mma_bf16(acc1[2 * (d0 + dn) + 1], a1[kk], f1[dn][2], f1[dn][3]);
        }
      }
    }
}

// mma_rows_t with SETS == 2 and each A operand given as a hi/lo pair
// (c_to_a_split): four products per B fragment, the lo term first, into
// the same accumulators (flash K3's dV += P^T dO and dK += dS^T Q).
template <int D, int N>
__device__ __forceinline__ void mma_rows_t_split(
    float (*acc0)[4], const uint32_t (*a0)[4], const uint32_t (*l0)[4],
    const bf16* tile0, float (*acc1)[4], const uint32_t (*a1)[4],
    const uint32_t (*l1)[4], const bf16* tile1) {
  constexpr int DC = D / 16 < 4 ? D / 16 : 4;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int d0 = 0; d0 < D / 16; d0 += DC) {
      uint32_t f0[DC][4], f1[DC][4];
#pragma unroll
      for (int dn = 0; dn < DC; ++dn) {
        ldsm_x4_t(tile0, D + 8, kk * 16, (d0 + dn) * 16, f0[dn]);
        ldsm_x4_t(tile1, D + 8, kk * 16, (d0 + dn) * 16, f1[dn]);
      }
#pragma unroll
      for (int dn = 0; dn < DC; ++dn) {
        float* c0 = acc0[2 * (d0 + dn)];
        float* c1 = acc0[2 * (d0 + dn) + 1];
        float* c2 = acc1[2 * (d0 + dn)];
        float* c3 = acc1[2 * (d0 + dn) + 1];
        mma_bf16(c0, l0[kk], f0[dn][0], f0[dn][1]);
        mma_bf16(c1, l0[kk], f0[dn][2], f0[dn][3]);
        mma_bf16(c2, l1[kk], f1[dn][0], f1[dn][1]);
        mma_bf16(c3, l1[kk], f1[dn][2], f1[dn][3]);
        mma_bf16(c0, a0[kk], f0[dn][0], f0[dn][1]);
        mma_bf16(c1, a0[kk], f0[dn][2], f0[dn][3]);
        mma_bf16(c2, a1[kk], f1[dn][0], f1[dn][1]);
        mma_bf16(c3, a1[kk], f1[dn][2], f1[dn][3]);
      }
    }
}

// The max and the sum over the 4 lanes that share a C fragment row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace dtx_mma
