// The int8 w8a16 matmul K6 in bf16 on Hopper's warpgroup tensor cores:
// out [M, N] = round_bf16((x [M, K] @ q [K, N]) * scale [N]).
//
// Replaces (TPU kernel):
//   K6  datatunerx_tpu/ops/pallas_quant.py::_int8_kernel   y = (x @ q) * s
// The f32 instantiation stays on quant.cu's CUDA-core skeleton (it serves
// tests; training runs bf16).
//
// Rounding points are the reference's: an int8 weight converts to bf16
// exactly, the product accumulates in f32, the scale multiplies the f32
// accumulator (__fmul_rn) and the output rounds once to bf16. Results differ
// from the plain version only in the order of the f32 sums.
//
// What bounds it on an H100: operations. At the training shapes (M = 8192
// rows; K x N of tinyllama's projections) a layer's seven products do
// ~0.72 TFLOP against ~0.2 GB of operands: ~0.73 ms at the bf16 peak.
//
// What the design does about it:
// - A 384-thread block owns 128 x 256 output tiles, one after another
//   (persistent: one block an SM walks tiles blockIdx.x, + gridDim.x, ...,
//   n fastest). Warpgroup 0 produces (one thread issues TMA) and hands its
//   registers to warpgroups 1 and 2 (setmaxnreg), which consume: each holds
//   64 rows x 256 columns of f32 accumulators for wgmma.m64n256k16.
// - Per 64-deep k step TMA brings the x tile [128][64] bf16 and the q tile
//   as two [64][128] int8 boxes, all with the 128-byte swizzle, into a
//   4-stage ring; completion lands on the stage's mbarrier ("full"), and
//   both consumer warpgroups release the stage ("empty") once its products
//   are done. The ring runs on across tiles, so the next tile's loads fly
//   during an epilogue. Rows past M, columns past N and depth past K arrive
//   as zeros, so no operand is padded.
// - The consumers convert the q tile to bf16 in q's own [k][n] layout: the
//   MN-major layout wgmma reads through its transpose bit, in 128-byte
//   swizzled atoms of 64 columns x 8 rows (LBO = the atoms' stride along n,
//   SBO = the 8-row groups' stride along k). int8 -> bf16 is exact and
//   takes no I2F: each byte, offset by 128, becomes the low byte of the f32
//   2^23 + x + 128, one subtraction leaves x, whose upper half is its bf16.
//   16-byte vector reads and writes, conflict-free through the swizzle.
// - fence.proxy.async and a named barrier over the 256 consumer threads
//   publish the tile; four wgmma take A = x (K-major) and B from shared
//   memory. wgmma.wait_group 1 lets step i + 1's conversion run under step
//   i's products. Three bf16 buffers: step i + 1 writes the buffer step
//   i - 2 read, which both warpgroups finished before step i's barrier.
// - Epilogue: acc * scale[col] (__fmul_rn), rounded to bf16, written into
//   the idle bf16 buffers as four swizzled [128][64] boxes and stored by
//   TMA, which drops what lies past M or N. (Stored straight from
//   registers as bf16 pairs, the epilogue took a fifth of the time.)
// - Shared memory, not the tensor cores, sets the pace: per k step the
//   wgmma operand reads (80 KB), the TMA writes (32 KB) and the conversion
//   (16 KB read, 32 KB written) are ~1.2 of what an SM's shared memory
//   moves in the products' 1,024 cycles.
// The TMA/mbarrier/wgmma helpers and the host-side descriptor encoding are
// wgmma_sm90.cuh's, shared with nf4_gemm.cu.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_sm90.cuh"

namespace {

using namespace dtx_sm90;

constexpr int BM = 128, BN = 256, BK = 64;
constexpr int STAGES = 4, NBUF = 3;
constexpr int NT = 384;  // the producer warpgroup and two consumers
constexpr int A_BYTES = BM * BK * 2;
constexpr int Q_BYTES = BK * BN;  // two [64][128] TMA boxes
constexpr int B_BYTES = BK * BN * 2;
constexpr int OFF_Q = STAGES * A_BYTES;
constexpr int OFF_B = OFF_Q + STAGES * Q_BYTES;
constexpr int OFF_BAR = OFF_B + NBUF * B_BYTES;
constexpr int SMEM = OFF_BAR + 2 * STAGES * 8 + 1024;  // + 1024-byte alignment

// 4 int8 (one word) -> 4 bf16 (two words), exactly.
__device__ __forceinline__ uint2 i8x4_to_bf16(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;  // x + 128 in each byte
  constexpr uint32_t kExp = 0x4B000000u;  // the f32 2^23
  constexpr float kBias = 8388736.f;       // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, kExp, 0x7650)) - kBias;
  const float f1 = __uint_as_float(__byte_perm(u, kExp, 0x7651)) - kBias;
  const float f2 = __uint_as_float(__byte_perm(u, kExp, 0x7652)) - kBias;
  const float f3 = __uint_as_float(__byte_perm(u, kExp, 0x7653)) - kBias;
  return make_uint2(
      __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632),
      __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632));
}

__global__ void __launch_bounds__(NT, 1)
    int8_gemm_wgmma(const __grid_constant__ CUtensorMap tmx,
                    const __grid_constant__ CUtensorMap tmq,
                    const __grid_constant__ CUtensorMap tmo,
                    const float* __restrict__ scale, int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzle atoms: 1024-aligned
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t full = base + OFF_BAR, empty = full + STAGES * 8;
  const int ntn = (N + BN - 1) / BN, tiles = ntn * ((M + BM - 1) / BM);
  const int steps = (K + BK - 1) / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The block walks tiles blockIdx.x, + gridDim.x, ... (n fastest); g
  // counts k steps over all of them, so the ring runs on across tiles and
  // the next tile's loads fly during this tile's epilogue.
  if (threadIdx.x < 128) {  // producer: its registers go to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0)
      for (int tile = blockIdx.x, g = 0; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / ntn * BM, n0 = tile % ntn * BN;
        for (int i = 0; i < steps; ++i, ++g) {
          const int s = g % STAGES;
          if (g >= STAGES) mbar_wait(empty + 8 * s, (g / STAGES - 1) & 1);
          mbar_expect_tx(full + 8 * s, A_BYTES + Q_BYTES);
          tma_load(base + s * A_BYTES, &tmx, full + 8 * s, i * BK, m0);
          for (int h = 0; h < 2; ++h)
            tma_load(base + OFF_Q + s * Q_BYTES + h * (Q_BYTES / 2), &tmq,
                     full + 8 * s, n0 + h * (BN / 2), i * BK);
        }
      }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int ct = threadIdx.x - 128;  // consumer thread 0..255
  const int cw = ct >> 7;            // rows 64 cw .. 64 cw + 63 of the tile
  float d[BN / 2];
  for (int tile = blockIdx.x, g = 0; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / ntn * BM, n0 = tile % ntn * BN;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
    for (int i = 0; i < steps; ++i, ++g) {
      const int s = g % STAGES;
      mbar_wait(full + 8 * s, (g / STAGES) & 1);
      // q box h, row k, 16-byte column c16 -> bf16 [k][n] in atoms of 64
      // columns (n = 128 h + 16 c16 .. + 15: atom 2 h + c16 / 4)
      const unsigned char* qt = sm + OFF_Q + s * Q_BYTES;
      unsigned char* bt = sm + OFF_B + (g % NBUF) * B_BYTES;
#pragma unroll
      for (int t = 0; t < Q_BYTES / 16 / 256; ++t) {
        const int ch = ct + 256 * t, h = ch >> 9, k = ch & 63;
        const int c16 = (ch >> 6) & 7, sw = k & 7;
        const uint4 v = *reinterpret_cast<const uint4*>(
            qt + h * 8192 + k * 128 + ((c16 ^ sw) << 4));
        const uint2 b0 = i8x4_to_bf16(v.x), b1 = i8x4_to_bf16(v.y);
        const uint2 b2 = i8x4_to_bf16(v.z), b3 = i8x4_to_bf16(v.w);
        unsigned char* row = bt + (2 * h + (c16 >> 2)) * 8192 + k * 128;
        const int c0 = (c16 & 3) * 2;  // the first of the two 16-byte chunks
        *reinterpret_cast<uint4*>(row + ((c0 ^ sw) << 4)) =
            make_uint4(b0.x, b0.y, b1.x, b1.y);
        *reinterpret_cast<uint4*>(row + (((c0 + 1) ^ sw) << 4)) =
            make_uint4(b2.x, b2.y, b3.x, b3.y);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      fence_acc(d);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      // A: this warpgroup's 64 rows, k16 steps 32 bytes into the swizzled
      // rows; B: k16 steps 16 rows (2 groups of 8) down the atoms
      const uint32_t sa = base + s * A_BYTES + cw * 8192;
      const uint32_t sb = base + OFF_B + (g % NBUF) * B_BYTES;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_n256<1>(d, desc(sa + 32 * kk, 16, 1024),
                   desc(sb + 2048 * kk, 8192, 1024));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_acc(d);
      // step g - 1's products are done: its stage goes back to the producer
      if (g > 0 && (ct & 127) == 0)
        mbar_arrive(empty + 8 * ((g - 1) % STAGES));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(d);
    asm volatile("bar.sync 1, 256;\n" ::: "memory");  // both are done

    // Epilogue: acc * scale[col], rounded to bf16, into the (now idle) bf16
    // buffers as four swizzled [128][64] boxes, then out through TMA (which
    // drops what lies past M or N). d[4 j + 2 i + e] = (row 16 w + r + 8 i,
    // column 8 j + 2 t + e).
    const int w = (ct & 127) >> 5, r = (ct & 31) >> 2, t = ct & 3;
    unsigned char* stage_o = sm + OFF_B;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      const float s0 = col < N ? scale[col] : 0.f;
      const float s1 = col < N ? scale[col + 1] : 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = cw * 64 + w * 16 + r + 8 * i;
        const __nv_bfloat162 v =
            __floats2bfloat162_rn(__fmul_rn(d[4 * j + 2 * i], s0),
                                  __fmul_rn(d[4 * j + 2 * i + 1], s1));
        *reinterpret_cast<__nv_bfloat162*>(
            stage_o + (j >> 3) * 16384 + row * 128 +
            (((j & 7) ^ (row & 7)) << 4) + 4 * t) = v;
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    if (ct == 0) {
      for (int bx = 0; bx < BN / 64; ++bx)
        tma_store(&tmo, base + OFF_B + bx * 16384, n0 + 64 * bx, m0);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");  // buffers free again
  }
  if (ct == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

int set_smem() {
  static bool done = false;
  if (done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      int8_gemm_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  done = e == cudaSuccess;
  return (int)e;
}

}  // namespace

// x [M, K] bf16 (K % 8 == 0), q [K, N] int8 (N % 16 == 0), both 16-byte
// aligned; scale [N] f32; out [M, N] bf16.
extern "C" int dtx_int8_matmul_bf16(const void* x, const int8_t* q,
                                    const float* scale, void* out, int M,
                                    int K, int N, cudaStream_t st) {
  if (M == 0 || N == 0) return 0;
  if (K <= 0 || K % 8 || N % 16 || (uintptr_t)x % 16 || (uintptr_t)q % 16 ||
      (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled enc = encoder();
  if (!enc) return (int)cudaErrorNotSupported;
  CUtensorMap mx, mq, mo;
  if (!tensor_map(enc, &mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M,
                  (uint64_t)K * 2, BK, BM) ||
      !tensor_map(enc, &mq, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, N, K,
                  (uint64_t)N, BN / 2, BK) ||
      !tensor_map(enc, &mo, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, out, N, M,
                  (uint64_t)N * 2, 64, BM))
    return (int)cudaErrorInvalidValue;
  if (int e = set_smem()) return e;
  static int sms = 0;  // one persistent block an SM
  if (!sms)
    if (int e = sm_count(&sms)) return e;
  const int tiles = ((N + BN - 1) / BN) * ((M + BM - 1) / BM);
  int8_gemm_wgmma<<<tiles < sms ? tiles : sms, NT, SMEM, st>>>(
      mx, mq, mo, scale, M, N, K);
  return (int)cudaGetLastError();
}

// What the bf16 K6 takes of an SM: registers, local (spill) bytes per
// thread, dynamic shared bytes per block, resident blocks per SM.
extern "C" int dtx_int8_matmul_resources(int* out) {
  cudaFuncAttributes a;
  if (int e = (int)cudaFuncGetAttributes(&a, int8_gemm_wgmma)) return e;
  if (int e = set_smem()) return e;
  int blocks = 0;
  if (int e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, int8_gemm_wgmma, NT, SMEM))
    return e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = SMEM;
  out[3] = blocks;
  return 0;
}
