// The fused LoRA matmul K10 in bf16 for many rows, on Hopper's warpgroup
// tensor cores: out [M, N] = round_bf16(x W + round_bf16(x A) B * scale).
//
// Replaces (TPU kernel):
//   K10  datatunerx_tpu/ops/pallas_lora.py::_lora_kernel
// for bf16 operands with more rows than the split-K kernel of lora.cu takes
// (the wrapper's _route); the f32 K10 and the few-row K10 stay in lora.cu.
//
// Rounding points are the reference's: x W and xa = x A accumulate in f32
// (the tensor cores' accumulators); xa rounds once to bf16 after the whole
// K sum; xa B accumulates in f32 and is multiplied by scale (__fmul_rn);
// the sum (__fadd_rn) rounds once to bf16. Results differ from the plain
// version only in the order of the f32 sums.
//
// What bounds it on an H100: operations. At a training batch (M = 8192
// rows, K = 2048, q_proj's N = 2048) the product is 69 GFLOP against 46 MB
// of operands: 0.070 ms at the bf16 peak. The adapter adds 2 M r (K + N)
// flops, 0.4 % at r = 8.
//
// What the design does about it: int8_gemm.cu's skeleton (K6), with W read
// as it lies.
// - A 384-thread block owns BM x BN output tiles (BN = 256, or 128 when the
//   256-wide tiles would leave SMs idle, as on v_proj's N = 256), one after
//   another (persistent, n fastest). Warpgroup 0 produces: one thread
//   issues TMA, and the warpgroup hands its registers to warpgroups 1 and 2
//   (setmaxnreg), which consume, 64 rows each.
// - Per 64-deep k step TMA brings the x tile [128][64], W's [64][BN] as
//   [64][64] boxes, and the xa strip's operand (below), all with the
//   128-byte swizzle, into a ring of 4 stages (3 at r > 16); "full" and
//   "empty" mbarriers hand the stages over. W [K, N] row-major is already
//   the MN-major B operand that wgmma reads through its transpose bit
//   (LBO = the 64-column atoms' stride, SBO = the 8-row groups' stride), so
//   nothing is converted: the consumers only issue products.
// - The xa strip. The strip's B operand is LoRA A's [64][r] slice, MN-major
//   and only 2 r bytes wide: too narrow for the 128-byte swizzle. The
//   wrapper hands the kernel Aᵀ [r, K] instead (one copy of K r elements,
//   32 KB at K = 2048, r = 8), whose [RP][64] box is K-major with 128-byte
//   rows: the layout of the x tile, loaded by the same TMA path. Each k16
//   step then adds one narrow wgmma m64nRPk16 (RP = r rounded up to 8, 16,
//   32 or 64; rows past r arrive as zeros) to the group of the step's
//   products, on the x tile already staged. Staging Aᵀ by hand on the
//   producer's spare warps would have cost registers in the producer (K4's
//   loader spilled at 40) for nothing the copy does not do.
// - The epilogue. The xa accumulators round to bf16 in registers and are,
//   as they lie, the A fragments of a register-sourced wgmma m64n64k16
//   against LoRA B's [16][64] boxes (TMA zero-fills the rank rows past r;
//   loaded once a tile, after the tile's k steps, so the producer never
//   waits on an epilogue before it runs ahead), in BN / 64 chunks so that
//   its accumulator adds 32 registers, not BN / 2. Then c + d * scale,
//   rounded to bf16, goes through one swizzled [128][64] staging box and out
//   by TMA (which drops what lies past M or N), one 64-column chunk at a
//   time.
// - Rows past M, columns past N and depth past K arrive as zeros, so no
//   operand is padded. K and N must be multiples of 8 (16-byte rows for
//   TMA); the wrapper pads what is not.
// The TMA/mbarrier/wgmma helpers and the host-side descriptor encoding are
// wgmma_sm90.cuh's, shared with int8_gemm.cu and nf4_gemm.cu.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_sm90.cuh"

namespace {

using namespace dtx_sm90;

constexpr int BM = 128, BK = 64;
constexpr int NT = 384;  // the producer warpgroup and two consumers

template <int BN, int RP>
struct Cfg {
  static constexpr int STAGES = RP <= 16 ? 4 : 3;
  static constexpr int RK = RP < 16 ? 16 : RP;  // B rows: whole k16 steps
  static constexpr int X_BYTES = BM * BK * 2;
  static constexpr int W_BYTES = BK * BN * 2;   // BN / 64 boxes [64][64]
  static constexpr int AT_BYTES = RP * BK * 2;  // Aᵀ's box [RP][64]
  static constexpr int STAGE = X_BYTES + W_BYTES + AT_BYTES;
  static constexpr int BOX_B = RK * 128;        // one [RK][64] box of B
  static constexpr int OFF_B = STAGES * STAGE;
  static constexpr int OFF_O = OFF_B + BOX_B * (BN / 64);
  static constexpr int OFF_BAR = OFF_O + BM * 128;  // one [128][64] box
  static constexpr int SMEM = OFF_BAR + (2 * STAGES + 2) * 8 + 1024;
  static_assert(SMEM <= 232448, "shared memory");
  static_assert(AT_BYTES % 1024 == 0 && BOX_B % 1024 == 0, "atoms");
};

template <int BN, int RP>
__global__ void __launch_bounds__(NT, 1)
    lora_gemm_wgmma(const __grid_constant__ CUtensorMap tmx,
                    const __grid_constant__ CUtensorMap tmw,
                    const __grid_constant__ CUtensorMap tmat,
                    const __grid_constant__ CUtensorMap tmb,
                    const __grid_constant__ CUtensorMap tmo, int M, int N,
                    int K, float scale) {
  using C = Cfg<BN, RP>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzle atoms: 1024-aligned
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t full = base + C::OFF_BAR, empty = full + C::STAGES * 8;
  const uint32_t bfull = empty + C::STAGES * 8, bempty = bfull + 8;
  const int ntn = (N + BN - 1) / BN, tiles = ntn * ((M + BM - 1) / BM);
  const int steps = (K + BK - 1) / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    mbar_init(bfull, 1);
    mbar_init(bempty, 2);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer: its registers go to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0)
      for (int tile = blockIdx.x, g = 0, tc = 0; tile < tiles;
           tile += gridDim.x, ++tc) {
        const int m0 = tile / ntn * BM, n0 = tile % ntn * BN;
        for (int i = 0; i < steps; ++i, ++g) {
          const int s = g % C::STAGES;
          const uint32_t st = base + s * C::STAGE;
          if (g >= C::STAGES)
            mbar_wait(empty + 8 * s, (g / C::STAGES - 1) & 1);
          mbar_expect_tx(full + 8 * s, C::STAGE);
          tma_load(st, &tmx, full + 8 * s, i * BK, m0);
          for (int h = 0; h < BN / 64; ++h)
            tma_load(st + C::X_BYTES + h * 8192, &tmw, full + 8 * s,
                     n0 + 64 * h, i * BK);
          tma_load(st + C::X_BYTES + C::W_BYTES, &tmat, full + 8 * s, i * BK,
                   0);
        }
        // LoRA B's [RK][BN] for this tile, once the last tile's epilogue has
        // read its own (the consumers freed this tile's stages after that)
        if (tc > 0) mbar_wait(bempty, (tc - 1) & 1);
        mbar_expect_tx(bfull, C::BOX_B * (BN / 64));
        for (int h = 0; h < BN / 64; ++h)
          tma_load(base + C::OFF_B + h * C::BOX_B, &tmb, bfull, n0 + 64 * h,
                   0);
      }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int ct = threadIdx.x - 128;  // consumer thread 0..255
  const int cw = ct >> 7;            // rows 64 cw .. 64 cw + 63 of the tile
  // accumulator layout (m64nNk16): d[4 j + 2 i + e] = (row 16 w + r + 8 i,
  // column 8 j + 2 t + e), w the warp in the warpgroup, r = lane / 4, t =
  // lane % 4
  const int w = (ct & 127) >> 5, r = (ct & 31) >> 2, t = ct & 3;
  float d[BN / 2], xa[RP / 2];
  for (int tile = blockIdx.x, g = 0, tc = 0; tile < tiles;
       tile += gridDim.x, ++tc) {
    const int m0 = tile / ntn * BM, n0 = tile % ntn * BN;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
#pragma unroll
    for (int i = 0; i < RP / 2; ++i) xa[i] = 0.f;
    for (int i = 0; i < steps; ++i, ++g) {
      const int s = g % C::STAGES;
      mbar_wait(full + 8 * s, (g / C::STAGES) & 1);
      fence_regs<BN / 2>(d);
      fence_regs<RP / 2>(xa);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      // A: this warpgroup's 64 rows of x, k16 steps 32 bytes into the
      // swizzled rows; W: k16 steps 16 rows (2 groups of 8) down the atoms;
      // Aᵀ: K-major like x
      const uint32_t sa = base + s * C::STAGE + cw * 8192;
      const uint32_t sw = base + s * C::STAGE + C::X_BYTES;
      const uint32_t sat = sw + C::W_BYTES;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da = desc(sa + 32 * kk, 16, 1024);
        wgmma_ss<BN, 1>(d, da, desc(sw + 2048 * kk, 8192, 1024), 1);
        wgmma_ss<RP, 0>(xa, da, desc(sat + 32 * kk, 16, 1024), 1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_regs<BN / 2>(d);
      fence_regs<RP / 2>(xa);
      // step g - 1's products are done: its stage goes back to the producer
      if (g > 0 && (ct & 127) == 0)
        mbar_arrive(empty + 8 * ((g - 1) % C::STAGES));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs<BN / 2>(d);
    fence_regs<RP / 2>(xa);

    // xa, rounded once to bf16, is in registers the A operand of the rank
    // product: A fragment q of k16 chunk kc holds columns 16 kc + 8 (q / 2)
    // + 2 t .. + 1 of row r + 8 (q % 2) = xa[8 kc + 2 q], xa[8 kc + 2 q + 1]
    uint32_t af[C::RK / 16][4];
#pragma unroll
    for (int kc = 0; kc < C::RK / 16; ++kc)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 8 * kc + 2 * q;
        if (i < RP / 2) {
          const __nv_bfloat162 v = __floats2bfloat162_rn(xa[i], xa[i + 1]);
          af[kc][q] = *reinterpret_cast<const uint32_t*>(&v);
        } else {
          af[kc][q] = 0u;
        }
      }
    mbar_wait(bfull, tc & 1);
#pragma unroll
    for (int h = 0; h < BN / 64; ++h) {
      float dd[32];
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kc = 0; kc < C::RK / 16; ++kc)
        wgmma_rs_n64<1>(dd, af[kc],
                        desc(base + C::OFF_B + h * C::BOX_B + 2048 * kc,
                             C::BOX_B, 1024),
                        kc > 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs<32>(dd);
#pragma unroll
      for (int q = 0; q < 32; ++q)
        d[32 * h + q] = __fadd_rn(d[32 * h + q], __fmul_rn(dd[q], scale));
    }
    if ((ct & 127) == 0) mbar_arrive(bempty);  // B's boxes are read

    // out through one swizzled [128][64] box, a 64-column chunk at a time
    unsigned char* stage_o = sm + C::OFF_O;
#pragma unroll
    for (int h = 0; h < BN / 64; ++h) {
      if (ct == 0)  // the last chunk's store has read the box
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = cw * 64 + w * 16 + r + 8 * i;
          *reinterpret_cast<__nv_bfloat162*>(
              stage_o + row * 128 + ((j ^ (row & 7)) << 4) + 4 * t) =
              __floats2bfloat162_rn(d[32 * h + 4 * j + 2 * i],
                                    d[32 * h + 4 * j + 2 * i + 1]);
        }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      if (ct == 0) {
        tma_store(&tmo, base + C::OFF_O, n0 + 64 * h, m0);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
  }
  if (ct == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <int BN, int RP>
int set_smem() {
  static bool done = false;
  if (done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      lora_gemm_wgmma<BN, RP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Cfg<BN, RP>::SMEM);
  done = e == cudaSuccess;
  return (int)e;
}

template <int BN, int RP>
int launch(const void* x, const void* w, const void* at, const void* b,
           void* out, int M, int K, int N, int r, float scale, int sms,
           cudaStream_t st) {
  const EncodeTiled enc = encoder();
  if (!enc) return (int)cudaErrorNotSupported;
  constexpr CUtensorMapDataType BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap mx, mw, mat, mb, mo;
  if (!tensor_map(enc, &mx, BF16, x, K, M, (uint64_t)K * 2, BK, BM) ||
      !tensor_map(enc, &mw, BF16, w, N, K, (uint64_t)N * 2, 64, BK) ||
      !tensor_map(enc, &mat, BF16, at, K, r, (uint64_t)K * 2, BK, RP) ||
      !tensor_map(enc, &mb, BF16, b, N, r, (uint64_t)N * 2, 64,
                  Cfg<BN, RP>::RK) ||
      !tensor_map(enc, &mo, BF16, out, N, M, (uint64_t)N * 2, 64, BM))
    return (int)cudaErrorInvalidValue;
  if (int e = set_smem<BN, RP>()) return e;
  const int tiles = ((N + BN - 1) / BN) * ((M + BM - 1) / BM);
  lora_gemm_wgmma<BN, RP><<<tiles < sms ? tiles : sms, NT, Cfg<BN, RP>::SMEM,
                            st>>>(mx, mw, mat, mb, mo, M, N, K, scale);
  return (int)cudaGetLastError();
}

template <int BN>
int launch_rp(const void* x, const void* w, const void* at, const void* b,
              void* out, int M, int K, int N, int r, float scale, int sms,
              cudaStream_t st) {
  if (r <= 8) return launch<BN, 8>(x, w, at, b, out, M, K, N, r, scale, sms, st);
  if (r <= 16)
    return launch<BN, 16>(x, w, at, b, out, M, K, N, r, scale, sms, st);
  if (r <= 32)
    return launch<BN, 32>(x, w, at, b, out, M, K, N, r, scale, sms, st);
  return launch<BN, 64>(x, w, at, b, out, M, K, N, r, scale, sms, st);
}

template <int BN, int RP>
int resources(int* out) {
  cudaFuncAttributes a;
  if (int e = (int)cudaFuncGetAttributes(&a, lora_gemm_wgmma<BN, RP>))
    return e;
  if (int e = set_smem<BN, RP>()) return e;
  int blocks = 0;
  if (int e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, lora_gemm_wgmma<BN, RP>, NT, Cfg<BN, RP>::SMEM))
    return e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = Cfg<BN, RP>::SMEM;
  out[3] = blocks;
  return 0;
}

}  // namespace

// x [M, K], W [K, N], Aᵀ [r, K] (LoRA A transposed), B [r, N], out [M, N],
// all bf16 row-major and 16-byte aligned; K % 8 == 0, N % 8 == 0,
// 1 <= r <= 64.
extern "C" int dtx_lora_gemm_bf16(const void* x, const void* w,
                                  const void* at, const void* b, void* out,
                                  int M, int K, int N, int r, float scale,
                                  void* stream) {
  if (M == 0 || N == 0) return 0;
  if (K <= 0 || K % 8 || N % 8 || r < 1 || r > 64 || (uintptr_t)x % 16 ||
      (uintptr_t)w % 16 || (uintptr_t)at % 16 || (uintptr_t)b % 16 ||
      (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  static int sms = 0;  // one persistent block an SM
  if (!sms)
    if (int e = sm_count(&sms)) return e;
  const cudaStream_t st = (cudaStream_t)stream;
  // 256-wide tiles unless they would leave SMs idle
  const int tiles256 = ((N + 255) / 256) * ((M + BM - 1) / BM);
  if (tiles256 >= sms)
    return launch_rp<256>(x, w, at, b, out, M, K, N, r, scale, sms, st);
  return launch_rp<128>(x, w, at, b, out, M, K, N, r, scale, sms, st);
}

// What the bf16 many-row K10 takes of an SM at r <= 8: registers, local
// (spill) bytes per thread, dynamic shared bytes per block, resident blocks
// per SM; out[0..3] for 128 x 256 tiles, out[4..7] for 128 x 128.
extern "C" int dtx_lora_gemm_resources(int* out) {
  if (int e = resources<256, 8>(out)) return e;
  return resources<128, 8>(out + 4);
}
