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
// TMA descriptors are encoded on the host per call with
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (no -lcuda),
// and passed as __grid_constant__ kernel parameters.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "DTX_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra DTX_WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// A 2-d TMA load of the box at (c0 inner, c1 outer) into shared dst.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// A 2-d TMA store of shared src to the box at (c0 inner, c1 outer).
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}],"
      " [%3];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(src)
      : "memory");
}

// A wgmma shared-memory descriptor, 128-byte swizzle.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// d[128] += A (64 x 16, K-major) @ B (16 x 256, MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_n256(float* d, uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

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
        wgmma_n256(d, desc(sa + 32 * kk, 16, 1024),
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major [outer, inner] tensor read in [box_outer][box_inner] boxes
// with the 128-byte swizzle; zeros past its edges.
bool tensor_map(EncodeTiled enc, CUtensorMap* m, CUtensorMapDataType type,
                const void* ptr, uint64_t inner, uint64_t outer,
                uint64_t row_bytes, uint32_t box_inner, uint32_t box_outer) {
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return enc(m, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
  if (!sms) {
    int dev = 0;
    if (int e = (int)cudaGetDevice(&dev)) return e;
    if (int e = (int)cudaDeviceGetAttribute(
            &sms, cudaDevAttrMultiProcessorCount, dev))
      return e;
  }
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
