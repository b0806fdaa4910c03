// The nf4 QLoRA matmuls K4 and K5 in bf16 on Hopper's warpgroup tensor
// cores, from the packed nf4 bytes:
//   K4  y  [M, N] = round_bf16(x [M, K] @ W)      (W [K, N])
//   K5  dx [M, K] = round_bf16(g [M, N] @ W^T)    (the backward's dx)
//
// Replaces (TPU kernels):
//   K4  datatunerx_tpu/ops/pallas_quant.py::_nf4_kernel    y  = x @ W
//   K5  datatunerx_tpu/ops/pallas_quant.py::_nf4_t_kernel  dx = g @ W^T
// The f32 instantiations stay on quant.cu's CUDA-core skeleton (they serve
// tests; training runs bf16).
//
// Operands (ops/quant.py layouts, read in place): nf4 W [K, N] as packed
// [N * K/64, 32] uint8 (block = one output channel's 64 consecutive input
// weights; byte j holds element j in its low nibble and element j + 32 in
// its high nibble), scale_q [N * K/64] int8 and meta[0] f32.
//
// Rounding points are the reference's: a weight is
// code[idx] * (f32(scale_q) * meta[0]) in f32 (__fmul_rn twice), rounded to
// bf16 before the product; the product accumulates in f32 and the output
// rounds once. Every staged weight tile is bit-equal to
// dequant_nf4(..., dtype=bf16), and the kernels differ from the plain
// versions only in the order of their f32 sums.
//
// What bounds them on an H100: operations. At the training shapes (M = 8192
// rows; K x N of tinyllama's projections) a layer's seven products do
// ~0.72 TFLOP (~0.73 ms at the bf16 peak) against ~0.6 GB of activations,
// outputs and packed weights (~0.18 ms at 3.35 TB/s).
//
// What the design does about it (K6's skeleton, int8_gemm.cu):
// - A 384-thread block owns 128 x 256 output tiles, one after another
//   (persistent: one block an SM, n fastest). Warpgroup 0 produces (one
//   thread issues TMA) and hands its registers to warpgroups 1 and 2
//   (setmaxnreg), which consume with wgmma.m64n256k16 into 64 x 256 f32
//   accumulators each.
// - One nf4 block decodes to exactly one 128-byte row of a 128-byte-swizzle
//   atom, in both kernels, so the weights are staged with no transpose:
//   K4's B operand is W's [n][k] (K-major; row n = channel n's block at this
//   k step), K5's is W^T's [c][j] (MN-major, read through the transpose bit;
//   row c of the atom of output columns j .. j + 63 = channel c's block
//   j / 64).
// - Per 64-deep step TMA brings the activation tile [128][64] bf16 (x for
//   K4, g for K5, 128-byte swizzle) and the packed bytes into a 4-stage ring
//   from a 2-d byte view [N rows, K/2 bytes] of `packed`: K4 a box of
//   {32 bytes, 256 channels} (block k/64 of channels n0 .. n0 + 255), K5 a
//   box of {128 bytes, 64 channels} with the 128-byte swizzle (blocks
//   j0/64 .. j0/64 + 3 of channels c0 .. c0 + 63). Rows past M, channels
//   past N and bytes past K/2 arrive as zeros. Completion lands on the
//   stage's mbarrier ("full"); both consumers release it ("empty") once its
//   products are done, and the ring runs on across tiles. (4 stages, not 5:
//   at <= 196 KB of shared memory the SM keeps 60 KB of L1, not 28.)
// - The scale bytes (one a block, 256 a step, scattered: channel-major with
//   K/64 blocks a channel) come through the ring too: the producer's second
//   and third warps read them from L2 into the stage's 256-byte slot and
//   arrive on its "full" barrier beside the TMA. Read by the consumers
//   straight from global memory they cost K5 a sixth of its time (each
//   step's loads waited on L2).
// - Decode: each of the 256 consumer threads decodes one block a step. It
//   builds the block's own 16-entry table bf16_rn(code[i] * s) in registers
//   (16 products, not 64), split into a low-byte and a high-byte table of
//   four words each, and looks four nibbles up at a time with byte
//   permutes (prmt): 3 for 4 bytes of one table, 2 more to pair the bytes
//   into bf16 -- 16 prmt and 5 integer ops a packed word, 136 prmt a step.
//   It writes its 64 values as eight 16-byte stores to chunks c ^ (row & 7)
//   of its row; chunk c < 4 holds the low nibbles of bytes 8c .. 8c + 7,
//   chunk c + 4 their high nibbles. The eight threads of a quarter-warp own
//   eight consecutive rows of one atom (K4: thread t owns channel n0 + t;
//   K5: channel c0 + t % 64 in atom t / 64), so every 16-byte store, and
//   every 16-byte read of the packed bytes, is free of bank conflicts.
// - fence.proxy.async and a named barrier over the 256 consumer threads
//   publish the tile; four wgmma take it. wgmma.wait_group 1 lets step
//   i + 1's decode run under step i's products. Three bf16 B buffers: step
//   i + 1 writes the buffer step i - 2 read, which both warpgroups finished
//   before step i's barrier.
// - Epilogue: the accumulators rounded to bf16 into the idle B buffers as
//   four swizzled [128][64] boxes, stored by TMA, which drops what lies past
//   M and past the output width (N for K4, K for K5).
// Channels past N (K5's contraction when N % 64 != 0) have zero g columns;
// their scale is taken as 0 and never read.
// Where the time goes (H100): the decode's instructions, not shared memory.
// A build that copied the packed bytes in place of decoding them (the same
// shared-memory traffic) ran at K6's time; K4/K5 take ~1.2x that.

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
constexpr int P_BYTES = BN * BK / 2;  // 256 nf4 blocks of 32 bytes
constexpr int B_BYTES = BN * BK * 2;
constexpr int OFF_P = STAGES * A_BYTES;
constexpr int OFF_B = OFF_P + STAGES * P_BYTES;
constexpr int OFF_BAR = OFF_B + NBUF * B_BYTES;
constexpr int OFF_S = OFF_BAR + 2 * STAGES * 8;  // 256 scale bytes a stage
constexpr int SMEM = OFF_S + STAGES * 256 + 1024;  // + 1024-byte alignment

// The reference's NF4_CODE, as double literals rounded to float (the same
// conversion numpy makes).
__constant__ float kNf4Code[16] = {
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0};

// K4: output columns are W's channels, the contraction is K. The packed
// box is {32 bytes, 256 channels}, unswizzled: thread t decodes row t.
struct Nf4Fwd {
  static constexpr int kTransB = 0;
  __host__ __device__ static int out_cols(int K, int N) { return N; }
  __host__ __device__ static int contraction(int K, int N) { return K; }
  __device__ static void load_packed(uint32_t dst, const CUtensorMap* map,
                                     uint32_t bar, int n0, int i) {
    tma_load(dst, map, bar, i * BK / 2, n0);
  }
  // channel and block of thread t's nf4 block at step i
  __device__ static int channel(int t, int n0, int i) { return n0 + t; }
  __device__ static int block(int t, int n0, int i) { return i; }
  // byte offsets of thread t's packed half 0 (half h at src ^ h << 4) and
  // of its B-tile row r, with the row's swizzle r & 7 in bits 4..6 (chunk
  // c at rsw ^ c << 4)
  __device__ static int src(int t) { return t * 32; }
  __device__ static int rsw(int t) { return t * 128 | (t & 7) << 4; }
  // the half read first: rows 4..7 of a quarter-warp start with their
  // second half, so the eight 16-byte reads cover all 32 banks
  __device__ static int first_half(int t) { return (t >> 2) & 1; }
  __device__ static uint64_t desc_b(uint32_t sb, int kk) {
    return desc(sb + 32 * kk, 16, 1024);
  }
};

// K5: output columns are W's input index j (K), the contraction is the
// channel c (N). The packed box is {128 bytes, 64 channels}, 128-byte
// swizzle: thread t decodes channel c0 + t % 64, block j0/64 + t / 64.
struct Nf4T {
  static constexpr int kTransB = 1;
  __host__ __device__ static int out_cols(int K, int N) { return K; }
  __host__ __device__ static int contraction(int K, int N) { return N; }
  __device__ static void load_packed(uint32_t dst, const CUtensorMap* map,
                                     uint32_t bar, int n0, int i) {
    tma_load(dst, map, bar, n0 / 2, i * BK);
  }
  __device__ static int channel(int t, int n0, int i) {
    return i * BK + (t & 63);
  }
  __device__ static int block(int t, int n0, int i) {
    return n0 / BK + (t >> 6);
  }
  __device__ static int src(int t) {  // chunk 2 (t / 64), swizzled
    const int r = t & 63;
    return r * 128 + (((2 * (t >> 6)) ^ (r & 7)) << 4);
  }
  __device__ static int rsw(int t) {  // row t % 64 of atom t / 64
    return ((t >> 6) * 8192 + (t & 63) * 128) | (t & 7) << 4;
  }
  __device__ static int first_half(int) { return 0; }
  // k16 steps 16 rows (2 groups of 8) down the atoms; atoms 8192 bytes
  // apart along the output columns
  __device__ static uint64_t desc_b(uint32_t sb, int kk) {
    return desc(sb + 2048 * kk, 8192, 1024);
  }
};

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The block's table of bf16_rn(code[i] * s): tl holds the 16 low bytes,
// th the 16 high bytes, four entries a word.
__device__ __forceinline__ void nf4_table(float s, uint32_t* tl,
                                          uint32_t* th) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const uint32_t p0 = bf16x2(__fmul_rn(kNf4Code[4 * m], s),
                               __fmul_rn(kNf4Code[4 * m + 1], s));
    const uint32_t p1 = bf16x2(__fmul_rn(kNf4Code[4 * m + 2], s),
                               __fmul_rn(kNf4Code[4 * m + 3], s));
    tl[m] = __byte_perm(p0, p1, 0x6420);
    th[m] = __byte_perm(p0, p1, 0x7531);
  }
}

// Byte n of the result = t[index n] for the four 4-bit indices whose low
// three bits are sel's nibbles and whose high bits pick (as 4 in pick's
// nibble n) between entries 0..7 and 8..15.
__device__ __forceinline__ uint32_t lut16(const uint32_t* t, uint32_t sel,
                                          uint32_t pick) {
  return __byte_perm(__byte_perm(t[0], t[1], sel),
                     __byte_perm(t[2], t[3], sel), pick);
}

// One packed word (nibbles l0 h0 l1 h1 l2 h2 l3 h3: elements e .. e + 3 low,
// e + 32 .. e + 35 high) -> bf16 pairs lo = (l0, l1), (l2, l3) and
// hi = (h0, h1), (h2, h3).
__device__ __forceinline__ void decode_word(uint32_t w, const uint32_t* tl,
                                            const uint32_t* th, uint32_t* lo,
                                            uint32_t* hi) {
  // prmt reads only a selector's low 16 bits: the high halves serve the
  // high nibbles after one shift
  const uint32_t sa = w & 0x77777777u;
  const uint32_t pa = ((w >> 1) & 0x44444444u) | 0x32103210u;
  const uint32_t sb = sa >> 16, pb = pa >> 16;
  const uint32_t la = lut16(tl, sa, pa), ha = lut16(th, sa, pa);
  const uint32_t lb = lut16(tl, sb, pb), hb = lut16(th, sb, pb);
  lo[0] = __byte_perm(la, ha, 0x6240);
  hi[0] = __byte_perm(la, ha, 0x7351);
  lo[1] = __byte_perm(lb, hb, 0x6240);
  hi[1] = __byte_perm(lb, hb, 0x7351);
}

// Half h of a block (bytes 16h .. 16h + 15) -> chunks 2h, 2h + 1 (low
// nibbles) and 2h + 4, 2h + 5 (high) of the swizzled row whose chunk c
// sits at byte rsw ^ c << 4 of buf.
__device__ __forceinline__ void decode_half(uint4 v, int h, int rsw,
                                            const uint32_t* tl,
                                            const uint32_t* th,
                                            unsigned char* buf) {
  uint32_t lo[8], hi[8];
  decode_word(v.x, tl, th, lo, hi);
  decode_word(v.y, tl, th, lo + 2, hi + 2);
  decode_word(v.z, tl, th, lo + 4, hi + 4);
  decode_word(v.w, tl, th, lo + 6, hi + 6);
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int c = 2 * h + u;
    *reinterpret_cast<uint4*>(buf + (rsw ^ (c << 4))) =
        make_uint4(lo[4 * u], lo[4 * u + 1], lo[4 * u + 2], lo[4 * u + 3]);
    *reinterpret_cast<uint4*>(buf + (rsw ^ ((c + 4) << 4))) =
        make_uint4(hi[4 * u], hi[4 * u + 1], hi[4 * u + 2], hi[4 * u + 3]);
  }
}

template <class Role>
__global__ void __launch_bounds__(NT, 1)
    nf4_gemm_wgmma(const __grid_constant__ CUtensorMap tma,
                   const __grid_constant__ CUtensorMap tmp,
                   const __grid_constant__ CUtensorMap tmo,
                   const int8_t* __restrict__ scale_q,
                   const float* __restrict__ meta, int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzle atoms: 1024-aligned
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t full = base + OFF_BAR, empty = full + STAGES * 8;
  const int nout = Role::out_cols(K, N), kc = Role::contraction(K, N);
  const int ntn = (nout + BN - 1) / BN, tiles = ntn * ((M + BM - 1) / BM);
  const int steps = (kc + BK - 1) / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1 + 64);  // TMA's expect_tx, 64 scale lanes
      mbar_init(empty + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The block walks tiles blockIdx.x, + gridDim.x, ... (n fastest); g
  // counts k steps over all of them, so the ring runs on across tiles.
  const int nbk = K / BK;  // blocks per channel
  if (threadIdx.x < 128) {  // producer: its registers go to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {  // TMA: activations and packed bytes
      for (int tile = blockIdx.x, g = 0; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / ntn * BM, n0 = tile % ntn * BN;
        for (int i = 0; i < steps; ++i, ++g) {
          const int s = g % STAGES;
          if (g >= STAGES) mbar_wait(empty + 8 * s, (g / STAGES - 1) & 1);
          mbar_expect_tx(full + 8 * s, A_BYTES + P_BYTES);
          tma_load(base + s * A_BYTES, &tma, full + 8 * s, i * BK, m0);
          Role::load_packed(base + OFF_P + s * P_BYTES, &tmp, full + 8 * s,
                            n0, i);
        }
      }
    } else if (threadIdx.x >= 32 && threadIdx.x < 96) {
      // the scale byte of consumer thread t's block at slot byte t (0 past
      // the edges); the loads fly while the stage is still in use. Four a
      // lane over two warps keep the loop inside the producer's 40
      // registers (eight a lane over one warp spilled).
      const int lane = threadIdx.x - 32;
      for (int tile = blockIdx.x, g = 0; tile < tiles; tile += gridDim.x) {
        const int n0 = tile % ntn * BN;
        for (int i = 0; i < steps; ++i, ++g) {
          const int s = g % STAGES;
          int8_t v[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int t = lane + 64 * k;
            const int c = Role::channel(t, n0, i), b = Role::block(t, n0, i);
            v[k] = c < N && b < nbk ? __ldg(scale_q + c * nbk + b) : 0;
          }
          if (g >= STAGES) mbar_wait(empty + 8 * s, (g / STAGES - 1) & 1);
          int8_t* slot = reinterpret_cast<int8_t*>(sm + OFF_S + s * 256);
#pragma unroll
          for (int k = 0; k < 4; ++k) slot[lane + 64 * k] = v[k];
          mbar_arrive(full + 8 * s);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int ct = threadIdx.x - 128;  // consumer thread 0..255
  const int cw = ct >> 7;            // rows 64 cw .. 64 cw + 63 of the tile
  const float meta0 = __ldg(meta);
  const int h0 = Role::first_half(ct), src = Role::src(ct);
  const int rsw = Role::rsw(ct);
  float d[BN / 2];
  for (int tile = blockIdx.x, g = 0; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / ntn * BM, n0 = tile % ntn * BN;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
    for (int i = 0; i < steps; ++i, ++g) {
      const int s = g % STAGES;
      mbar_wait(full + 8 * s, (g / STAGES) & 1);
      const int sq =
          reinterpret_cast<const int8_t*>(sm + OFF_S + s * 256)[ct];
      uint32_t tl[4], th[4];
      nf4_table(__fmul_rn((float)sq, meta0), tl, th);
      const unsigned char* pt = sm + OFF_P + s * P_BYTES;
      unsigned char* buf = sm + OFF_B + (g % NBUF) * B_BYTES;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int h = h0 ^ u;
        decode_half(*reinterpret_cast<const uint4*>(pt + (src ^ h << 4)), h,
                    rsw, tl, th, buf);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      fence_acc(d);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      // A: this warpgroup's 64 rows, k16 steps 32 bytes into the swizzled
      // rows; B as the role lays it out
      const uint32_t sa = base + s * A_BYTES + cw * 8192;
      const uint32_t sb = base + OFF_B + (g % NBUF) * B_BYTES;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_n256<Role::kTransB>(d, desc(sa + 32 * kk, 16, 1024),
                                  Role::desc_b(sb, kk));
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

    // Epilogue: the accumulators rounded to bf16, into the (now idle) B
    // buffers as four swizzled [128][64] boxes, then out through TMA (which
    // drops what lies past M or the output width). d[4 j + 2 i + e] = (row
    // 16 w + r + 8 i, column 8 j + 2 t + e).
    const int w = (ct & 127) >> 5, r = (ct & 31) >> 2, t = ct & 3;
    unsigned char* stage_o = sm + OFF_B;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int rw = cw * 64 + w * 16 + r + 8 * i;
        *reinterpret_cast<uint32_t*>(stage_o + (j >> 3) * 16384 + rw * 128 +
                                     (((j & 7) ^ (rw & 7)) << 4) + 4 * t) =
            bf16x2(d[4 * j + 2 * i], d[4 * j + 2 * i + 1]);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    if (ct == 0) {
      for (int bx = 0; bx < BN / 64 && n0 + 64 * bx < nout; ++bx)
        tma_store(&tmo, base + OFF_B + bx * 16384, n0 + 64 * bx, m0);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");  // buffers free again
  }
  if (ct == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <class Role>
int set_smem() {
  static bool done = false;
  if (done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      nf4_gemm_wgmma<Role>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  done = e == cudaSuccess;
  return (int)e;
}

// a [M, contraction] bf16, packed [N * K/64, 32] uint8 (both 16-byte
// aligned), scale_q [N * K/64] int8, meta f32; out [M, output width] bf16.
template <class Role>
int launch(const void* a, const uint8_t* packed, const int8_t* scale_q,
           const float* meta, void* out, int M, int K, int N,
           cudaStream_t st) {
  const int nout = Role::out_cols(K, N), kc = Role::contraction(K, N);
  if (M == 0 || nout == 0) return 0;
  if (K <= 0 || K % BK || N <= 0 || N % 8 || (uintptr_t)a % 16 ||
      (uintptr_t)packed % 16 || (uintptr_t)out % 16 ||
      (int64_t)N * (K / BK) > INT32_MAX)  // scale_q is indexed in 32 bits
    return (int)cudaErrorInvalidValue;
  const EncodeTiled enc = encoder();
  if (!enc) return (int)cudaErrorNotSupported;
  CUtensorMap ma, mp, mo;
  if (!tensor_map(enc, &ma, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a, kc, M,
                  (uint64_t)kc * 2, BK, BM) ||
      !tensor_map(enc, &mp, CU_TENSOR_MAP_DATA_TYPE_UINT8, packed, K / 2, N,
                  (uint64_t)K / 2, Role::kTransB ? 128 : 32,
                  Role::kTransB ? 64 : 256,
                  Role::kTransB ? CU_TENSOR_MAP_SWIZZLE_128B
                                : CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !tensor_map(enc, &mo, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, out, nout, M,
                  (uint64_t)nout * 2, 64, BM))
    return (int)cudaErrorInvalidValue;
  if (int e = set_smem<Role>()) return e;
  static int sms = 0;  // one persistent block an SM
  if (!sms)
    if (int e = sm_count(&sms)) return e;
  const int tiles = ((nout + BN - 1) / BN) * ((M + BM - 1) / BM);
  nf4_gemm_wgmma<Role><<<tiles < sms ? tiles : sms, NT, SMEM, st>>>(
      ma, mp, mo, scale_q, meta, M, N, K);
  return (int)cudaGetLastError();
}

template <class Role>
int resources(int* out) {
  cudaFuncAttributes a;
  if (int e = (int)cudaFuncGetAttributes(&a, nf4_gemm_wgmma<Role>)) return e;
  if (int e = set_smem<Role>()) return e;
  int blocks = 0;
  if (int e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, nf4_gemm_wgmma<Role>, NT, SMEM))
    return e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = SMEM;
  out[3] = blocks;
  return 0;
}

}  // namespace

// K4: x [M, K] bf16 (K % 64 == 0) @ W [K, N] (N % 8 == 0) -> out [M, N].
extern "C" int dtx_nf4_matmul_bf16(const void* x, const uint8_t* packed,
                                   const int8_t* scale_q, const float* meta,
                                   void* out, int M, int K, int N,
                                   cudaStream_t st) {
  return launch<Nf4Fwd>(x, packed, scale_q, meta, out, M, K, N, st);
}

// K5: g [M, N] bf16 (N % 8 == 0) @ W^T [N, K] (K % 64 == 0) -> dx [M, K].
extern "C" int dtx_nf4_matmul_t_bf16(const void* g, const uint8_t* packed,
                                     const int8_t* scale_q, const float* meta,
                                     void* dx, int M, int K, int N,
                                     cudaStream_t st) {
  return launch<Nf4T>(g, packed, scale_q, meta, dx, M, K, N, st);
}

// What the bf16 K4 (out[0..3]) and K5 (out[4..7]) take of an SM:
// registers, local (spill) bytes per thread, dynamic shared bytes per block,
// resident blocks per SM.
extern "C" int dtx_nf4_matmul_resources(int* out) {
  if (int e = resources<Nf4Fwd>(out)) return e;
  return resources<Nf4T>(out + 4);
}
