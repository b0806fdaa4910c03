// Quantized matmuls for QLoRA in f32 only: the nf4 product (K4), its
// transposed backward (K5) and the int8 w8a16 product (K6). The f32
// instantiations serve tests; the bf16 ones, which training runs, are
// wgmma kernels: K4/K5 in nf4_gemm.cu, K6 in int8_gemm.cu.
//
// Replaces (TPU kernels):
//   K4  datatunerx_tpu/ops/pallas_quant.py::_nf4_kernel    y  = x @ W
//   K5  datatunerx_tpu/ops/pallas_quant.py::_nf4_t_kernel  dx = g @ W^T
//   K6  datatunerx_tpu/ops/pallas_quant.py::_int8_kernel   y  = (x @ q) * s
//
// Operands (ops/quant.py layouts, read in place): x [M, K] and g [M, N]
// row-major in f32; nf4 W [K, N] as packed [N * K/64, 32] uint8
// (block = one output channel's 64 consecutive input weights; byte j holds
// element j in its low nibble and element j + 32 in its high nibble),
// scale_q [N * K/64] int8 and meta[0] f32; int8 q [K, N] with scale [N] f32.
//
// Rounding points are the reference's: an nf4 weight is
// code[idx] * (f32(scale_q) * meta[0]) in f32; an int8 weight converts
// exactly; the product accumulates in f32; K6's scale multiplies the f32
// accumulator. So a staged weight tile is bit-equal to the plain version's
// dequantized W, and kernel and plain version differ only in summation
// order.
//
// What bounds them on an H100: operations. At the training shapes
// (M = 8192 rows, K x N in {2048 x 2048, 2048 x 256, 2048 x 5632,
// 5632 x 2048}) each product does 2*M*K*N flops for about 2*M*(K + N)
// bytes of activations, far above the card's ops:byte ridge; the packed
// weights are a quarter byte per flop-row and stay in L2.
//
// What the design does about it (a first, simple version):
// - One GEMM skeleton serves all three: a 256-thread block owns a
//   128 x 128 output tile and walks the contraction in 64-wide steps (one
//   nf4 block per output channel). Each step stages the activation tile
//   (16-byte loads) and the dequantized weight tile in shared memory; the
//   next step's global loads are issued into registers before the current
//   step's products (a register double buffer).
// - The weight tile is always staged as [output column][contraction], the
//   layout the products read. K4 reads it straight from the
//   packed bytes (the packed rows ARE W^T); K5 reads the same bytes with the
//   roles of the axes swapped (its output columns are W's input dimension)
//   and transposes while staging; the f32 K6 transposes q's [K, N] rows.
//   The Pallas kernels' chunk-major host transposes and 16-way select-sum
//   codebook are TPU workarounds: here the codebook is a 16-entry table in
//   shared memory and no operand is rearranged on the host.
// - CUDA-core FMAs, 8 x 8 outputs per thread; the shared-memory row pitch
//   of 68 floats keeps rows 16-byte aligned.
// - Rows past M, channels past N and contraction past K load as zeros and
//   are never stored, so no operand needs padding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;  // rows per block
constexpr int BN = 128;  // output columns per block
constexpr int BK = 64;   // contraction per step: one nf4 block
constexpr int NT = 256;  // threads per block
constexpr int P = BK + 4;  // shared-memory row pitch in floats

// The reference's NF4_CODE, as double literals rounded to float (the same
// conversion numpy makes).
__constant__ float kNf4Code[16] = {
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0};

// ----------------------------------------------------------- operand A
// x or g [M, Kc] row-major; Kc % 4 == 0.
struct ALoad {
  static constexpr int VEC = 4;
  static constexpr int PER_ROW = BK / VEC;
  static constexpr int N = BM * PER_ROW / NT;
  uint4 r[N];

  __device__ __forceinline__ void load(const float* __restrict__ a, int M,
                                       int Kc, int m0, int k0) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int u = threadIdx.x + i * NT;
      const int m = m0 + u / PER_ROW, k = k0 + (u % PER_ROW) * VEC;
      r[i] = (m < M && k < Kc)
                 ? *reinterpret_cast<const uint4*>(a + (size_t)m * Kc + k)
                 : make_uint4(0, 0, 0, 0);
    }
  }
  __device__ __forceinline__ void store(float* As) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int u = threadIdx.x + i * NT;
      *reinterpret_cast<uint4*>(As + (u / PER_ROW) * P +
                                (u % PER_ROW) * VEC) = r[i];
    }
  }
};

// ------------------------------------------------------ weight sources
// Each stages Bs[output column][contraction] for the tile at (n0, k0).

// K4: output column n = channel, contraction k; the block of (n, k0) is
// one uint4 half per thread pair.
struct Nf4Fwd {
  const uint8_t* packed;
  const int8_t* scale_q;
  const float* meta;
  int N, nbk;  // channels, blocks per channel (K / 64)
  struct Regs { uint4 bytes; float s; };

  __device__ __forceinline__ void load(Regs& r, int n0, int k0) const {
    const int n = n0 + (threadIdx.x >> 1), h = threadIdx.x & 1;
    if (n < N) {
      const size_t blk = (size_t)n * nbk + k0 / BK;
      r.bytes = *reinterpret_cast<const uint4*>(packed + blk * 32 + h * 16);
      r.s = __fmul_rn((float)scale_q[blk], __ldg(meta));
    } else {
      r.bytes = make_uint4(0, 0, 0, 0);
      r.s = 0.f;
    }
  }
  __device__ __forceinline__ void store(const Regs& r, float* Bs,
                                        const float* code) const {
    const int h = threadIdx.x & 1;
    float* dst = Bs + (threadIdx.x >> 1) * P + 16 * h;
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&r.bytes);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      dst[i] = __fmul_rn(code[b[i] & 15], r.s);
      dst[32 + i] = __fmul_rn(code[b[i] >> 4], r.s);
    }
  }
};

// K5: output column j = W's input index (K), contraction c = channel (N);
// a tile covers 64 channels x 2 blocks, staged transposed.
struct Nf4T {
  const uint8_t* packed;
  const int8_t* scale_q;
  const float* meta;
  int N, nbk;
  struct Regs { uint4 bytes; float s; };

  __device__ __forceinline__ void load(Regs& r, int j0, int c0) const {
    const int c = c0 + (threadIdx.x >> 2);
    const int b = j0 / BK + ((threadIdx.x >> 1) & 1), h = threadIdx.x & 1;
    if (c < N && b < nbk) {
      const size_t blk = (size_t)c * nbk + b;
      r.bytes = *reinterpret_cast<const uint4*>(packed + blk * 32 + h * 16);
      r.s = __fmul_rn((float)scale_q[blk], __ldg(meta));
    } else {
      r.bytes = make_uint4(0, 0, 0, 0);
      r.s = 0.f;
    }
  }
  __device__ __forceinline__ void store(const Regs& r, float* Bs,
                                        const float* code) const {
    const int cl = threadIdx.x >> 2;
    const int j = ((threadIdx.x >> 1) & 1) * BK + (threadIdx.x & 1) * 16;
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&r.bytes);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      Bs[(j + i) * P + cl] = __fmul_rn(code[b[i] & 15], r.s);
      Bs[(j + 32 + i) * P + cl] = __fmul_rn(code[b[i] >> 4], r.s);
    }
  }
};

// K6: q [K, N] int8 rows; a tile is 64 rows x 128 bytes, two uint4 per
// thread, staged transposed (int8 -> f32 is exact).
struct Int8Src {
  const int8_t* q;
  int N, K;
  struct Regs { uint4 bytes[2]; };

  __device__ __forceinline__ void load(Regs& r, int n0, int k0) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int u = threadIdx.x + i * NT;
      const int k = k0 + (u >> 3), n = n0 + (u & 7) * 16;
      r.bytes[i] = (k < K && n < N)
                       ? *reinterpret_cast<const uint4*>(q + (size_t)k * N + n)
                       : make_uint4(0, 0, 0, 0);
    }
  }
  __device__ __forceinline__ void store(const Regs& r, float* Bs,
                                        const float*) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int u = threadIdx.x + i * NT;
      const int kl = u >> 3, nl = (u & 7) * 16;
      const int8_t* b = reinterpret_cast<const int8_t*>(&r.bytes[i]);
#pragma unroll
      for (int e = 0; e < 16; ++e)
        Bs[(nl + e) * P + kl] = (float)b[e];
    }
  }
};

// ------------------------------------------------------------- products
__device__ __forceinline__ void put(float* out, const float* colscale, int M,
                                    int N, int row, int col, float v) {
  if (row < M && col < N)
    out[(size_t)row * N + col] = colscale ? __fmul_rn(v, colscale[col]) : v;
}

// 16 x 16 threads, each rows ty + 16 i and columns tx + 16 j.
struct FmaAcc {
  float c[8][8];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) c[i][j] = 0.f;
  }
  __device__ __forceinline__ void step(const float* As, const float* Bs) {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[(ty + 16 * i) * P + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Bs[(tx + 16 * j) * P + kk];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
    }
  }
  __device__ __forceinline__ void store(float* out, const float* colscale,
                                        int M, int N, int m0, int n0) const {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        put(out, colscale, M, N, m0 + ty + 16 * i, n0 + tx + 16 * j,
            c[i][j]);
  }
};

// out [M, Nout] = a [M, Kc] @ B, B staged tile by tile by Src.
template <class Src>
__global__ void __launch_bounds__(NT)
    qgemm(const float* __restrict__ a, Src src, float* __restrict__ out,
          const float* __restrict__ colscale, int M, int Nout, int Kc) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);
  float* Bs = As + BM * P;
  float* code = Bs + BN * P;
  if (threadIdx.x < 16) code[threadIdx.x] = kNf4Code[threadIdx.x];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  ALoad al;
  typename Src::Regs br;
  al.load(a, M, Kc, m0, 0);
  src.load(br, n0, 0);
  FmaAcc acc;
  acc.zero();
  __syncthreads();  // the code table
  const int steps = (Kc + BK - 1) / BK;
  for (int s = 0; s < steps; ++s) {
    al.store(As);
    src.store(br, Bs, code);
    __syncthreads();
    if (s + 1 < steps) {  // next step's loads fly during this step's math
      al.load(a, M, Kc, m0, (s + 1) * BK);
      src.load(br, n0, (s + 1) * BK);
    }
    acc.step(As, Bs);
    __syncthreads();
  }
  acc.store(out, colscale, M, Nout, m0, n0);
}

template <class Src>
int launch(const void* a, const Src& src, void* out, const float* colscale,
           int M, int Nout, int Kc, cudaStream_t st) {
  if (M == 0 || Nout == 0) return 0;
  const int smem = (BM + BN) * P * (int)sizeof(float) + 16 * 4;
  static bool attr_set = false;  // once per instantiation
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        qgemm<Src>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid((Nout + BN - 1) / BN, (M + BM - 1) / BM);
  qgemm<Src><<<grid, NT, smem, st>>>(static_cast<const float*>(a), src,
                                      static_cast<float*>(out), colscale, M,
                                      Nout, Kc);
  return (int)cudaGetLastError();
}

}  // namespace

// K4 in f32 (the bf16 K4 is nf4_gemm.cu's wgmma kernel)
extern "C" int dtx_nf4_matmul_f32(const void* x, const uint8_t* packed,
                                  const int8_t* scale_q, const float* meta,
                                  void* out, int M, int K, int N,
                                  cudaStream_t st) {
  Nf4Fwd src{packed, scale_q, meta, N, K / BK};
  return launch(x, src, out, nullptr, M, N, K, st);
}

// K5 in f32 (the bf16 K5 is nf4_gemm.cu's wgmma kernel)
extern "C" int dtx_nf4_matmul_t_f32(const void* g, const uint8_t* packed,
                                    const int8_t* scale_q, const float* meta,
                                    void* dx, int M, int K, int N,
                                    cudaStream_t st) {
  Nf4T src{packed, scale_q, meta, N, K / BK};
  return launch(g, src, dx, nullptr, M, K, N, st);
}

// K6 in f32 (the bf16 K6 is int8_gemm.cu's wgmma kernel)
extern "C" int dtx_int8_matmul_f32(const void* x, const int8_t* q,
                                   const float* scale, void* out, int M,
                                   int K, int N, cudaStream_t st) {
  Int8Src src{q, N, K};
  return launch(x, src, out, scale, M, N, K, st);
}
