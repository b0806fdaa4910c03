// Quantized matmuls for QLoRA: the nf4 product (K4), its transposed
// backward (K5) and the int8 w8a16 product (K6) in f32. The bf16 K6, the
// one training runs, is int8_gemm.cu's wgmma kernel.
//
// Replaces (TPU kernels):
//   K4  datatunerx_tpu/ops/pallas_quant.py::_nf4_kernel    y  = x @ W
//   K5  datatunerx_tpu/ops/pallas_quant.py::_nf4_t_kernel  dx = g @ W^T
//   K6  datatunerx_tpu/ops/pallas_quant.py::_int8_kernel   y  = (x @ q) * s
//
// Operands (ops/quant.py layouts, read in place): x [M, K] and g [M, N]
// row-major in bf16 or f32; nf4 W [K, N] as packed [N * K/64, 32] uint8
// (block = one output channel's 64 consecutive input weights; byte j holds
// element j in its low nibble and element j + 32 in its high nibble),
// scale_q [N * K/64] int8 and meta[0] f32; int8 q [K, N] with scale [N] f32.
//
// Rounding points are the reference's: an nf4 weight is
// code[idx] * (f32(scale_q) * meta[0]) in f32, rounded to the input dtype
// before the product; an int8 weight converts exactly; the product
// accumulates in f32; K6's scale multiplies the f32 accumulator; the output
// rounds once. So a staged weight tile is bit-equal to the plain version's
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
//   (16-byte loads) and the dequantized weight tile in shared memory as the
//   compute dtype; the next step's global loads are issued into registers
//   before the current step's products (a register double buffer).
// - The weight tile is always staged as [output column][contraction], the
//   layout the tensor cores' B operand reads. K4 reads it straight from the
//   packed bytes (the packed rows ARE W^T); K5 reads the same bytes with the
//   roles of the axes swapped (its output columns are W's input dimension)
//   and transposes while staging; the f32 K6 transposes q's [K, N] rows.
//   The Pallas kernels' chunk-major host transposes and 16-way select-sum
//   codebook are TPU workarounds: here the codebook is a 16-entry table in
//   shared memory and no operand is rearranged on the host.
// - bf16 (K4, K5): each of 8 warps computes a 64 x 32 sub-tile with
//   mma.sync.m16n8k16 (bf16 in, f32 accumulate); the shared-memory row
//   pitch of 72 elements makes the fragment loads bank-conflict free.
//   f32 (K4, K5 and K6): CUDA-core FMAs, 8 x 8 outputs per thread (the f32
//   variant serves tests; training runs bf16).
// - Rows past M, channels past N and contraction past K load as zeros and
//   are never stored, so no operand needs padding.
// wgmma, TMA and a deeper pipeline for K4/K5 are later work (the bf16 K6
// has them).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;  // rows per block
constexpr int BN = 128;  // output columns per block
constexpr int BK = 64;   // contraction per step: one nf4 block
constexpr int NT = 256;  // threads per block

// The reference's NF4_CODE, as double literals rounded to float (the same
// conversion numpy makes).
__constant__ float kNf4Code[16] = {
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0};

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared-memory row pitch in elements: rows stay 16-byte aligned, and the
// bf16 fragment loads (rows g, 32-bit words t) hit 32 distinct banks.
template <typename T>
struct Pitch;
template <>
struct Pitch<__nv_bfloat16> { static constexpr int P = BK + 8; };
template <>
struct Pitch<float> { static constexpr int P = BK + 4; };

// ----------------------------------------------------------- operand A
// x or g [M, Kc] row-major; Kc % (16 / sizeof(T)) == 0.
template <typename T>
struct ALoad {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int PER_ROW = BK / VEC;
  static constexpr int N = BM * PER_ROW / NT;
  uint4 r[N];

  __device__ __forceinline__ void load(const T* __restrict__ a, int M, int Kc,
                                       int m0, int k0) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int u = threadIdx.x + i * NT;
      const int m = m0 + u / PER_ROW, k = k0 + (u % PER_ROW) * VEC;
      r[i] = (m < M && k < Kc)
                 ? *reinterpret_cast<const uint4*>(a + (size_t)m * Kc + k)
                 : make_uint4(0, 0, 0, 0);
    }
  }
  __device__ __forceinline__ void store(T* As) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int u = threadIdx.x + i * NT;
      *reinterpret_cast<uint4*>(As + (u / PER_ROW) * Pitch<T>::P +
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
  template <typename T>
  __device__ __forceinline__ void store(const Regs& r, T* Bs,
                                        const float* code) const {
    const int h = threadIdx.x & 1;
    T* dst = Bs + (threadIdx.x >> 1) * Pitch<T>::P + 16 * h;
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&r.bytes);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      dst[i] = from_f<T>(__fmul_rn(code[b[i] & 15], r.s));
      dst[32 + i] = from_f<T>(__fmul_rn(code[b[i] >> 4], r.s));
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
  template <typename T>
  __device__ __forceinline__ void store(const Regs& r, T* Bs,
                                        const float* code) const {
    constexpr int P = Pitch<T>::P;
    const int cl = threadIdx.x >> 2;
    const int j = ((threadIdx.x >> 1) & 1) * BK + (threadIdx.x & 1) * 16;
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&r.bytes);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      Bs[(j + i) * P + cl] = from_f<T>(__fmul_rn(code[b[i] & 15], r.s));
      Bs[(j + 32 + i) * P + cl] = from_f<T>(__fmul_rn(code[b[i] >> 4], r.s));
    }
  }
};

// K6: q [K, N] int8 rows; a tile is 64 rows x 128 bytes, two uint4 per
// thread, staged transposed (int8 -> T is exact).
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
  template <typename T>
  __device__ __forceinline__ void store(const Regs& r, T* Bs,
                                        const float*) const {
    constexpr int P = Pitch<T>::P;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int u = threadIdx.x + i * NT;
      const int kl = u >> 3, nl = (u & 7) * 16;
      const int8_t* b = reinterpret_cast<const int8_t*>(&r.bytes[i]);
#pragma unroll
      for (int e = 0; e < 16; ++e)
        Bs[(nl + e) * P + kl] = from_f<T>((float)b[e]);
    }
  }
};

// ------------------------------------------------------------- products
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <typename T>
__device__ __forceinline__ void put(T* out, const float* colscale, int M,
                                    int N, int row, int col, float v) {
  if (row < M && col < N) {
    if (colscale) v = __fmul_rn(v, colscale[col]);
    out[(size_t)row * N + col] = from_f<T>(v);
  }
}

// bf16: 8 warps as 2 (rows) x 4 (columns), each 64 x 32 with
// mma.sync.m16n8k16.
struct MmaAcc {
  float c[4][4][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[i][j][e] = 0.f;
  }
  __device__ __forceinline__ void step(const __nv_bfloat16* As,
                                       const __nv_bfloat16* Bs) {
    constexpr int P = Pitch<__nv_bfloat16>::P;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat16* p = As + (wm + i * 16 + g) * P + ks + 2 * t;
        a[i][0] = ld32(p);
        a[i][1] = ld32(p + 8 * P);
        a[i][2] = ld32(p + 8);
        a[i][3] = ld32(p + 8 * P + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat16* p = Bs + (wn + j * 8 + g) * P + ks + 2 * t;
        b[j][0] = ld32(p);
        b[j][1] = ld32(p + 8);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          asm volatile(
              "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
              "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
              : "+f"(c[i][j][0]), "+f"(c[i][j][1]), "+f"(c[i][j][2]),
                "+f"(c[i][j][3])
              : "r"(a[i][0]), "r"(a[i][1]), "r"(a[i][2]), "r"(a[i][3]),
                "r"(b[j][0]), "r"(b[j][1]));
    }
  }
  __device__ __forceinline__ void store(__nv_bfloat16* out,
                                        const float* colscale, int M, int N,
                                        int m0, int n0) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = m0 + (warp >> 2) * 64, wn = n0 + (warp & 3) * 32;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = wm + i * 16 + g, col = wn + j * 8 + 2 * t;
        put(out, colscale, M, N, row, col, c[i][j][0]);
        put(out, colscale, M, N, row, col + 1, c[i][j][1]);
        put(out, colscale, M, N, row + 8, col, c[i][j][2]);
        put(out, colscale, M, N, row + 8, col + 1, c[i][j][3]);
      }
  }
};

// f32: 16 x 16 threads, each rows ty + 16 i and columns tx + 16 j.
struct FmaAcc {
  float c[8][8];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) c[i][j] = 0.f;
  }
  __device__ __forceinline__ void step(const float* As, const float* Bs) {
    constexpr int P = Pitch<float>::P;
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

template <typename T>
struct AccOf { using type = MmaAcc; };
template <>
struct AccOf<float> { using type = FmaAcc; };

// out [M, Nout] = a [M, Kc] @ B, B staged tile by tile by Src.
template <typename T, class Src>
__global__ void __launch_bounds__(NT)
    qgemm(const T* __restrict__ a, Src src, T* __restrict__ out,
          const float* __restrict__ colscale, int M, int Nout, int Kc) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + BM * Pitch<T>::P;
  float* code = reinterpret_cast<float*>(Bs + BN * Pitch<T>::P);
  if (threadIdx.x < 16) code[threadIdx.x] = kNf4Code[threadIdx.x];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  ALoad<T> al;
  typename Src::Regs br;
  al.load(a, M, Kc, m0, 0);
  src.load(br, n0, 0);
  typename AccOf<T>::type acc;
  acc.zero();
  __syncthreads();  // the code table
  const int steps = (Kc + BK - 1) / BK;
  for (int s = 0; s < steps; ++s) {
    al.store(As);
    src.template store<T>(br, Bs, code);
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

template <typename T, class Src>
int launch(const void* a, const Src& src, void* out, const float* colscale,
           int M, int Nout, int Kc, cudaStream_t st) {
  if (M == 0 || Nout == 0) return 0;
  const int smem = (BM + BN) * Pitch<T>::P * (int)sizeof(T) + 16 * 4;
  static bool attr_set = false;  // once per instantiation
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        qgemm<T, Src>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid((Nout + BN - 1) / BN, (M + BM - 1) / BM);
  qgemm<T, Src><<<grid, NT, smem, st>>>(static_cast<const T*>(a), src,
                                         static_cast<T*>(out), colscale, M,
                                         Nout, Kc);
  return (int)cudaGetLastError();
}

}  // namespace

#define DTX_QUANT_ENTRIES(SUFFIX, T)                                          \
  extern "C" int dtx_nf4_matmul_##SUFFIX(                                     \
      const void* x, const uint8_t* packed, const int8_t* scale_q,            \
      const float* meta, void* out, int M, int K, int N, cudaStream_t st) {   \
    Nf4Fwd src{packed, scale_q, meta, N, K / BK};                             \
    return launch<T>(x, src, out, nullptr, M, N, K, st);                      \
  }                                                                           \
  extern "C" int dtx_nf4_matmul_t_##SUFFIX(                                   \
      const void* g, const uint8_t* packed, const int8_t* scale_q,            \
      const float* meta, void* dx, int M, int K, int N, cudaStream_t st) {    \
    Nf4T src{packed, scale_q, meta, N, K / BK};                               \
    return launch<T>(g, src, dx, nullptr, M, K, N, st);                       \
  }

DTX_QUANT_ENTRIES(bf16, __nv_bfloat16)
DTX_QUANT_ENTRIES(f32, float)

// K6 in f32 (the bf16 K6 is int8_gemm.cu's wgmma kernel)
extern "C" int dtx_int8_matmul_f32(const void* x, const int8_t* q,
                                   const float* scale, void* out, int M,
                                   int K, int N, cudaStream_t st) {
  Int8Src src{q, N, K};
  return launch<float>(x, src, out, scale, M, N, K, st);
}
