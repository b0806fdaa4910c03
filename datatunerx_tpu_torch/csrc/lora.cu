// Fused LoRA matmul (K10): y = x W + ((x A) -> x's dtype) B * scale.
//
// Replaces (TPU kernel):
//   K10  datatunerx_tpu/ops/pallas_lora.py::_lora_kernel
//        (entered via pallas_lora_matmul)
//
// Operands, all row-major in one dtype (bf16 or f32): x [M, K], W [K, N],
// A [K, r], B [r, N], r <= 64; out [M, N].
//
// Rounding points are the reference's: the base product x W and the strip
// xa = x A accumulate in f32; xa rounds once to the input dtype; the rank-r
// product xa B accumulates in f32 and is multiplied by scale in f32; the sum
// rounds once to the output. Kernel and plain version differ only in
// summation order.
//
// What bounds it on an H100: operations at the training shapes (M = 8192
// rows: 2*M*K*N flops for about 2*(M*K + K*N + M*N) bytes, far above the
// card's ops:byte ridge) and bytes at a decode step (M = 4: W is read once
// for four rows). The adapter adds 2*M*r*(K + N) flops, under 1 % at r = 8,
// and the point of the fusion is what it does NOT move: the [M, N] adapter
// delta and the [M, r] strip never reach device memory.
//
// What the design does about it (a first, simple version). The TPU kernel
// holds a whole [block_m, K] strip of x in VMEM; here a 256-thread block owns
// a 128 x 128 output tile and walks K in 64-wide steps. Each step stages the
// x tile, the W tile and A's [64, r] slice in shared memory (16-byte loads
// where rows allow; the next step's global loads go into registers ahead of
// this step's products) and accumulates BOTH the base tile and the [128, r] xa
// strip from the same staged x tile. After the last step the strip is rounded
// to the input dtype into shared memory, B's [r, 128] tile is staged, and the
// rank-r product is added, scaled, to the accumulators in registers.
// - bf16: 8 warps as 2 x 4, each a 64 x 32 sub-tile on mma.sync.m16n8k16
//   (bf16 in, f32 accumulate). W, A and B are all [contraction][column]
//   row-major, the transpose of what the tensor cores' B operand wants, so
//   their fragments come through ldmatrix.trans and nothing is transposed
//   while staging. Each warp also owns 16 rows of the xa strip. r is padded
//   with zeros to RP = 16, 32 or 64 (a whole number of k-steps).
// - f32: CUDA-core FMAs, 8 x 8 outputs per thread (serves tests).
// - Rows past M, columns past N, contraction past K and rank past r load as
//   zeros and are never stored; nothing is padded on the host. Rows that are
//   not whole 16-byte vectors (K or N off a multiple of 8 bf16 / 4 f32) are
//   loaded element by element.
// wgmma, TMA, a deeper pipeline and a split over K for the decode shape are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;  // rows per block
constexpr int BN = 128;  // output columns per block
constexpr int BK = 64;   // contraction per step
constexpr int NT = 256;  // threads per block

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// Row padding in elements: rows stay 16-byte aligned, and fragment loads of 8
// consecutive rows fall into distinct banks.
template <typename T>
struct Pad;
template <>
struct Pad<__nv_bfloat16> { static constexpr int P = 8; };
template <>
struct Pad<float> { static constexpr int P = 4; };

// A ROWS x COLS tile of a row-major [nrows, ncols] matrix at (r0, c0), as
// 16-byte vectors in registers; elements outside the matrix are zero.
template <typename T, int ROWS, int COLS>
struct TileLoad {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int PER_ROW = COLS / VEC;
  static constexpr int N = ROWS * PER_ROW / NT;
  uint4 r[N];

  __device__ __forceinline__ void load(const T* __restrict__ src, int nrows,
                                       int ncols, int r0, int c0, bool vec) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int u = threadIdx.x + i * NT;
      const int row = r0 + u / PER_ROW, col = c0 + (u % PER_ROW) * VEC;
      if (vec) {  // ncols % VEC == 0: a vector is inside or outside as a whole
        r[i] = (row < nrows && col < ncols)
                   ? *reinterpret_cast<const uint4*>(src + (size_t)row * ncols +
                                                     col)
                   : make_uint4(0, 0, 0, 0);
      } else {
        __align__(16) T tmp[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          tmp[e] = (row < nrows && col + e < ncols)
                       ? src[(size_t)row * ncols + col + e]
                       : from_f<T>(0.f);
        r[i] = *reinterpret_cast<const uint4*>(tmp);
      }
    }
  }
  __device__ __forceinline__ void store(T* dst, int pitch) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int u = threadIdx.x + i * NT;
      *reinterpret_cast<uint4*>(dst + (u / PER_ROW) * pitch +
                                (u % PER_ROW) * VEC) = r[i];
    }
  }
};

// A's [BK, RP] slice at row k0: rows of r elements need not be 16-byte
// aligned (r = 4 is 8 bytes of bf16), so it is loaded element by element.
template <typename T, int RP>
struct SliceLoad {
  static constexpr int N = BK * RP / NT;
  T v[N];

  __device__ __forceinline__ void load(const T* __restrict__ a, int K, int r,
                                       int k0) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int u = threadIdx.x + i * NT;
      const int row = k0 + u / RP, col = u % RP;
      v[i] = (row < K && col < r) ? a[(size_t)row * r + col] : from_f<T>(0.f);
    }
  }
  __device__ __forceinline__ void store(T* dst) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int u = threadIdx.x + i * NT;
      dst[(u / RP) * (RP + Pad<T>::P) + u % RP] = v[i];
    }
  }
};

// B's [RP, BN] tile at column n0, straight into shared memory (once per
// block); rank rows past r and columns past N are zero.
template <typename T, int RP>
__device__ __forceinline__ void stage_b(const T* __restrict__ b, T* Bs, int N,
                                        int r, int n0) {
  for (int u = threadIdx.x; u < RP * BN; u += NT) {
    const int row = u / BN, col = u % BN;
    Bs[row * (BN + Pad<T>::P) + col] =
        (row < r && n0 + col < N) ? b[(size_t)row * N + n0 + col]
                                  : from_f<T>(0.f);
  }
}

template <typename T>
__device__ __forceinline__ void put(T* out, int M, int N, int row, int col,
                                    float v) {
  if (row < M && col < N) out[(size_t)row * N + col] = from_f<T>(v);
}

// ---------------------------------------------------------------- bf16
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two 16 x 8 B-operand fragments (columns n..n+7 and n+8..n+15 of rows
// k..k+15) from a [contraction][column] row-major tile, transposed on load.
__device__ __forceinline__ void ldb_x4(const __nv_bfloat16* tile, int pitch,
                                       int k, int n, uint32_t* f) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* p = tile + (k + (lane & 15)) * pitch + n + (lane >> 4) * 8;
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(f[0]), "=r"(f[1]), "=r"(f[2]), "=r"(f[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A-operand fragment of rows row0 + g, row0 + g + 8 and columns
// k + 2t.. of a [row][contraction] tile.
__device__ __forceinline__ void lda(const __nv_bfloat16* tile, int pitch,
                                    int row0, int k, uint32_t* a) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* p = tile + (row0 + (lane >> 2)) * pitch + k +
                           2 * (lane & 3);
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * pitch);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * pitch + 8);
}

template <int RP>
struct MmaAcc {
  static constexpr int PX = BK + 8, PW = BN + 8, PA = RP + 8;
  float c[4][4][4];     // the warp's 64 x 32 of the base tile
  float xa[RP / 8][4];  // the warp's 16 rows of the xa strip

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[i][j][e] = 0.f;
#pragma unroll
    for (int j = 0; j < RP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) xa[j][e] = 0.f;
  }

  __device__ __forceinline__ void step(const __nv_bfloat16* Xs,
                                       const __nv_bfloat16* Ws,
                                       const __nv_bfloat16* As) {
    const int warp = threadIdx.x >> 5;
    const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t a[4][4], b[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) lda(Xs, PX, wm + i * 16, ks, a[i]);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) ldb_x4(Ws, PW, ks, wn + jp * 16, b[jp]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma16816(c[i][j], a[i], b[j >> 1][2 * (j & 1)],
                   b[j >> 1][2 * (j & 1) + 1]);
      uint32_t ax[4];
      lda(Xs, PX, warp * 16, ks, ax);
#pragma unroll
      for (int jp = 0; jp < RP / 16; ++jp) {
        uint32_t f[4];
        ldb_x4(As, PA, ks, jp * 16, f);
        mma16816(xa[2 * jp], ax, f[0], f[1]);
        mma16816(xa[2 * jp + 1], ax, f[2], f[3]);
      }
    }
  }

  // c += (round(xa) @ B) * scale; XAs and Bs reuse the x and W tiles.
  __device__ __forceinline__ void epilogue(__nv_bfloat16* XAs,
                                           __nv_bfloat16* Bs,
                                           const __nv_bfloat16* b, int N,
                                           int r, int n0, float scale) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < RP / 8; ++j) {
      __nv_bfloat16* p = XAs + (warp * 16 + g) * PA + j * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(p) =
          __floats2bfloat162_rn(xa[j][0], xa[j][1]);
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * PA) =
          __floats2bfloat162_rn(xa[j][2], xa[j][3]);
    }
    stage_b<__nv_bfloat16, RP>(b, Bs, N, r, n0);
    __syncthreads();
    const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float d[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < RP; ks += 16) {
        uint32_t a[4], f[2][4];
        lda(XAs, PA, wm + i * 16, ks, a);
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) ldb_x4(Bs, PW, ks, wn + jp * 16, f[jp]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma16816(d[j], a, f[j >> 1][2 * (j & 1)], f[j >> 1][2 * (j & 1) + 1]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          c[i][j][e] = __fadd_rn(c[i][j][e], __fmul_rn(d[j][e], scale));
    }
  }

  __device__ __forceinline__ void store(__nv_bfloat16* out, int M, int N,
                                        int m0, int n0) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = m0 + (warp >> 2) * 64, wn = n0 + (warp & 3) * 32;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = wm + i * 16 + g, col = wn + j * 8 + 2 * t;
        put(out, M, N, row, col, c[i][j][0]);
        put(out, M, N, row, col + 1, c[i][j][1]);
        put(out, M, N, row + 8, col, c[i][j][2]);
        put(out, M, N, row + 8, col + 1, c[i][j][3]);
      }
  }
};

// ----------------------------------------------------------------- f32
// 16 x 16 threads, each rows ty + 16 i and columns tx + 16 j of the base
// tile, and rows ty + 16 i, columns tx + 16 c of the xa strip.
template <int RP>
struct FmaAcc {
  static constexpr int PX = BK + 4, PW = BN + 4, PA = RP + 4;
  float c[8][8];
  float xa[8][RP / 16];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) c[i][j] = 0.f;
#pragma unroll
      for (int q = 0; q < RP / 16; ++q) xa[i][q] = 0.f;
    }
  }

  __device__ __forceinline__ void step(const float* Xs, const float* Ws,
                                       const float* As) {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[8], b[8], aa[RP / 16];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = Xs[(ty + 16 * i) * PX + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Ws[kk * PW + tx + 16 * j];
#pragma unroll
      for (int q = 0; q < RP / 16; ++q) aa[q] = As[kk * PA + tx + 16 * q];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
#pragma unroll
        for (int q = 0; q < RP / 16; ++q)
          xa[i][q] = fmaf(a[i], aa[q], xa[i][q]);
      }
    }
  }

  __device__ __forceinline__ void epilogue(float* XAs, float* Bs,
                                           const float* b, int N, int r,
                                           int n0, float scale) {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int q = 0; q < RP / 16; ++q)
        XAs[(ty + 16 * i) * PA + tx + 16 * q] = xa[i][q];
    stage_b<float, RP>(b, Bs, N, r, n0);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float d[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) d[j] = 0.f;
      for (int kk = 0; kk < RP; ++kk) {
        const float a = XAs[(ty + 16 * i) * PA + kk];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          d[j] = fmaf(a, Bs[kk * PW + tx + 16 * j], d[j]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
        c[i][j] = __fadd_rn(c[i][j], __fmul_rn(d[j], scale));
    }
  }

  __device__ __forceinline__ void store(float* out, int M, int N, int m0,
                                        int n0) const {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        put(out, M, N, m0 + ty + 16 * i, n0 + tx + 16 * j, c[i][j]);
  }
};

template <typename T, int RP>
struct AccOf { using type = MmaAcc<RP>; };
template <int RP>
struct AccOf<float, RP> { using type = FmaAcc<RP>; };

template <typename T, int RP>
__global__ void __launch_bounds__(NT)
    lora_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const T* __restrict__ a, const T* __restrict__ b,
                T* __restrict__ out, int M, int K, int N, int r, float scale,
                bool vec_x, bool vec_w) {
  using Acc = typename AccOf<T, RP>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Xs = reinterpret_cast<T*>(smem);  // [BM][PX]; later xa [BM][PA]
  T* Ws = Xs + BM * Acc::PX;           // [BK][PW]; later B [RP][PW]
  T* As = Ws + BK * Acc::PW;           // [BK][PA]

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  TileLoad<T, BM, BK> xl;
  TileLoad<T, BK, BN> wl;
  SliceLoad<T, RP> al;
  xl.load(x, M, K, m0, 0, vec_x);
  wl.load(w, K, N, 0, n0, vec_w);
  al.load(a, K, r, 0);
  Acc acc;
  acc.zero();
  const int steps = (K + BK - 1) / BK;
  for (int s = 0; s < steps; ++s) {
    xl.store(Xs, Acc::PX);
    wl.store(Ws, Acc::PW);
    al.store(As);
    __syncthreads();
    if (s + 1 < steps) {  // next step's loads fly during this step's math
      xl.load(x, M, K, m0, (s + 1) * BK, vec_x);
      wl.load(w, K, N, (s + 1) * BK, n0, vec_w);
      al.load(a, K, r, (s + 1) * BK);
    }
    acc.step(Xs, Ws, As);
    __syncthreads();
  }
  acc.epilogue(Xs, Ws, b, N, r, n0, scale);
  acc.store(out, M, N, m0, n0);
}

template <typename T, int RP>
int launch_rp(const void* x, const void* w, const void* a, const void* b,
              void* out, int M, int K, int N, int r, float scale,
              cudaStream_t st) {
  using Acc = typename AccOf<T, RP>::type;
  constexpr int VEC = 16 / (int)sizeof(T);
  const int smem =
      (BM * Acc::PX + BK * Acc::PW + BK * Acc::PA) * (int)sizeof(T);
  static bool attr_set = false;  // once per instantiation
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        lora_kernel<T, RP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const bool vec_x = K % VEC == 0 && (uintptr_t)x % 16 == 0;
  const bool vec_w = N % VEC == 0 && (uintptr_t)w % 16 == 0;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  lora_kernel<T, RP><<<grid, NT, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T*>(out), M, K, N, r, scale, vec_x, vec_w);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* w, const void* a, const void* b,
           void* out, int M, int K, int N, int r, float scale,
           cudaStream_t st) {
  if (M == 0 || N == 0) return 0;
  if (r < 1 || r > 64) return (int)cudaErrorInvalidValue;
  if (r <= 16) return launch_rp<T, 16>(x, w, a, b, out, M, K, N, r, scale, st);
  if (r <= 32) return launch_rp<T, 32>(x, w, a, b, out, M, K, N, r, scale, st);
  return launch_rp<T, 64>(x, w, a, b, out, M, K, N, r, scale, st);
}

}  // namespace

extern "C" int dtx_lora_matmul_bf16(const void* x, const void* w,
                                    const void* a, const void* b, void* out,
                                    int M, int K, int N, int r, float scale,
                                    void* stream) {
  return launch<__nv_bfloat16>(x, w, a, b, out, M, K, N, r, scale,
                               (cudaStream_t)stream);
}

extern "C" int dtx_lora_matmul_f32(const void* x, const void* w, const void* a,
                                   const void* b, void* out, int M, int K,
                                   int N, int r, float scale, void* stream) {
  return launch<float>(x, w, a, b, out, M, K, N, r, scale,
                       (cudaStream_t)stream);
}
