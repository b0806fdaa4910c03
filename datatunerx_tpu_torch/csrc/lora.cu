// Fused LoRA matmul (K10): y = x W + ((x A) -> x's dtype) B * scale, for few
// rows (a decode step, bf16 and f32) and for many rows in f32. Many bf16 rows
// run on lora_gemm.cu's TMA + wgmma kernel; the wrapper's _route picks.
//
// Replaces (TPU kernel):
//   K10  datatunerx_tpu/ops/pallas_lora.py::_lora_kernel
//        (entered via pallas_lora_matmul)
//
// Operands, all row-major in one dtype (bf16 or f32): x [M, K], W [K, N],
// A [K, r], B [r, N], r <= 64; out [M, N].
//
// Rounding points are the reference's: the base product x W and the strip
// xa = x A accumulate in f32; xa rounds once to the input dtype, after the
// whole K sum; the rank-r product xa B accumulates in f32 and is multiplied
// by scale in f32 (__fmul_rn); the sum (__fadd_rn) rounds once to the output.
// Kernel and plain version differ only in summation order.
//
// 1. Few rows: lora_split_kernel, a split over K in a thread-block cluster.
//    What bounds it on an H100: bytes. At M = 4 rows W is read once for 4
//    FMAs a weight (q_proj's 8 MB: 2.5 us at 3.35 TB/s), so the whole card
//    has to stream it; a grid of output-column tiles alone puts 16 blocks of
//    q_proj (2 of v_proj) on 132 SMs.
//    What the design does about it: the grid is S splits of K (S <= 16) x
//    column tiles of BN = CV 16-byte vectors, and each column tile's S
//    blocks form one cluster (above 8 non-portable, which the H100 allows).
//    The wrapper picks S and CV (_split_plan, measured on the card). A
//    256-thread block copies its [K / S, BN] piece of W into shared memory,
//    stages x's [M, K / S], A's [K / S, r] and B's [r, BN] slices there as
//    f32, sums its f32 partial of xa over the slice, and then its partial of
//    the base tile, 4 rows of x a pass (thread = (k row, column vector), CV
//    16-byte vectors wide).
//    The threads of a column vector sum their partials across the warp
//    (butterfly shuffles) and across the 8 warps in warp order, and push each
//    sum into the split that merges that output (a 1/S share of the tile's
//    outputs each), as each split pushes its xa partial into every split,
//    through distributed shared memory: one cluster barrier, no remote load.
//    Each split then sums xa in split order and rounds it once, and merges
//    its outputs: the base partials in split order, plus xa times B's
//    [r, BN] slice (staged at the start), scaled, added, rounded and stored.
//    W's piece comes into shared memory by TMA (one [K / S, BN] box, issued
//    first; loaded into registers instead, the loads sank to their uses and
//    waited out one latency a row, and 16-byte cp.async copies took 2 us to
//    issue). CUDA cores are enough: 4 FMAs a weight loaded.
// 2. Many rows, f32: lora_tile_kernel, a 256-thread block a 128 x 128 output
//    tile walking K in 64-wide steps: each step stages the x tile, the W tile
//    and A's [64, r] slice in shared memory (the next step's global loads go
//    into registers ahead of this step's products) and accumulates BOTH the
//    base tile and the [128, r] xa strip from the same staged x tile, 8 x 8
//    outputs a thread on CUDA-core FMAs. After the last step the strip is
//    rounded into shared memory, B's [r, 128] tile is staged, and the rank-r
//    product is added, scaled. No model path runs it (training is bf16).
// Rows past M, columns past N, contraction past K and rank past r load as
// zeros and are never stored. The split kernel needs N % (16 / sizeof(T))
// == 0 and 16-byte-aligned W (the wrapper pads N otherwise).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "wgmma_sm90.cuh"

namespace {

namespace cg = cooperative_groups;

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ------------------------------------------------------- 1. split over K
constexpr int SNT = 256;           // threads a split block
constexpr int SWARPS = SNT / 32;
constexpr int MG = 4;              // rows of x a pass over W's piece
constexpr int SPLIT_MAX_M = 64;    // rows the split kernel takes
constexpr int SPLIT_MAX_S = 16;    // blocks a cluster
// dynamic shared bytes a split block may take: the H100's 227 KB a block,
// less 1 KB for its static barrier (the wrapper's plan holds the same limit)
constexpr int SPLIT_SMEM_MAX = 232448 - 1024;

// The split block's shared memory: W's piece in T first, then floats.
struct SplitSmem {
  int mp, ks, bn, mr, kp, share;  // rows padded to MG, K / S, BN, M r, xa
                                  // k parts, outputs a split merges
  int boxr, wbytes;  // rows of a TMA box of W; W's piece [boxes][boxr][bn]
  int xs, as, bs, xpp, xag, gath, red, total;  // offsets in floats
  __host__ __device__ SplitSmem(int M, int K, int r, int S, int bn_,
                                int tsize) {
    mp = (M + MG - 1) / MG * MG;
    ks = (K + S - 1) / S;
    bn = bn_;
    mr = M * r;
    kp = mr < SNT ? SNT / mr : 1;
    share = (M * bn + S - 1) / S;
    boxr = ks < 256 ? ks : 256;
    wbytes = (ks + boxr - 1) / boxr * boxr * bn * tsize;
    xs = wbytes / 4;             // x slice [mp][ks]; later merged xa [M][r]
    as = xs + mp * ks;           // A slice [ks][r]
    bs = as + ks * r;            // B's [r][bn] columns of this tile
    xpp = bs + r * bn;           // xa partials of the k parts [kp][M r]
    xag = xpp + kp * mr;         // every split's xa partial [S][M r]
    gath = xag + S * mr;         // every split's partial of this split's
                                 // share of the outputs [S][share]
    red = gath + S * share;      // the warps' partials [SWARPS][MG][bn]
    total = red + SWARPS * MG * bn;
  }
};

// da[u] = fa(u) for u < na, db[u] = fb(u) for u < nb and dc[u] = fc(u) for
// u < nc, the block's threads 4 values of each at a time: the 12 loads of a
// round are in flight together (a loop of load-then-store waits out one
// load's latency per element).
template <typename FA, typename FB, typename FC>
__device__ __forceinline__ void stage3(float* da, int na, FA fa, float* db,
                                       int nb, FB fb, float* dc, int nc,
                                       FC fc) {
  constexpr int B = 4;
  const int n = max(na, max(nb, nc));
  for (int u0 = threadIdx.x; u0 < n; u0 += SNT * B) {
    float va[B], vb[B], vc[B];
#pragma unroll
    for (int i = 0; i < B; ++i) {
      const int u = u0 + i * SNT;
      va[i] = u < na ? fa(u) : 0.f;
      vb[i] = u < nb ? fb(u) : 0.f;
      vc[i] = u < nc ? fc(u) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < B; ++i) {
      const int u = u0 + i * SNT;
      if (u < na) da[u] = va[i];
      if (u < nb) db[u] = vb[i];
      if (u < nc) dc[u] = vc[i];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(SNT)
    lora_split_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const T* __restrict__ a, const T* __restrict__ b,
                      T* __restrict__ out, int M, int K, int N, int r,
                      float scale, int S, int CV,
                      const __grid_constant__ CUtensorMap tmw) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(128) float fsm[];
  __shared__ __align__(8) uint64_t wbar;
  cg::cluster_group cluster = cg::this_cluster();
  // every block of the cluster has started before anything is pushed into
  // it: arrive now, wait before the first push
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int sp = (int)cluster.block_rank();  // the split: blockIdx.x
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const SplitSmem L(M, K, r, S, CV * VEC, (int)sizeof(T));
  const int n0 = blockIdx.y * L.bn;
  const int k0 = min(K, sp * L.ks), nk = min(K, k0 + L.ks) - k0;
  float* xs = fsm + L.xs;
  float* as = fsm + L.as;
  float* bs = fsm + L.bs;

  // W's [ks, BN] piece into shared memory by TMA, issued before anything
  // else (zeros past K and N; rows past this split's are never read)
  const uint32_t wb = dtx_sm90::smem_u32(&wbar);
  if (tid == 0) {
    dtx_sm90::mbar_init(wb, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    dtx_sm90::mbar_expect_tx(wb, L.wbytes);
    const uint32_t ws = dtx_sm90::smem_u32(fsm);
    for (int c = 0; c * L.boxr < L.ks; ++c)
      dtx_sm90::tma_load(ws + c * L.boxr * L.bn * (int)sizeof(T), &tmw, wb,
                         n0, sp * L.ks + c * L.boxr);
  }

  // x's [M, nk], A's [nk, r] and B's [r, BN] slices as f32; rows past M and
  // columns past N are zeros
  stage3(
      xs, L.mp * L.ks,
      [&](int u) {
        const int m = u / L.ks, kk = u % L.ks;
        return m < M && kk < nk ? to_f(x[(size_t)m * K + k0 + kk]) : 0.f;
      },
      as, nk * r, [&](int u) { return to_f(a[(size_t)k0 * r + u]); }, bs,
      r * L.bn, [&](int u) {
        const int j = u / L.bn, c = n0 + u % L.bn;
        return c < N ? to_f(b[(size_t)j * N + c]) : 0.f;
      });
  __syncthreads();

  // this split's xa partial over kp consecutive k ranges, summed in order,
  // then pushed into every split of the cluster
  {
    const int len = (nk + L.kp - 1) / L.kp;
    for (int u = tid; u < L.kp * L.mr; u += SNT) {
      const int o = u % L.mr, p = u / L.mr, m = o / r, j = o % r;
      const int lo = min(nk, p * len), hi = min(nk, lo + len);
      float s = 0.f;
      for (int kk = lo; kk < hi; ++kk)
        s = fmaf(xs[m * L.ks + kk], as[kk * r + j], s);
      fsm[L.xpp + u] = s;
    }
    __syncthreads();
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    for (int u = tid; u < S * L.mr; u += SNT) {
      const int o = u % L.mr, q = u / L.mr;
      float s = 0.f;
      for (int p = 0; p < L.kp; ++p) s += fsm[L.xpp + p * L.mr + o];
      cluster.map_shared_rank(fsm, q)[L.xag + sp * L.mr + o] = s;
    }
  }

  // this split's base partial, MG rows of x a pass: thread = (k row kr,
  // column vector cv) reads rows kr, kr + KT, ... of W's piece; each output
  // goes to the split that merges it
  dtx_sm90::mbar_wait(wb, 0);
  const uint4* wv4 = reinterpret_cast<const uint4*>(fsm);
  const int cv = tid % CV, kr = tid / CV, KT = SNT / CV;
  for (int g0 = 0; g0 < L.mp; g0 += MG) {
    float acc[MG][VEC];
#pragma unroll
    for (int m = 0; m < MG; ++m)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[m][e] = 0.f;
#pragma unroll 4
    for (int kk = kr; kk < nk; kk += KT) {
      const uint4 raw = wv4[kk * CV + cv];
      const T* wv = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int m = 0; m < MG; ++m) {
        const float xv = xs[(g0 + m) * L.ks + kk];
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[m][e] = fmaf(xv, to_f(wv[e]), acc[m][e]);
      }
    }
    // lanes of one column vector (lane % CV) across the warp, then warps
    for (int off = CV; off < 32; off <<= 1)
#pragma unroll
      for (int m = 0; m < MG; ++m)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[m][e] += __shfl_xor_sync(0xffffffffu, acc[m][e], off);
    if (lane < CV)
#pragma unroll
      for (int m = 0; m < MG; ++m)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          fsm[L.red + (warp * MG + m) * L.bn + cv * VEC + e] = acc[m][e];
    __syncthreads();
    for (int o = tid; o < MG * L.bn; o += SNT) {
      const int og = g0 * L.bn + o;  // output (g0 + o / bn, o % bn)
      if (og >= M * L.bn) break;
      float s = 0.f;
      for (int q = 0; q < SWARPS; ++q) s += fsm[L.red + q * MG * L.bn + o];
      const int q = og / L.share;
      cluster.map_shared_rank(fsm, q)[L.gath + sp * L.share + og -
                                      q * L.share] = s;
    }
    __syncthreads();
  }
  cluster.sync();  // every split's pushes have landed

  // xa: the splits' partials in split order, rounded once (into xs); then
  // this split's share of the outputs: the splits' partials in split order
  // plus xa B * scale, rounded once
  for (int o = tid; o < L.mr; o += SNT) {
    float s = 0.f;
    for (int q = 0; q < S; ++q) s += fsm[L.xag + q * L.mr + o];
    xs[o] = to_f(from_f<T>(s));
  }
  __syncthreads();
  for (int i = tid; i < L.share; i += SNT) {
    const int og = sp * L.share + i;
    if (og >= M * L.bn) break;
    const int m = og / L.bn, c = og % L.bn;
    float s = 0.f;
    for (int q = 0; q < S; ++q) s += fsm[L.gath + q * L.share + i];
    float d = 0.f;
    for (int j = 0; j < r; ++j) d = fmaf(xs[m * r + j], bs[j * L.bn + c], d);
    if (n0 + c < N)
      out[(size_t)m * N + n0 + c] =
          from_f<T>(__fadd_rn(s, __fmul_rn(d, scale)));
  }
}

template <typename T>
int launch_split(const void* x, const void* w, const void* a, const void* b,
                 void* out, int M, int K, int N, int r, float scale, int S,
                 int CV, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  if (M > SPLIT_MAX_M || S < 1 || S > SPLIT_MAX_S || CV < 1 || CV > 16 ||
      16 % CV || N % VEC || (uintptr_t)w % 16)
    return (int)cudaErrorInvalidValue;
  const SplitSmem L(M, K, r, S, CV * VEC, (int)sizeof(T));
  const size_t smem = (size_t)L.total * sizeof(float);
  if (smem > SPLIT_SMEM_MAX) return (int)cudaErrorInvalidValue;
  const dtx_sm90::EncodeTiled enc = dtx_sm90::encoder();
  if (!enc) return (int)cudaErrorNotSupported;
  CUtensorMap mw;
  if (!dtx_sm90::tensor_map(
          enc, &mw,
          sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                         : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
          w, N, K, (uint64_t)N * sizeof(T), L.bn, L.boxr,
          CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  auto kern = lora_split_kernel<T>;
  if (int e = (int)cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
    return e;
  if (S > 8)
    if (int e = (int)cudaFuncSetAttribute(
            kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1))
      return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, (N + CV * VEC - 1) / (CV * VEC));
  cfg.blockDim = dim3(SNT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (int e = (int)cudaLaunchKernelEx(
          &cfg, kern, static_cast<const T*>(x), static_cast<const T*>(w),
          static_cast<const T*>(a), static_cast<const T*>(b),
          static_cast<T*>(out), M, K, N, r, scale, S, CV, mw))
    return e;
  return (int)cudaGetLastError();
}

// ------------------------------------------------- 2. many rows, f32 tiles
constexpr int BM = 128;  // rows per block
constexpr int BN = 128;  // output columns per block
constexpr int BK = 64;   // contraction per step
constexpr int NT = 256;  // threads per block

// A ROWS x COLS tile of a row-major [nrows, ncols] matrix at (r0, c0), as
// 16-byte vectors in registers; elements outside the matrix are zero.
template <int ROWS, int COLS>
struct TileLoad {
  static constexpr int VEC = 4;
  static constexpr int PER_ROW = COLS / VEC;
  static constexpr int N = ROWS * PER_ROW / NT;
  uint4 r[N];

  __device__ __forceinline__ void load(const float* __restrict__ src,
                                       int nrows, int ncols, int r0, int c0,
                                       bool vec) {
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
        __align__(16) float tmp[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          tmp[e] = (row < nrows && col + e < ncols)
                       ? src[(size_t)row * ncols + col + e]
                       : 0.f;
        r[i] = *reinterpret_cast<const uint4*>(tmp);
      }
    }
  }
  __device__ __forceinline__ void store(float* dst, int pitch) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int u = threadIdx.x + i * NT;
      *reinterpret_cast<uint4*>(dst + (u / PER_ROW) * pitch +
                                (u % PER_ROW) * VEC) = r[i];
    }
  }
};

// 16 x 16 threads, each rows ty + 16 i and columns tx + 16 j of the base
// tile, and rows ty + 16 i, columns tx + 16 c of the xa strip; r is padded
// with zeros to RP = 16, 32 or 64.
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

  // c += (xa @ B) * scale; XAs and Bs reuse the x and W tiles.
  __device__ __forceinline__ void epilogue(float* XAs, float* Bs,
                                           const float* b, int N, int r,
                                           int n0, float scale) {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int q = 0; q < RP / 16; ++q)
        XAs[(ty + 16 * i) * PA + tx + 16 * q] = xa[i][q];
    for (int u = threadIdx.x; u < RP * BN; u += NT) {
      const int row = u / BN, col = u % BN;
      Bs[row * PW + col] =
          (row < r && n0 + col < N) ? b[(size_t)row * N + n0 + col] : 0.f;
    }
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
      for (int j = 0; j < 8; ++j) {
        const int row = m0 + ty + 16 * i, col = n0 + tx + 16 * j;
        if (row < M && col < N) out[(size_t)row * N + col] = c[i][j];
      }
  }
};

template <int RP>
__global__ void __launch_bounds__(NT)
    lora_tile_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ a, const float* __restrict__ b,
                     float* __restrict__ out, int M, int K, int N, int r,
                     float scale, bool vec_x, bool vec_w) {
  using Acc = FmaAcc<RP>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Xs = reinterpret_cast<float*>(smem);  // [BM][PX]; later xa [BM][PA]
  float* Ws = Xs + BM * Acc::PX;               // [BK][PW]; later B [RP][PW]
  float* As = Ws + BK * Acc::PW;               // [BK][PA]

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  TileLoad<BM, BK> xl;
  TileLoad<BK, BN> wl;
  constexpr int NA = BK * RP / NT;  // A's [BK, RP] slice, element by element
  float al[NA];
  auto load_a = [&](int k0) {
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int u = threadIdx.x + i * NT, row = k0 + u / RP, col = u % RP;
      al[i] = (row < K && col < r) ? a[(size_t)row * r + col] : 0.f;
    }
  };
  xl.load(x, M, K, m0, 0, vec_x);
  wl.load(w, K, N, 0, n0, vec_w);
  load_a(0);
  Acc acc;
  acc.zero();
  const int steps = (K + BK - 1) / BK;
  for (int s = 0; s < steps; ++s) {
    xl.store(Xs, Acc::PX);
    wl.store(Ws, Acc::PW);
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int u = threadIdx.x + i * NT;
      As[(u / RP) * Acc::PA + u % RP] = al[i];
    }
    __syncthreads();
    if (s + 1 < steps) {  // next step's loads fly during this step's math
      xl.load(x, M, K, m0, (s + 1) * BK, vec_x);
      wl.load(w, K, N, (s + 1) * BK, n0, vec_w);
      load_a((s + 1) * BK);
    }
    acc.step(Xs, Ws, As);
    __syncthreads();
  }
  acc.epilogue(Xs, Ws, b, N, r, n0, scale);
  acc.store(out, M, N, m0, n0);
}

template <int RP>
int launch_tiles(const void* x, const void* w, const void* a, const void* b,
                 void* out, int M, int K, int N, int r, float scale,
                 cudaStream_t st) {
  using Acc = FmaAcc<RP>;
  const int smem =
      (BM * Acc::PX + BK * Acc::PW + BK * Acc::PA) * (int)sizeof(float);
  static bool attr_set = false;  // once per instantiation
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        lora_tile_kernel<RP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const bool vec_x = K % 4 == 0 && (uintptr_t)x % 16 == 0;
  const bool vec_w = N % 4 == 0 && (uintptr_t)w % 16 == 0;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  lora_tile_kernel<RP><<<grid, NT, smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(out), M, K, N, r, scale, vec_x, vec_w);
  return (int)cudaGetLastError();
}

// at q_proj's decode step: M = 4, K = 2048, r = 8, S splits, CV = 16
template <typename T>
int split_resources(int S, int* out) {
  cudaFuncAttributes fa;
  if (int e = (int)cudaFuncGetAttributes(&fa, lora_split_kernel<T>)) return e;
  const SplitSmem L(4, 2048, 8, S, 16 * (16 / (int)sizeof(T)),
                    (int)sizeof(T));
  const int smem = L.total * (int)sizeof(float);
  if (int e = (int)cudaFuncSetAttribute(
          lora_split_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem))
    return e;
  int blocks = 0;
  if (int e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, lora_split_kernel<T>, SNT, smem))
    return e;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = smem;
  out[3] = blocks;
  return 0;
}

}  // namespace

// The few-row K10: M <= 64 rows, S splits of K (one cluster), CV 16-byte
// column vectors a block; N % (16 / element size) == 0, W 16-byte aligned.
extern "C" int dtx_lora_split_bf16(const void* x, const void* w,
                                   const void* a, const void* b, void* out,
                                   int M, int K, int N, int r, float scale,
                                   int S, int CV, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (K < 1 || r < 1 || r > 64) return (int)cudaErrorInvalidValue;
  return launch_split<__nv_bfloat16>(x, w, a, b, out, M, K, N, r, scale, S,
                                     CV, (cudaStream_t)stream);
}

extern "C" int dtx_lora_split_f32(const void* x, const void* w, const void* a,
                                  const void* b, void* out, int M, int K,
                                  int N, int r, float scale, int S, int CV,
                                  void* stream) {
  if (M == 0 || N == 0) return 0;
  if (K < 1 || r < 1 || r > 64) return (int)cudaErrorInvalidValue;
  return launch_split<float>(x, w, a, b, out, M, K, N, r, scale, S, CV,
                             (cudaStream_t)stream);
}

// The many-row f32 K10.
extern "C" int dtx_lora_matmul_f32(const void* x, const void* w, const void* a,
                                   const void* b, void* out, int M, int K,
                                   int N, int r, float scale, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (K < 1 || r < 1 || r > 64) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (r <= 16) return launch_tiles<16>(x, w, a, b, out, M, K, N, r, scale, st);
  if (r <= 32) return launch_tiles<32>(x, w, a, b, out, M, K, N, r, scale, st);
  return launch_tiles<64>(x, w, a, b, out, M, K, N, r, scale, st);
}

// Dynamic shared bytes of a split block (the wrapper's _split_smem mirrors
// this; the card tests hold the two equal).
extern "C" int dtx_lora_split_smem(int M, int K, int r, int S, int bn,
                                   int tsize) {
  return SplitSmem(M, K, r, S, bn, tsize).total * (int)sizeof(float);
}

// What the split K10 takes of an SM at q_proj's decode step (as the wrapper
// plans it: 16 splits in bf16, 8 in f32): registers, local (spill) bytes per
// thread, dynamic shared bytes per block, resident blocks per SM; out[0..3]
// bf16, out[4..7] f32.
extern "C" int dtx_lora_split_resources(int* out) {
  if (int e = split_resources<__nv_bfloat16>(16, out)) return e;
  return split_resources<float>(8, out + 4);
}
