// Flash attention for training: forward (K1) and the two backward kernels
// (K2: dQ, K3: dK/dV), causal or full, with packed-segment masking and GQA.
//
// Replaces (TPU kernels):
//   K1  datatunerx_tpu/ops/flash_attention.py::_fwd_kernel      (via _fwd)
//   K2  datatunerx_tpu/ops/flash_attention.py::_bwd_dq_kernel   (via _bwd)
//   K3  datatunerx_tpu/ops/flash_attention.py::_bwd_dkv_kernel  (via _bwd)
//
// Layouts are the model's own, read in place through strides: q, o, dO, dQ
// [B, T, H, d]; k, v, dK, dV [B, S, KV, d]; lse and D = rowsum(dO * O)
// [B*H, T] f32; segment ids [B, T] / [B, S] int32 (null = one segment).
// Query head h reads KV head h / (H / KV): GQA without a repeat.
//
// What bounds them on an H100: operations. At the training shapes (T = 1024,
// d = 64) each query/key tile pair does 2*64*64*d FMAs for every 4*64*d
// bytes it stages, far above the card's ops:byte ridge. These first
// versions run the products on CUDA cores in f32 (f32 accumulation, as the
// reference's preferred_element_type), so their ceiling is the 67 TFLOP/s
// f32 rate, not the 989 TFLOP/s bf16 tensor-core rate the bound is stated
// against; mma/wgmma tiles are later work.
//
// What the design does about it:
// - The TPU's sequential grid axis becomes a loop inside one block: K1 and
//   K2 give a block 64 query rows of one (batch, head) and loop over 64-key
//   tiles, carrying the online-softmax max/normaliser (K1) or the dQ sum
//   (K2) in registers; K3 gives a block 64 key rows of one (batch, KV head)
//   and loops over the G query heads of its group and their query tiles, so
//   the GQA group sum of dK/dV happens in registers (no repeat of K/V, no
//   atomics, one rounding at the end).
// - The causal skip is a loop bound (K1/K2: keys up to the tile's last row;
//   K3: query tiles from the key tile's first row), the element mask stays
//   for the diagonal tile.
// - Tiles are staged in shared memory as f32 with an odd row pitch (d + 1),
//   so column walks are free of bank conflicts; each thread owns a 4 x 4
//   register tile of the 64 x 64 score block and the matching rows of the
//   output, so row statistics stay in registers and row reductions are
//   16-lane shuffles.
// - Masked lanes give p = 0 explicitly, and rows keep the reference's finite
//   NEG_INF and the l >= 1e-30 clamp, so packed pad rows never produce NaN.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // query rows per tile
constexpr int BK = 64;   // key rows per tile
constexpr int NT = 256;  // threads per block: 16 x 16, each a 4 x 4 tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// sum / max over the 16 lanes that share a row (tx = lane & 15)
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Stage 64 rows of D elements (row r at src + r*ld) into s[r*(D+1) + c] as
// f32, 16 bytes per load; rows >= nvalid are zero.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(float* s, const T* src, long ld,
                                           int nvalid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = D / VEC;
  constexpr int LD = D + 1;
  for (int c = threadIdx.x; c < 64 * CPR; c += NT) {
    const int r = c / CPR, col = (c % CPR) * VEC;
    float vals[VEC];
    if (r < nvalid) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(src + (long)r * ld + col);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int x = 0; x < VEC; ++x) vals[x] = to_f(e[x]);
    } else {
#pragma unroll
      for (int x = 0; x < VEC; ++x) vals[x] = 0.f;
    }
#pragma unroll
    for (int x = 0; x < VEC; ++x) s[r * LD + col + x] = vals[x];
  }
}

// 64 segment ids starting at row `start` of a [B, n] table (0 if none)
__device__ __forceinline__ void stage_seg(int* s, const int* seg, long base,
                                          int start, int n) {
  if (threadIdx.x < 64) {
    const int r = start + threadIdx.x;
    s[threadIdx.x] = (seg != nullptr && r < n) ? seg[base + r] : 0;
  }
}

// ------------------------------------------------------------------- K1
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ qseg,
    const int* __restrict__ kseg, T* __restrict__ out,
    float* __restrict__ lse, int Tq, int S, int H, int KV, float scale,
    int causal) {
  constexpr int LD = D + 1, NJ = D / 16, PLD = BK + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;
  int* sQs = reinterpret_cast<int*>(sP + BQ * PLD);
  int* sKs = sQs + BQ;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest rows first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const long qld = (long)H * D, kld = (long)KV * D;
  const T* qb = q + ((long)b * Tq * H + h) * D;
  const T* kb = k + ((long)b * S * KV + kvh) * D;
  const T* vb = v + ((long)b * S * KV + kvh) * D;

  stage_rows<T, D>(sQ, qb + (long)q0 * qld, qld, min(BQ, Tq - q0));
  stage_seg(sQs, qseg, (long)b * Tq, q0, Tq);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NJ; ++c) acc[i][c] = 0.f;
  }

  const int kend = causal ? min(S, q0 + BQ) : S;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    const int nk = min(BK, S - k0);
    stage_rows<T, D>(sK, kb + (long)k0 * kld, kld, nk);
    stage_rows<T, D>(sV, vb + (long)k0 * kld, kld, nk);
    stage_seg(sKs, kseg, (long)b * S, k0, S);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int dd = 0; dd < D; ++dd) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(ty + 16 * i) * LD + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = sK[(tx + 16 * j) * LD + dd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, row = q0 + r;
      const int qs = sQs[r];
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        ok[j] = col < S && row < Tq && (!causal || col <= row) &&
                qs == sKs[tx + 16 * j];
        s[i][j] = ok[j] ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        sP[r * PLD + tx + 16 * j] = p;
      }
      rs = row_sum(rs);
      l[i] = l[i] * corr + rs;
#pragma unroll
      for (int c = 0; c < NJ; ++c) acc[i][c] *= corr;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float vv[NJ];
#pragma unroll
      for (int c = 0; c < NJ; ++c) vv[c] = sV[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = sP[(ty + 16 * i) * PLD + kk];
#pragma unroll
        for (int c = 0; c < NJ; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Tq) continue;
    const float lv = fmaxf(l[i], 1e-30f);
    T* o = out + (((long)b * Tq + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NJ; ++c) o[tx + 16 * c] = from_f<T>(acc[i][c] / lv);
    if (tx == 0) lse[(long)bh * Tq + row] = m[i] + logf(lv);
  }
}

// ------------------------------------------------------------------- K2
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    const int* __restrict__ qseg, const int* __restrict__ kseg,
    T* __restrict__ dq, int Tq, int S, int H, int KV, float scale,
    int causal) {
  constexpr int LD = D + 1, NJ = D / 16, PLD = BK + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sO = sQ + BQ * LD;
  float* sK = sO + BQ * LD;
  float* sV = sK + BK * LD;
  float* sS = sV + BK * LD;
  int* sQs = reinterpret_cast<int*>(sS + BQ * PLD);
  int* sKs = sQs + BQ;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const long qld = (long)H * D, kld = (long)KV * D;
  const long qoff = ((long)b * Tq * H + h) * D;
  const T* kb = k + ((long)b * S * KV + kvh) * D;
  const T* vb = v + ((long)b * S * KV + kvh) * D;

  const int nq = min(BQ, Tq - q0);
  stage_rows<T, D>(sQ, q + qoff + (long)q0 * qld, qld, nq);
  stage_rows<T, D>(sO, dout + qoff + (long)q0 * qld, qld, nq);
  stage_seg(sQs, qseg, (long)b * Tq, q0, Tq);

  float lr[4], dr[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    lr[i] = row < Tq ? lse[(long)bh * Tq + row] : 0.f;
    dr[i] = row < Tq ? dsum[(long)bh * Tq + row] : 0.f;
#pragma unroll
    for (int c = 0; c < NJ; ++c) acc[i][c] = 0.f;
  }

  const int kend = causal ? min(S, q0 + BQ) : S;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();
    const int nk = min(BK, S - k0);
    stage_rows<T, D>(sK, kb + (long)k0 * kld, kld, nk);
    stage_rows<T, D>(sV, vb + (long)k0 * kld, kld, nk);
    stage_seg(sKs, kseg, (long)b * S, k0, S);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      float a[4], o[4], bk[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = sQ[(ty + 16 * i) * LD + dd];
        o[i] = sO[(ty + 16 * i) * LD + dd];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bk[j] = sK[(tx + 16 * j) * LD + dd];
        bv[j] = sV[(tx + 16 * j) * LD + dd];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], bk[j], s[i][j]);
          dp[i][j] = fmaf(o[i], bv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, row = q0 + r;
      const int qs = sQs[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = col < S && row < Tq && (!causal || col <= row) &&
                        qs == sKs[tx + 16 * j];
        const float p = ok ? expf(s[i][j] * scale - lr[i]) : 0.f;
        sS[r * PLD + tx + 16 * j] = p * (dp[i][j] - dr[i]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float kv[NJ];
#pragma unroll
      for (int c = 0; c < NJ; ++c) kv[c] = sK[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = sS[(ty + 16 * i) * PLD + kk];
#pragma unroll
        for (int c = 0; c < NJ; ++c) acc[i][c] = fmaf(ds, kv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Tq) continue;
    T* o = dq + (((long)b * Tq + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NJ; ++c) o[tx + 16 * c] = from_f<T>(acc[i][c]);
  }
}

// ------------------------------------------------------------------- K3
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    const int* __restrict__ qseg, const int* __restrict__ kseg,
    T* __restrict__ dk, T* __restrict__ dv, int Tq, int S, int H, int KV,
    float scale, int causal) {
  constexpr int LD = D + 1, NJ = D / 16, PLD = BQ + 1;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * LD;
  float* sQ = sV + BK * LD;
  float* sO = sQ + BQ * LD;
  float* sP = sO + BQ * LD;  // P^T, then dS^T: [key][query]
  float* sL = sP + BK * PLD;
  float* sD = sL + BQ;
  int* sQs = reinterpret_cast<int*>(sD + BQ);
  int* sKs = sQs + BQ;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * BK;
  const int bkv = blockIdx.y, b = bkv / KV, kvh = bkv % KV;
  const int G = H / KV;
  const long qld = (long)H * D, kld = (long)KV * D;
  const long koff = ((long)b * S * KV + kvh) * D + (long)k0 * kld;

  stage_rows<T, D>(sK, k + koff, kld, min(BK, S - k0));
  stage_rows<T, D>(sV, v + koff, kld, min(BK, S - k0));
  stage_seg(sKs, kseg, (long)b * S, k0, S);

  float dka[4][NJ], dva[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NJ; ++c) dka[i][c] = dva[i][c] = 0.f;

  const int q_first = causal ? (k0 / BQ) * BQ : 0;
  for (int hh = 0; hh < G; ++hh) {
    const int h = kvh * G + hh;
    const long bh = (long)b * H + h;
    const long qoff = ((long)b * Tq * H + h) * D;
    for (int q0 = q_first; q0 < Tq; q0 += BQ) {
      __syncthreads();  // the previous tile's readers are done
      const int nq = min(BQ, Tq - q0);
      stage_rows<T, D>(sQ, q + qoff + (long)q0 * qld, qld, nq);
      stage_rows<T, D>(sO, dout + qoff + (long)q0 * qld, qld, nq);
      if (tid < BQ) {
        const bool in = tid < nq;
        sL[tid] = in ? lse[bh * Tq + q0 + tid] : 0.f;
        sD[tid] = in ? dsum[bh * Tq + q0 + tid] : 0.f;
      }
      stage_seg(sQs, qseg, (long)b * Tq, q0, Tq);
      __syncthreads();

      float st[4][4], dpt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
      for (int dd = 0; dd < D; ++dd) {
        float ak[4], av[4], bq[4], bo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ak[i] = sK[(ty + 16 * i) * LD + dd];
          av[i] = sV[(ty + 16 * i) * LD + dd];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bq[j] = sQ[(tx + 16 * j) * LD + dd];
          bo[j] = sO[(tx + 16 * j) * LD + dd];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            st[i][j] = fmaf(ak[i], bq[j], st[i][j]);
            dpt[i][j] = fmaf(av[i], bo[j], dpt[i][j]);
          }
      }

      float dst[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i, krow = k0 + r;
        const int ks = sKs[r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j, qrow = q0 + c;
          const bool ok = krow < S && qrow < Tq &&
                          (!causal || krow <= qrow) && ks == sQs[c];
          const float p = ok ? expf(st[i][j] * scale - sL[c]) : 0.f;
          dst[i][j] = p * (dpt[i][j] - sD[c]) * scale;
          sP[r * PLD + c] = p;
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int qq = 0; qq < BQ; ++qq) {
        float o[NJ];
#pragma unroll
        for (int c = 0; c < NJ; ++c) o[c] = sO[qq * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = sP[(ty + 16 * i) * PLD + qq];
#pragma unroll
          for (int c = 0; c < NJ; ++c) dva[i][c] = fmaf(p, o[c], dva[i][c]);
        }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sP[(ty + 16 * i) * PLD + tx + 16 * j] = dst[i][j];
      __syncthreads();
#pragma unroll 4
      for (int qq = 0; qq < BQ; ++qq) {
        float a[NJ];
#pragma unroll
        for (int c = 0; c < NJ; ++c) a[c] = sQ[qq * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float ds = sP[(ty + 16 * i) * PLD + qq];
#pragma unroll
          for (int c = 0; c < NJ; ++c) dka[i][c] = fmaf(ds, a[c], dka[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int krow = k0 + ty + 16 * i;
    if (krow >= S) continue;
    const long off = (((long)b * S + krow) * KV + kvh) * D;
#pragma unroll
    for (int c = 0; c < NJ; ++c) {
      dk[off + tx + 16 * c] = from_f<T>(dka[i][c]);
      dv[off + tx + 16 * c] = from_f<T>(dva[i][c]);
    }
  }
}

// ----------------------------------------------------------------- launch
template <typename K>
int set_smem(K kern, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, const int* qs,
               const int* ks, void* out, float* lse, int B, int Tq, int S,
               int H, int KV, int causal, float scale, cudaStream_t st) {
  const size_t smem = ((BQ + 2 * BK) * (D + 1) + BQ * (BK + 1)) * 4 +
                      (BQ + BK) * 4;
  auto kern = flash_fwd_kernel<T, D>;
  if (int e = set_smem(kern, smem)) return e;
  dim3 grid((Tq + BQ - 1) / BQ, B * H);
  kern<<<grid, NT, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, qs, ks, (T*)out, lse, Tq, S, H,
      KV, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* dsum, const int* qs,
              const int* ks, void* dq, int B, int Tq, int S, int H, int KV,
              int causal, float scale, cudaStream_t st) {
  const size_t smem = ((2 * BQ + 2 * BK) * (D + 1) + BQ * (BK + 1)) * 4 +
                      (BQ + BK) * 4;
  auto kern = flash_bwd_dq_kernel<T, D>;
  if (int e = set_smem(kern, smem)) return e;
  dim3 grid((Tq + BQ - 1) / BQ, B * H);
  kern<<<grid, NT, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dsum, qs,
      ks, (T*)dq, Tq, S, H, KV, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* dsum, const int* qs,
               const int* ks, void* dk, void* dv, int B, int Tq, int S,
               int H, int KV, int causal, float scale, cudaStream_t st) {
  const size_t smem = ((2 * BQ + 2 * BK) * (D + 1) + BK * (BQ + 1)) * 4 +
                      (3 * BQ + BK) * 4;
  auto kern = flash_bwd_dkv_kernel<T, D>;
  if (int e = set_smem(kern, smem)) return e;
  dim3 grid((S + BK - 1) / BK, B * KV);
  kern<<<grid, NT, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dsum, qs,
      ks, (T*)dk, (T*)dv, Tq, S, H, KV, scale, causal);
  return (int)cudaGetLastError();
}

// head dims the kernels are instantiated for (the wrapper checks first)
#define DTX_FLASH_DISPATCH(d, CALL)              \
  switch (d) {                                   \
    case 16: return CALL(16);                    \
    case 32: return CALL(32);                    \
    case 64: return CALL(64);                    \
    case 128: return CALL(128);                  \
    default: return (int)cudaErrorInvalidValue;  \
  }

#define FWD(D)                                                               \
  launch_fwd<T, D>(q, k, v, qs, ks, out, lse, B, Tq, S, H, KV, causal,       \
                   scale, st)
#define DQ(D)                                                                \
  launch_dq<T, D>(q, k, v, dout, lse, dsum, qs, ks, dq, B, Tq, S, H, KV,     \
                  causal, scale, st)
#define DKV(D)                                                               \
  launch_dkv<T, D>(q, k, v, dout, lse, dsum, qs, ks, dk, dv, B, Tq, S, H,    \
                   KV, causal, scale, st)

template <typename T>
int flash_fwd(const void* q, const void* k, const void* v, const int* qs,
              const int* ks, void* out, float* lse, int B, int Tq, int S,
              int H, int KV, int d, int causal, float scale,
              cudaStream_t st) {
  if (B * H == 0 || Tq == 0) return 0;
  DTX_FLASH_DISPATCH(d, FWD)
}

template <typename T>
int flash_dq(const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* dsum, const int* qs,
             const int* ks, void* dq, int B, int Tq, int S, int H, int KV,
             int d, int causal, float scale, cudaStream_t st) {
  if (B * H == 0 || Tq == 0) return 0;
  DTX_FLASH_DISPATCH(d, DQ)
}

template <typename T>
int flash_dkv(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* dsum, const int* qs,
              const int* ks, void* dk, void* dv, int B, int Tq, int S, int H,
              int KV, int d, int causal, float scale, cudaStream_t st) {
  if (B * KV == 0 || S == 0) return 0;
  DTX_FLASH_DISPATCH(d, DKV)
}

#undef FWD
#undef DQ
#undef DKV
#undef DTX_FLASH_DISPATCH

}  // namespace

// C entry points; each returns the launch's cudaError_t (0 = launched).
#define DTX_FLASH_ENTRIES(SUFFIX, T)                                          \
  extern "C" int dtx_flash_fwd_##SUFFIX(                                      \
      const void* q, const void* k, const void* v, const int* qs,             \
      const int* ks, void* out, float* lse, int B, int Tq, int S, int H,      \
      int KV, int d, int causal, float scale, cudaStream_t st) {              \
    return flash_fwd<T>(q, k, v, qs, ks, out, lse, B, Tq, S, H, KV, d,        \
                        causal, scale, st);                                   \
  }                                                                           \
  extern "C" int dtx_flash_bwd_dq_##SUFFIX(                                   \
      const void* q, const void* k, const void* v, const void* dout,          \
      const float* lse, const float* dsum, const int* qs, const int* ks,      \
      void* dq, int B, int Tq, int S, int H, int KV, int d, int causal,       \
      float scale, cudaStream_t st) {                                         \
    return flash_dq<T>(q, k, v, dout, lse, dsum, qs, ks, dq, B, Tq, S, H,     \
                       KV, d, causal, scale, st);                             \
  }                                                                           \
  extern "C" int dtx_flash_bwd_dkv_##SUFFIX(                                  \
      const void* q, const void* k, const void* v, const void* dout,          \
      const float* lse, const float* dsum, const int* qs, const int* ks,      \
      void* dk, void* dv, int B, int Tq, int S, int H, int KV, int d,         \
      int causal, float scale, cudaStream_t st) {                             \
    return flash_dkv<T>(q, k, v, dout, lse, dsum, qs, ks, dk, dv, B, Tq, S,   \
                        H, KV, d, causal, scale, st);                         \
  }

DTX_FLASH_ENTRIES(bf16, __nv_bfloat16)
DTX_FLASH_ENTRIES(f32, float)
