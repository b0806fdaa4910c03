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
// bytes it stages, far above the card's ops:byte ridge. Two designs share
// the grid structure below.
//
// Shared by both:
// - The TPU's sequential grid axis becomes a loop inside one block: K1 and
//   K2 give a block 64 query rows of one (batch, head) and loop over 64-key
//   tiles, carrying the online-softmax max/normaliser (K1) or the dQ sum
//   (K2) in registers; K3 gives a block 64 key rows of one (batch, KV head)
//   and loops over the G query heads of its group and their query tiles, so
//   the GQA group sum of dK/dV happens in registers (no repeat of K/V, no
//   atomics, one rounding at the end). Blocks with the most tiles launch
//   first.
// - The causal skip is a loop bound (K1/K2: keys up to the tile's last row;
//   K3: query tiles from the key tile's first row), the element mask stays
//   for the diagonal tile.
// - Masked lanes give p = 0 explicitly, and rows keep the reference's finite
//   NEG_INF and the l >= 1e-30 clamp, so packed pad rows never produce NaN.
//
// Design 1, the f32 K1-K3: CUDA cores, f32. Tiles are staged
// synchronously in shared memory as f32 with an odd row pitch (d + 1), so
// column walks are free of bank conflicts; 256 threads each own a 4 x 4
// register tile of the 64 x 64 score block and the matching rows of the
// output, so row statistics stay in registers and row reductions are
// 16-lane shuffles. Bound by the 67 TFLOP/s f32 rate (in practice by the 8
// shared loads per 16 FMAs of a 4 x 4 tile), not the 989 TFLOP/s bf16
// tensor-core rate the bound is stated against. The f32 instantiations stay
// here because TF32 would not hold their 1e-4 tolerance; they serve tests
// and f32 training. Dispatch is by dtype.
//
// Design 2, the bf16 K1-K3: tensor cores (mma.sync.m16n8k16, bf16 in, f32
// accumulate) fed by cp.async, FlashAttention-2's forward and its backward
// split in two. The fragment helpers live in mma_sm90.cuh, shared with the
// paged K8.
// - 128 threads, 4 warps of 16 rows (K1, K2: query rows; K3: key rows). Tiles
//   stay bf16 in shared memory with a row pitch of d + 8 elements: rows stay
//   16-byte aligned for 16-byte cp.async, and the 8 rows an ldmatrix phase
//   reads fall into 8 distinct 16-byte bank groups.
// - The streamed operand arrives in a two-stage ring (K1, K2: K, V and the
//   key tile's segment ids; K3: Q, dO and the query tile's lse, D and segment
//   ids), tile i + 1 loading while tile i computes; rows past the end are
//   zero-filled by cp.async's source size, so the products stay finite.
// - K1: Q is staged once and held as A fragments (D/16 x 4 registers) for
//   the whole key loop; S = Q K^T with B = K [key][d] (plain ldmatrix). The
//   masks, the online softmax (max and sum over the quad of lanes sharing a
//   fragment row, 2^x of scores scaled by scale * log2 e) and the rescale
//   of O run on the f32 C fragments; tiles off the warp's causal diagonal,
//   not ragged and of the warp's own single segment test no lane, so each p
//   there is one FFMA on the raw score and one ex2. On a packed batch a
//   block visits only the key tiles that hold a segment id of its rows, and
//   a warp skips those none of whose ids its own rows hold (their p would
//   all be 0). l sums the f32 p before any rounding, so the lse means what
//   the reference's means. P packed to bf16 is the A
//   operand of O += P V, V [key][d] read as [k][n] through ldmatrix.trans.
// - K2: S = Q K^T and dP = dO V^T with A = Q / dO rows (ldmatrix) and B = K /
//   V stored [key][d], which is the B operand's col layout (plain ldmatrix).
//   dS is formed on the f32 C fragments; two adjacent n8 tiles, packed to
//   bf16, are the A fragment of one k16 step of dQ += dS K, whose B is
//   K [key][d] read as [k][n] through ldmatrix.trans.
// - K3 computes the transposed scores: S^T = K Q^T and dP^T = V dO^T, so P^T
//   and dS^T are register A fragments of dV += P^T dO and dK += dS^T Q, with
//   B = dO / Q through ldmatrix.trans. Nothing passes through shared memory
//   but the staged inputs. At d = 128 its query tile is 32 rows, so the two
//   f32 score fragments fit beside the 128 accumulator registers.
// - K2/K3: P = exp2(s * scale * log2 e - lse * log2 e) and
//   dS = P (dP - D) scale in f32 on the fragments; the masks use the
//   fragment's own (row, column).
// - Numerics: S and dP are as in design 1 (bf16 inputs are exact in f32,
//   sums are f32). One rounding point is new: P (K1) and dS (K2) round to
//   bf16 as operands of the second products, where the reference keeps
//   f32; relative error 2^-9 per term, random in sign, inside the 2^-6
//   bf16 tolerance the outputs are held to (K2's sum runs over one head's
//   keys). K3 sums over the G heads of a group as well, 8 x 1024 terms a
//   key row at the training shapes, and a single rounding of P and dS
//   there reaches the bound's edge (0.8 of it at one packed batch in an
//   emulation, past it on the card at another draw). So K3 splits each of
//   P^T and dS^T into a bf16 hi/lo pair (mma_sm90.cuh, c_to_a_split) and
//   issues two products into the same f32 accumulator: 16 significant
//   bits per operand, at four products a fragment instead of two. O, dQ,
//   dK and dV accumulate in f32 and round once.
// - What a wgmma/TMA version would add: 64-row warpgroup products with B
//   (and A for S/dP) read straight from swizzled shared memory, so the
//   ldmatrix traffic and most of the issue slots go; TMA loads issued by one
//   producer warp into a deeper mbarrier ring, freeing the consumers'
//   registers and the per-tile barriers; and 128-row key tiles in K3, which
//   halve the Q/dO traffic per key row.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sm90.cuh"

namespace {

using namespace dtx_mma;

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

// ------------------------------------------- bf16 K1-K3: mma.sync
constexpr int MT = 128;  // threads per block: 4 warps of 16 rows
constexpr float LOG2E = 1.4426950408889634f;

// ROWS rows of D bf16 (row r at src + r*ld) into s[r*(D+8) + c]; rows >=
// nvalid are zero
template <int D, int ROWS>
__device__ __forceinline__ void async_rows(bf16* s, const bf16* src, long ld,
                                           int nvalid) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < ROWS * CPR; c += MT) {
    const int r = c / CPR, col = (c % CPR) * 8;
    const bool ok = r < nvalid;
    cp16(s + r * (D + 8) + col, ok ? src + (long)r * ld + col : src, ok);
  }
}

// n f32 values (or segment ids; zeros if src is null) from src[0..nvalid)
template <typename E>
__device__ __forceinline__ void async_vec(E* s, const E* src, int n,
                                          int nvalid) {
  for (int r = threadIdx.x; r < n; r += MT) {
    if (src == nullptr)
      s[r] = E(0);
    else
      cp4(s + r, r < nvalid ? src + r : src, r < nvalid);
  }
}

// x[16, N] = A[16 rows at r0 of ta] @ tb[N][D]^T and y likewise from
// (ua, ub): the two score-shaped products of K2's and K3's tiles, sharing
// the k loop and its fragment loads (mma_sm90.cuh's mma_scores_a is the
// one-set product, with A in registers).
template <int D, int N>
__device__ __forceinline__ void mma_scores(float (*x)[4], float (*y)[4],
                                           const bf16* ta, const bf16* tb,
                                           const bf16* ua, const bf16* ub,
                                           int r0) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = y[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t a[4], u[4], fb[N / 16][4], fu[N / 16][4];
    ldsm_x4(ta, D + 8, r0, ks * 16, a);
    ldsm_x4(ua, D + 8, r0, ks * 16, u);
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      ldsm_b_x4(tb, D + 8, np * 16, ks * 16, fb[np]);
      ldsm_b_x4(ub, D + 8, np * 16, ks * 16, fu[np]);
    }
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      mma_bf16(x[2 * np], a, fb[np][0], fb[np][1]);
      mma_bf16(x[2 * np + 1], a, fb[np][2], fb[np][3]);
      mma_bf16(y[2 * np], u, fu[np][0], fu[np][1]);
      mma_bf16(y[2 * np + 1], u, fu[np][2], fu[np][3]);
    }
  }
}

// 16 rows x D of f32 accumulators to bf16 rows (row g and g + 8 of the
// warp's 16) at out + row * ld
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, long ld, int row0,
                                           int nrows, const float (*acc)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = g + 8 * i;
    if (row0 + r >= nrows) continue;
    bf16* o = out + (long)(row0 + r) * ld + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) =
          __floats2bfloat162_rn(acc[j][2 * i], acc[j][2 * i + 1]);
  }
}

// 2^x in one MUFU instruction; results below 2^-126 flush to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One key tile's step of the online softmax, on the f32 C fragments s of a
// warp's 16 rows (raw scores in, p out): m (raw-score max), l (the lane's
// share of the normaliser, from the f32 p) and corr (the factor O rescales
// by) for the thread's rows g and g + 8. With MASK, lanes ok(i, column)
// rejects score NEG_INF and give p = 0 explicitly; without it no lane is
// tested, and each p is one FFMA and one ex2.
template <bool MASK, int NB, typename Ok>
__device__ __forceinline__ void online_softmax(float (*s)[4], float* m,
                                               float* l, float* corr,
                                               float sl2, Ok ok) {
  const int t = threadIdx.x & 3;
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (MASK && !ok(e >> 1, 8 * j + 2 * t + (e & 1))) s[j][e] = NEG_INF;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
  float nm[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m_new = fmaxf(m[i], quad_max(mx[i]));
    corr[i] = ex2((m[i] - m_new) * sl2);
    m[i] = m_new;
    l[i] *= corr[i];
    nm[i] = -m_new * sl2;
  }
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = ex2(fmaf(s[j][e], sl2, nm[e >> 1]));
      // a masked lane is 0, also while its row has seen no key (m = NEG_INF)
      if (MASK && s[j][e] == NEG_INF) p = 0.f;
      l[e >> 1] += p;  // the f32 p, before P rounds to bf16
      s[j][e] = p;
    }
}

// K1: a block owns 64 query rows of one (batch, head); warp w rows
// 16w..16w+15, held as A fragments for the whole key loop. K, V and the key
// tile's segment ids stream through the ring. S, the masks, the online
// softmax and the rescale of O run on the f32 C fragments; P, packed to
// bf16, is the A operand of O += P V.
template <int D>
struct Fwd {
  // sQ, the K/V ring, the ring's segment ids, and on a packed batch the
  // list of key tiles the block visits (at most ceil(S / BK)) with its
  // count and the warps' id ranges
  static constexpr size_t smem(int S) {
    return (size_t)(BQ + 4 * BK) * (D + 8) * 2 + 2 * BK * 4 +
           ((S + BK - 1) / BK + 1 + 2 * (MT / 32)) * 4;
  }
};

template <int D>
__global__ void __launch_bounds__(MT) flash_fwd_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ qseg,
    const int* __restrict__ kseg, bf16* __restrict__ out,
    float* __restrict__ lse, int Tq, int S, int H, int KV, float scale,
    int causal) {
  constexpr int P = D + 8, NB = BK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + BQ * P;      // [2][BK][P]
  bf16* sV = sK + 2 * BK * P;  // [2][BK][P]
  int* sKs = reinterpret_cast<int*>(sV + 2 * BK * P);  // [2][BK]
  int* sRange = sKs + 2 * BK;                           // [MT / 32][2]
  int* sTiles = sRange + 2 * (MT / 32);                 // [count, tiles...]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  // x fastest: every head's last query tile (the most key tiles) first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int w0 = q0 + warp * 16;  // the warp's first row
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const long qld = (long)H * D, kld = (long)KV * D;
  const bf16* kb = k + ((long)b * S * KV + kvh) * D;
  const bf16* vb = v + ((long)b * S * KV + kvh) * D;
  const int* ksb = kseg == nullptr ? nullptr : kseg + (long)b * S;

  async_rows<D, BQ>(sQ, q + ((long)b * Tq * H + h) * D + (long)q0 * qld,
                    qld, min(BQ, Tq - q0));
  auto load_kv = [&](int k0, int st) {
    const int nk = min(BK, S - k0);
    async_rows<D, BK>(sK + st * BK * P, kb + (long)k0 * kld, kld, nk);
    async_rows<D, BK>(sV + st * BK * P, vb + (long)k0 * kld, kld, nk);
    async_vec<int>(sKs + st * BK, ksb == nullptr ? nullptr : ksb + k0, BK,
                   nk);
  };

  // the thread's two rows (g, g + 8 of the warp's 16) and their segment
  // ids; m is the running max of the raw scores (q . k), l the lane's share
  // of the row's normaliser, summed over the quad at the end (the rescales
  // are uniform over a row, so the shares rescale alike)
  int row[2], qs[2];
  float m[2], l[2];
  // the range of the warp's query segment ids (empty past Tq)
  int qmn = INT_MAX, qmx = INT_MIN;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = w0 + g + 8 * i;
    qs[i] = (row[i] < Tq && qseg != nullptr) ? qseg[(long)b * Tq + row[i]]
                                             : 0;
    if (row[i] < Tq) qmn = min(qmn, qs[i]), qmx = max(qmx, qs[i]);
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
  for (int o = 1; o < 32; o <<= 1) {
    qmn = min(qmn, __shfl_xor_sync(0xffffffffu, qmn, o));
    qmx = max(qmx, __shfl_xor_sync(0xffffffffu, qmx, o));
  }
  const float sl2 = scale * LOG2E;

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  uint32_t qa[D / 16][4];

  const int kend = causal ? min(S, q0 + BQ) : S;
  int ntiles = (kend + BK - 1) / BK;
  const bool packed = qseg != nullptr && kseg != nullptr;
  if (packed) {
    // the key tiles holding an id of the block's rows, in order: the rest
    // would give every row p = 0, so the loop never stages them
    if (lane == 0) sRange[2 * warp] = qmn, sRange[2 * warp + 1] = qmx;
    __syncthreads();
    int bmn = INT_MAX, bmx = INT_MIN;
    for (int w = 0; w < MT / 32; ++w)
      bmn = min(bmn, sRange[2 * w]), bmx = max(bmx, sRange[2 * w + 1]);
    for (int i = warp; i < ntiles; i += MT / 32) {
      const int c0 = i * BK + lane, c1 = c0 + 32;
      int mn = c0 < S ? ksb[c0] : INT_MAX, mx = c0 < S ? ksb[c0] : INT_MIN;
      if (c1 < S) mn = min(mn, ksb[c1]), mx = max(mx, ksb[c1]);
      for (int o = 1; o < 32; o <<= 1) {
        mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
        mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      }
      if (lane == 0) sTiles[1 + i] = !(mx < bmn || mn > bmx);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int n = 0;
      for (int i = 0; i < ntiles; ++i)
        if (sTiles[1 + i]) sTiles[1 + n++] = i;
      sTiles[0] = n;
    }
    __syncthreads();
    ntiles = sTiles[0];
  }
  auto tile_k0 = [&](int it) { return (packed ? sTiles[1 + it] : it) * BK; };

  if (ntiles > 0) load_kv(tile_k0(0), 0);
  cp_commit();  // Q and the first K/V tile
  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1, k0 = tile_k0(it);
    cp_wait<0>();  // tile it has landed
    __syncthreads();  // as in K2: one barrier a tile
    if (it + 1 < ntiles) load_kv(tile_k0(it + 1), st ^ 1);
    cp_commit();
    if (it == 0) load_a_rows<D>(sQ, warp * 16, qa);
    const int* tks = sKs + st * BK;

    // a warp skips a tile wholly after its last row (causal) and, on a
    // packed batch, one none of whose key ids its rows hold (every p would
    // be 0: nothing would change); where its rows and keys all hold one id
    // it needs no segment test
    if (causal && k0 > w0 + 15) continue;
    bool same = qseg == nullptr;
    if (qseg != nullptr) {
      int kmn = min(tks[lane], tks[lane + 32]);
      int kmx = max(tks[lane], tks[lane + 32]);
      for (int o = 1; o < 32; o <<= 1) {
        kmn = min(kmn, __shfl_xor_sync(0xffffffffu, kmn, o));
        kmx = max(kmx, __shfl_xor_sync(0xffffffffu, kmx, o));
      }
      if (kmx < qmn || kmn > qmx) continue;
      same = kmn == kmx && qmn == qmx && kmn == qmn;
    }

    float s[NB][4];
    mma_scores_a<D, BK>(s, qa, sK + st * BK * P);

    // lanes are masked one by one only where one may be: the causal
    // diagonal, a ragged last key tile, mixed segments
    float corr[2];
    if ((causal && k0 + BK - 1 > w0) || k0 + BK > S || !same) {
      online_softmax<true, NB>(s, m, l, corr, sl2, [&](int i, int c) {
        const int col = k0 + c;
        return col < S && (!causal || col <= row[i]) && qs[i] == tks[c];
      });
    } else {
      online_softmax<false, NB>(s, m, l, corr, sl2,
                                [](int, int) { return true; });
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e >> 1];
    mma_pv<D, BK>(acc, s, sV + st * BK * P);
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lv = fmaxf(quad_sum(l[i]), 1e-30f);
    const float inv = 1.f / lv;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][2 * i] *= inv;
      acc[j][2 * i + 1] *= inv;
    }
    if (t == 0 && row[i] < Tq)
      lse[(long)bh * Tq + row[i]] = m[i] * scale + logf(lv);
  }
  store_rows<D>(out + ((long)b * Tq * H + h) * D, qld, w0, Tq, acc);
}

template <int D>
struct Dq {
  static constexpr size_t smem() {
    return (size_t)(2 * BQ + 4 * BK) * (D + 8) * 2 + 2 * BK * 4;
  }
};

// K2: a block owns 64 query rows of one (batch, head); warp w rows
// 16w..16w+15. Q and dO are staged once; K, V and the key segment ids
// stream through the ring. At d <= 64, 3 blocks an SM (<= 168 registers;
// 4 blocks spill and run slower).
template <int D>
__global__ void __launch_bounds__(MT, D <= 64 ? 3 : 1) flash_bwd_dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    const int* __restrict__ qseg, const int* __restrict__ kseg,
    bf16* __restrict__ dq, int Tq, int S, int H, int KV, float scale,
    int causal) {
  constexpr int P = D + 8, NB = BK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sO = sQ + BQ * P;
  bf16* sK = sO + BQ * P;      // [2][BK][P]
  bf16* sV = sK + 2 * BK * P;  // [2][BK][P]
  int* sKs = reinterpret_cast<int*>(sV + 2 * BK * P);  // [2][BK]
  int* sRange = sKs + 2 * BK;                           // [MT / 32][2]
  int* sTiles = sRange + 2 * (MT / 32);                 // [count, tiles...]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  // x fastest: every head's last query tile (the most key tiles) first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const long qld = (long)H * D, kld = (long)KV * D;
  const long qoff = ((long)b * Tq * H + h) * D + (long)q0 * qld;
  const bf16* kb = k + ((long)b * S * KV + kvh) * D;
  const bf16* vb = v + ((long)b * S * KV + kvh) * D;
  const int* ksb = kseg == nullptr ? nullptr : kseg + (long)b * S;

  async_rows<D, BQ>(sQ, q + qoff, qld, min(BQ, Tq - q0));
  async_rows<D, BQ>(sO, dout + qoff, qld, min(BQ, Tq - q0));
  auto load_kv = [&](int k0, int st) {
    const int nk = min(BK, S - k0);
    async_rows<D, BK>(sK + st * BK * P, kb + (long)k0 * kld, kld, nk);
    async_rows<D, BK>(sV + st * BK * P, vb + (long)k0 * kld, kld, nk);
    async_vec<int>(sKs + st * BK, ksb == nullptr ? nullptr : ksb + k0, BK,
                   nk);
  };

  // the thread's two rows (g, g + 8 of the warp's 16): log2-domain lse, D,
  // segment id and the last key each may see (-1: a row past Tq)
  float l2[2], dr[2];
  int qs[2], lim[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + g + 8 * i;
    const bool in = row < Tq;
    l2[i] = in ? lse[(long)bh * Tq + row] * LOG2E : 0.f;
    dr[i] = in ? dsum[(long)bh * Tq + row] : 0.f;
    qs[i] = (in && qseg != nullptr) ? qseg[(long)b * Tq + row] : 0;
    lim[i] = !in ? -1 : (causal ? min(row, S - 1) : S - 1);
  }
  const float sl2 = scale * LOG2E;

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const int kend = causal ? min(S, q0 + BQ) : S;
  const int ntiles = (kend + BK - 1) / BK;
  if (ntiles > 0) load_kv(0, 0);
  cp_commit();  // Q, dO and the first K/V tile
  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1, k0 = it * BK;
    cp_wait<0>();  // tile it has landed
    // one barrier a tile: past it, tile it is visible to every warp and
    // every warp is done with tile it - 1, whose stage the next load reuses
    __syncthreads();
    if (it + 1 < ntiles) load_kv(k0 + BK, st ^ 1);
    cp_commit();
    const bf16* tK = sK + st * BK * P;
    const int* tks = sKs + st * BK;

    float s[NB][4], dp[NB][4];
    mma_scores<D, BK>(s, dp, sQ, tK, sO, sV + st * BK * P, warp * 16);

#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int c = 8 * j + 2 * t;  // the fragment's columns c, c + 1
      const int2 kid = *reinterpret_cast<const int2*>(tks + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const bool ok = k0 + c + (e & 1) <= lim[i] &&
                        qs[i] == ((e & 1) ? kid.y : kid.x);
        const float p = ok ? exp2f(fmaf(s[j][e], sl2, -l2[i])) : 0.f;
        s[j][e] = p * (dp[j][e] - dr[i]) * scale;  // dS
      }
    }
    uint32_t da[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) c_to_a(s, kk, da[kk]);
    mma_rows_t<D, BK, 1>(acc, da, tK, nullptr, nullptr, nullptr);
  }
  cp_wait<0>();

  store_rows<D>(dq + ((long)b * Tq * H + h) * D, qld, q0 + warp * 16, Tq,
                acc);
}

// K3: a block owns 64 key rows of one (batch, KV head); warp w rows
// 16w..16w+15. K and V are staged once; Q, dO and the query tile's lse, D
// and segment ids stream through the ring, over the G heads of the group
// and their query tiles.
template <int D>
struct Dkv {
  static constexpr int P = D + 8;
  static constexpr int QT = D > 64 ? 32 : 64;  // query rows per tile
  static constexpr size_t smem() {
    return (size_t)(2 * BK + 4 * QT) * P * 2 + 2 * 3 * QT * 4;
  }
};

template <int D>
__global__ void __launch_bounds__(MT) flash_bwd_dkv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    const int* __restrict__ qseg, const int* __restrict__ kseg,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int Tq, int S, int H,
    int KV, float scale, int causal) {
  constexpr int P = Dkv<D>::P, QT = Dkv<D>::QT, NB = QT / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + BK * P;
  bf16* sQ = sV + BK * P;      // [2][QT][P]
  bf16* sO = sQ + 2 * QT * P;  // [2][QT][P]
  float* sL = reinterpret_cast<float*>(sO + 2 * QT * P);  // [2][QT]
  float* sD = sL + 2 * QT;                                 // [2][QT]
  int* sQs = reinterpret_cast<int*>(sD + 2 * QT);          // [2][QT]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.y * BK;  // x fastest: every first key tile first
  const int bkv = blockIdx.x, b = bkv / KV, kvh = bkv % KV;
  const int G = H / KV;
  const long qld = (long)H * D, kld = (long)KV * D;
  const long koff = ((long)b * S * KV + kvh) * D;

  async_rows<D, BK>(sK, k + koff + (long)k0 * kld, kld, min(BK, S - k0));
  async_rows<D, BK>(sV, v + koff + (long)k0 * kld, kld, min(BK, S - k0));

  const int q_first = causal ? (k0 / QT) * QT : 0;
  const int nqt = Tq > q_first ? (Tq - q_first + QT - 1) / QT : 0;
  const int total = G * nqt;
  auto load_q = [&](int it, int st) {
    const int h = kvh * G + it / nqt, q0 = q_first + (it % nqt) * QT;
    const long bh = (long)b * H + h;
    const long qoff = ((long)b * Tq * H + h) * D + (long)q0 * qld;
    const int nq = min(QT, Tq - q0);
    async_rows<D, QT>(sQ + st * QT * P, q + qoff, qld, nq);
    async_rows<D, QT>(sO + st * QT * P, dout + qoff, qld, nq);
    async_vec<float>(sL + st * QT, lse + bh * Tq + q0, QT, nq);
    async_vec<float>(sD + st * QT, dsum + bh * Tq + q0, QT, nq);
    async_vec<int>(sQs + st * QT,
                   qseg == nullptr ? nullptr : qseg + (long)b * Tq + q0, QT,
                   nq);
  };

  // the thread's two key rows: segment id and the first query each may
  // see (a row past S sees none)
  int ks[2], lo[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int krow = k0 + warp * 16 + g + 8 * i;
    const bool in = krow < S;
    ks[i] = (in && kseg != nullptr) ? kseg[(long)b * S + krow] : 0;
    lo[i] = !in ? Tq : (causal ? krow : 0);
  }
  const float sl2 = scale * LOG2E;

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  if (total > 0) load_q(0, 0);
  cp_commit();  // K, V and the first query tile
  for (int it = 0; it < total; ++it) {
    const int st = it & 1, q0 = q_first + (it % nqt) * QT;
    cp_wait<0>();
    __syncthreads();  // as in K2: one barrier a tile
    if (it + 1 < total) load_q(it + 1, st ^ 1);
    cp_commit();
    const bf16* tQ = sQ + st * QT * P;
    const bf16* tO = sO + st * QT * P;
    const float* tL = sL + st * QT;
    const float* tD = sD + st * QT;
    const int* tqs = sQs + st * QT;

    float sT[NB][4], dpT[NB][4];  // S^T, dP^T: [16 keys][QT queries]
    mma_scores<D, QT>(sT, dpT, sK, tQ, sV, tO, warp * 16);

#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int c = 8 * j + 2 * t;  // the fragment's columns c, c + 1
      const float2 l = *reinterpret_cast<const float2*>(tL + c);
      const float2 dd = *reinterpret_cast<const float2*>(tD + c);
      const int2 qid = *reinterpret_cast<const int2*>(tqs + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, odd = e & 1, qrow = q0 + c + odd;
        const bool ok = qrow >= lo[i] && qrow < Tq &&
                        ks[i] == (odd ? qid.y : qid.x);
        const float p = ok ? exp2f(fmaf(sT[j][e], sl2,
                                        -(odd ? l.y : l.x) * LOG2E))
                           : 0.f;
        sT[j][e] = p;
        dpT[j][e] = p * (dpT[j][e] - (odd ? dd.y : dd.x)) * scale;  // dS^T
      }
    }
    // P^T and dS^T as hi/lo bf16 pairs: rounded once to bf16 they leave
    // the 2^-6 bound on long GQA sums (ROADMAP, found at a packed 8 x 1024
    // batch with G = 8), held to 2^-16 they stay far inside it
    uint32_t pa[QT / 16][4], pl[QT / 16][4], da[QT / 16][4], dl[QT / 16][4];
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
      c_to_a_split(sT, kk, pa[kk], pl[kk]);
      c_to_a_split(dpT, kk, da[kk], dl[kk]);
    }
    mma_rows_t_split<D, QT>(dva, pa, pl, tO, dka, da, dl, tQ);
  }
  cp_wait<0>();

  store_rows<D>(dk + koff, kld, k0 + warp * 16, S, dka);
  store_rows<D>(dv + koff, kld, k0 + warp * 16, S, dva);
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
  if constexpr (std::is_same<T, bf16>::value) {
    const size_t smem = Fwd<D>::smem(S);
    auto kern = flash_fwd_mma_kernel<D>;
    if (int e = set_smem(kern, smem)) return e;
    dim3 grid(B * H, (Tq + BQ - 1) / BQ);
    kern<<<grid, MT, smem, st>>>(
        (const T*)q, (const T*)k, (const T*)v, qs, ks, (T*)out, lse, Tq, S,
        H, KV, scale, causal);
    return (int)cudaGetLastError();
  } else {
    const size_t smem = ((BQ + 2 * BK) * (D + 1) + BQ * (BK + 1)) * 4 +
                        (BQ + BK) * 4;
    auto kern = flash_fwd_kernel<T, D>;
    if (int e = set_smem(kern, smem)) return e;
    dim3 grid((Tq + BQ - 1) / BQ, B * H);
    kern<<<grid, NT, smem, st>>>(
        (const T*)q, (const T*)k, (const T*)v, qs, ks, (T*)out, lse, Tq, S,
        H, KV, scale, causal);
    return (int)cudaGetLastError();
  }
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* dsum, const int* qs,
              const int* ks, void* dq, int B, int Tq, int S, int H, int KV,
              int causal, float scale, cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value) {
    const size_t smem = Dq<D>::smem();
    auto kern = flash_bwd_dq_mma_kernel<D>;
    if (int e = set_smem(kern, smem)) return e;
    dim3 grid(B * H, (Tq + BQ - 1) / BQ);
    kern<<<grid, MT, smem, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dsum, qs,
        ks, (T*)dq, Tq, S, H, KV, scale, causal);
    return (int)cudaGetLastError();
  } else {
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
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* dsum, const int* qs,
               const int* ks, void* dk, void* dv, int B, int Tq, int S,
               int H, int KV, int causal, float scale, cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value) {
    const size_t smem = Dkv<D>::smem();
    auto kern = flash_bwd_dkv_mma_kernel<D>;
    if (int e = set_smem(kern, smem)) return e;
    dim3 grid(B * KV, (S + BK - 1) / BK);
    kern<<<grid, MT, smem, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dsum, qs,
        ks, (T*)dk, (T*)dv, Tq, S, H, KV, scale, causal);
    return (int)cudaGetLastError();
  } else {
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

// What the bf16 K1, K2 and K3 take of an SM at head dim D, as the compiler
// built them: per kernel registers per thread, local (spill) bytes per
// thread, dynamic shared bytes per block and resident blocks per SM.
template <typename K>
int resources(K kern, size_t smem, int* out) {
  cudaFuncAttributes a;
  if (int e = (int)cudaFuncGetAttributes(&a, kern)) return e;
  if (int e = set_smem(kern, smem)) return e;
  int blocks = 0;
  if (int e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kern, MT, smem))
    return e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)smem;
  out[3] = blocks;
  return 0;
}

template <int D>
int bwd_resources_d(int* out) {
  if (int e = resources(flash_bwd_dq_mma_kernel<D>, Dq<D>::smem(), out))
    return e;
  return resources(flash_bwd_dkv_mma_kernel<D>, Dkv<D>::smem(), out + 4);
}

template <int D>
int fwd_resources_d(int* out) {
  return resources(flash_fwd_mma_kernel<D>, Fwd<D>::smem(1024), out);
}

#define RES(D) bwd_resources_d<D>(out)
#define RESF(D) fwd_resources_d<D>(out)
int bwd_resources(int d, int* out) { DTX_FLASH_DISPATCH(d, RES) }
int fwd_resources(int d, int* out) { DTX_FLASH_DISPATCH(d, RESF) }

#undef RES
#undef RESF
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

// out[0..3]: the bf16 K2's registers, spill bytes, shared bytes and blocks
// per SM at head dim d; out[4..7]: K3's.
extern "C" int dtx_flash_bwd_resources(int d, int* out) {
  return bwd_resources(d, out);
}

// out[0..3]: the bf16 K1's registers, spill bytes, shared bytes and blocks
// per SM at head dim d.
extern "C" int dtx_flash_fwd_resources(int d, int* out) {
  return fwd_resources(d, out);
}
