// Paged attention over a block-pool KV cache, read in place through the
// per-slot block tables: one-token decode (K7) and multi-token chunks (K8).
//
// Replaces (TPU kernels):
//   K7  datatunerx_tpu/ops/pallas_paged_attention.py::_decode_kernel
//       (entered via paged_decode_attention / paged_attention_decode_step)
//   K8  datatunerx_tpu/ops/pallas_paged_attention.py::_multitoken_kernel
//       (entered via paged_multitoken_attention /
//        paged_attention_multitoken_step)
//
// What bounds it on an H100: bytes. Decode reads each live K block twice and
// each live V block once and does ~2*G flops per K element (G = H/KV query
// heads per KV head, 8 for tinyllama) — far below the ~295 flop/byte ridge.
// A chunk of T query rows reuses every K/V block T*G times, so K8 leans
// towards the operation bound as T grows.
//
// What the design does about it: the gathered [B, W, KV, d] view of the
// gather path never exists — each thread block walks ONE slot's table for
// ONE KV head and stages the live [bs, d] K (then V) tiles in shared memory
// with 16-byte loads, skipping table entries < 0 without touching memory, so
// traffic scales with the slot's live blocks rather than the table width.
// A loop iteration stages up to `ch` table blocks at once (8 where shared
// memory allows), so the sequential walk takes few, wide steps instead of
// one 16-token step per block. Decode launches one thread block per (slot,
// group of `gs` query heads of one KV head) — gs is shrunk until there are
// enough blocks to fill the card; the K/V re-reads of sibling groups come
// from L2. K8 launches one per (slot, KV head, tile of query rows), all G
// heads of the group sharing each staged tile.
//
// The two passes of the reference are kept on purpose: pass 0 computes the
// f32 running max m and normaliser l block by block in table order; pass 1
// forms p = exp(s - m) / max(l, 1e-30), rounds p to the compute dtype, and
// only then accumulates each block's p*V partial into the f32 output — the
// rounding point of the gather path's probs.astype(v.dtype), which a
// one-pass online accumulator cannot reproduce. Staging several blocks per
// iteration changes no arithmetic: stats and partials are still folded in
// block order.
//
// Two designs. K7, and K8 in f32 (or at a head dim outside 16/32/64/128,
// or over pools that are not 16-byte aligned):
// CUDA-core f32 FMAs over f32 tiles in shared memory (chunk_rows). The bf16
// K8, over bf16 or int8 pools, runs on tensor cores (mma.sync.m16n8k16,
// bf16 in, f32 accumulate; the skeleton of mma_sm90.cuh, shared with flash
// K1-K3): the block's rows held as A fragments, chunks of K and V staged
// as bf16 with a d + 8 pitch through a two-stage cp.async ring, S
// recomputed in pass 1, and p formed on the f32 C fragments and rounded to
// bf16 as the A operand of P V, which is exactly the gather path's rounding
// point, at no extra cost. A block has only ~4 warps of rows at the
// prefill shapes, so one chain of staged chunks set its time; the keys are
// split over 4 warps a row group (2 at d = 128), each taking 64 lanes of
// every chunk, and the splits' (m, l) and partial outputs merge through
// shared memory. Its results differ from the plain version's only by the
// order of the f32 sums. Still simple: no wgmma/TMA, no split across
// blocks.
//
// int8 pools (the int8 KV cache; reference :89-108 and :312-323) are further
// instantiations of the same two kernels, not another algorithm: the staging
// step loads 16 int8 values per 16-byte load, multiplies each by the f32
// scale of its (token, KV head) from the scale pools [NB, bs, KV], rounds
// the product through the compute dtype (kv_dequantize's one rounding;
// identity for f32) and stores it in shared memory: as f32 in the CUDA-core
// kernels, as bf16 (exact, since the value was rounded to bf16) in the
// tensor-core K8, whose int8 staging is synchronous (loads, multiply, store)
// rather than cp.async. The multiply is an explicit __fmul_rn whose result
// is rounded and stored before any score product reads it, so no FMA
// contraction can change a bit and bf16 results equal the gather path's
// dequantized read up to the order of the sums. The bytes read per cached
// token halve (d int8 + one f32 scale per head vector against 2*d).
// A head dim that is not a multiple of 16 takes the element-wise loop.
//
// Masking: K7 compares the pos pool (POS_SENTINEL on unwritten lanes) with
// the query's rope position; K8 reads the [B, T, nbps*bs] allow operand,
// the same boolean the gather path turns into its bias. A slot with no live
// block writes zeros; a fully masked K8 row writes finite junk (uniform
// weights), as in the reference's garbage contract.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sm90.cuh"

#define DTX_NEG_INF (-1e30f)
#define DTX_MAX_CHUNK 8

namespace {

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <>
__device__ __forceinline__ float to_f<int8_t>(int8_t x) { return (float)x; }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// p rounded through the compute dtype (identity for f32)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

// 16 bytes of T → floats
template <typename T>
struct Vec16;
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int W = 8;
  __device__ __forceinline__ static void cvt(const uint4& u, float* o) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};
template <>
struct Vec16<float> {
  static constexpr int W = 4;
  __device__ __forceinline__ static void cvt(const uint4& u, float* o) {
    o[0] = __uint_as_float(u.x);
    o[1] = __uint_as_float(u.y);
    o[2] = __uint_as_float(u.z);
    o[3] = __uint_as_float(u.w);
  }
};

template <>
struct Vec16<int8_t> {
  static constexpr int W = 16;
  __device__ __forceinline__ static void cvt(const uint4& u, float* o) {
    const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < 16; ++i) o[i] = (float)b[i];
  }
};

// A pool element as the compute dtype sees it: int8 pools (P = int8_t) give
// round_T(f32(x) * scale), an explicit multiply and one rounding; pools in
// the compute dtype are taken as they are (s unused).
template <typename T, typename P>
__device__ __forceinline__ float dequant(float raw, float s) {
  if constexpr (std::is_same<P, int8_t>::value)
    return round_to<T>(__fmul_rn(raw, s));
  else
    return raw;
}

// Stage the K tiles (rows padded to d+1 floats, so per-row score loops are
// free of bank conflicts) and, in pass 1, the V tiles of the chunk's live
// table blocks: slot c of the chunk holds physical block blk_s[c].
// ksc/vsc are the int8 pools' scale pools [NB, bs, KV] (unused otherwise).
template <typename T, typename P>
__device__ __forceinline__ void stage_chunk(const P* kp, const P* vp,
                                            const float* ksc,
                                            const float* vsc,
                                            const int* blk_s, int ch, int kv,
                                            int KV, int d, int bs,
                                            bool with_v, bool vec, float* k_s,
                                            float* v_s) {
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  const int rows = ch * bs;
  if (vec) {
    constexpr int W = Vec16<P>::W;
    const int per_row = d / W;
    for (int u = threadIdx.x; u < rows * per_row; u += blockDim.x) {
      const int row = u / per_row, col = (u - row * per_row) * W;
      const int c = row / bs, t = row - c * bs;
      const int blk = blk_s[c];
      if (blk < 0) continue;
      const size_t sc = ((size_t)blk * bs + t) * KV + kv;
      const size_t g = sc * d + col;
      float f[W];
      Vec16<P>::cvt(*reinterpret_cast<const uint4*>(kp + g), f);
      const float sk = kQuant ? ksc[sc] : 1.f;
#pragma unroll
      for (int i = 0; i < W; ++i)
        k_s[row * (d + 1) + col + i] = dequant<T, P>(f[i], sk);
      if (with_v) {
        Vec16<P>::cvt(*reinterpret_cast<const uint4*>(vp + g), f);
        const float sv = kQuant ? vsc[sc] : 1.f;
#pragma unroll
        for (int i = 0; i < W; ++i)
          v_s[row * d + col + i] = dequant<T, P>(f[i], sv);
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
    const int row = i / d, col = i - row * d;
    const int c = row / bs, t = row - c * bs;
    const int blk = blk_s[c];
    if (blk < 0) continue;
    const size_t sc = ((size_t)blk * bs + t) * KV + kv;
    const size_t g = sc * d + col;
    k_s[row * (d + 1) + col] =
        dequant<T, P>(to_f<P>(kp[g]), kQuant ? ksc[sc] : 1.f);
    if (with_v)
      v_s[i] = dequant<T, P>(to_f<P>(vp[g]), kQuant ? vsc[sc] : 1.f);
  }
}

// Load the chunk's table entries (-1 past the table) and report whether any
// is live. Ends with a barrier, so every thread sees the same answer.
__device__ __forceinline__ bool load_chunk(const int* tables_row, int j0,
                                           int nbps, int ch, int* blk_s,
                                           int* any_s) {
  if (threadIdx.x == 0) *any_s = 0;
  __syncthreads();
  if (threadIdx.x < ch) {
    const int j = j0 + threadIdx.x;
    const int blk = j < nbps ? tables_row[j] : -1;
    blk_s[threadIdx.x] = blk;
    if (blk >= 0) atomicOr(any_s, 1);
  }
  __syncthreads();
  return *any_s != 0;
}

// Pass-0 update of one row's running stats over one block's masked scores.
__device__ __forceinline__ void stats_update(const float* s, int bs,
                                             float* m, float* l) {
  float mx = s[0];
  for (int t = 1; t < bs; ++t) mx = fmaxf(mx, s[t]);
  const float m_prev = *m;
  const float m_new = fmaxf(m_prev, mx);
  float sum = 0.f;
  for (int t = 0; t < bs; ++t) sum += expf(s[t] - m_new);
  *l = *l * expf(m_prev - m_new) + sum;
  *m = m_new;
}

// The shared per-chunk work of both kernels, for R query rows whose f32
// queries are q_s [R, d]: scores (masked through ok(r, c*bs+o)), then pass 0
// stats or pass 1 rounded-p·V partials folded into acc [R, d], block by
// block in table order.
//
// The two products are register-tiled: a warp owns RT rows × 32*CT lanes
// (scores) or RT rows × 32*CV output columns (p·V), each thread CT (CV)
// lanes 32 apart, so a warp reads consecutive shared-memory rows (no bank
// conflicts), q/p values are broadcast, and each loaded value feeds RT or CT
// FMAs. Every score and every block partial is still one fmaf chain in the
// same order as a scalar loop, so tiling changes no result bit.
template <typename T, int RT, int CT, int CV, typename Ok>
__device__ __forceinline__ void chunk_rows(int pass, int R, int ch, int bs,
                                           int d, float scale,
                                           const int* blk_s, const float* q_s,
                                           const float* k_s, const float* v_s,
                                           float* s_s, float* m_s, float* l_s,
                                           float* acc, Ok ok) {
  const int cb = ch * bs;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int rgroups = (R + RT - 1) / RT;
  const int lgroups = (cb + 32 * CT - 1) / (32 * CT);
  for (int item = warp; item < rgroups * lgroups; item += nw) {
    const int rg = item / lgroups, lg = item - rg * lgroups;
    const int r0 = rg * RT;
    int ct[CT];
    bool live[CT];
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      ct[j] = lg * 32 * CT + lane + 32 * j;
      live[j] = ct[j] < cb && blk_s[min(ct[j], cb - 1) / bs] >= 0;
    }
    float dot[RT][CT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) dot[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[RT], kv[CT];
#pragma unroll
      for (int i = 0; i < RT; ++i) qv[i] = q_s[min(r0 + i, R - 1) * d + c];
#pragma unroll
      for (int j = 0; j < CT; ++j) kv[j] = k_s[min(ct[j], cb - 1) * (d + 1) + c];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) dot[i][j] = fmaf(qv[i], kv[j], dot[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j)
        if (r0 + i < R && live[j]) {
          const float s = dot[i][j] * scale;
          s_s[(r0 + i) * cb + ct[j]] = ok(r0 + i, ct[j]) ? s : DTX_NEG_INF;
        }
  }
  __syncthreads();
  if (pass == 0) {
    for (int r = threadIdx.x; r < R; r += blockDim.x)
      for (int c = 0; c < ch; ++c)
        if (blk_s[c] >= 0)
          stats_update(s_s + r * cb + c * bs, bs, m_s + r, l_s + r);
    return;
  }
  for (int i = threadIdx.x; i < R * cb; i += blockDim.x) {
    const int r = i / cb;
    if (blk_s[(i - r * cb) / bs] < 0) continue;
    const float p = expf(s_s[i] - m_s[r]) / fmaxf(l_s[r], 1e-30f);
    s_s[i] = round_to<T>(p);
  }
  __syncthreads();
  const int cgroups = (d + 32 * CV - 1) / (32 * CV);
  for (int item = warp; item < rgroups * cgroups; item += nw) {
    const int rg = item / cgroups, cg = item - rg * cgroups;
    const int r0 = rg * RT;
    int col[CV];
#pragma unroll
    for (int j = 0; j < CV; ++j) col[j] = min(cg * 32 * CV + lane + 32 * j, d - 1);
    float a[RT][CV];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CV; ++j) a[i][j] = acc[min(r0 + i, R - 1) * d + col[j]];
    for (int c = 0; c < ch; ++c) {
      if (blk_s[c] < 0) continue;
      float part[RT][CV];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CV; ++j) part[i][j] = 0.f;
      for (int o = 0; o < bs; ++o) {
        float pv[RT], vv[CV];
#pragma unroll
        for (int i = 0; i < RT; ++i)
          pv[i] = s_s[min(r0 + i, R - 1) * cb + c * bs + o];
#pragma unroll
        for (int j = 0; j < CV; ++j) vv[j] = v_s[(c * bs + o) * d + col[j]];
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < CV; ++j)
            part[i][j] = fmaf(pv[i], vv[j], part[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CV; ++j) a[i][j] += part[i][j];
    }
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CV; ++j)
        if (r0 + i < R && cg * 32 * CV + lane + 32 * j < d)
          acc[(r0 + i) * d + col[j]] = a[i][j];
  }
}

// ---------------------------------------------------------------- K7
// grid (KV * G/gs, B); one block per (slot, group of gs query heads).
template <typename T, typename P>
__global__ void paged_decode_kernel(const T* __restrict__ q,
                                    const P* __restrict__ kp,
                                    const P* __restrict__ vp,
                                    const float* __restrict__ ksc,
                                    const float* __restrict__ vsc,
                                    const int* __restrict__ tables,
                                    const int* __restrict__ pos_pool,
                                    const int* __restrict__ q_pos,
                                    T* __restrict__ out, int H, int KV, int d,
                                    int bs, int nbps, int gs, int ch,
                                    float scale, bool vec) {
  const int G = H / KV, ngrp = G / gs;
  const int kv = blockIdx.x / ngrp, b = blockIdx.y;
  const int h0 = kv * G + (blockIdx.x - kv * ngrp) * gs;
  const int cb = ch * bs;
  extern __shared__ float smem[];
  float* q_s = smem;                  // [gs, d]
  float* acc = q_s + gs * d;          // [gs, d]
  float* k_s = acc + gs * d;          // [ch*bs, d+1]
  float* v_s = k_s + cb * (d + 1);    // [ch*bs, d]
  float* s_s = v_s + cb * d;          // [gs, ch*bs]
  float* m_s = s_s + gs * cb;         // [gs]
  float* l_s = m_s + gs;              // [gs]
  int* ok_s = (int*)(l_s + gs);       // [ch*bs]
  int* blk_s = ok_s + cb;             // [ch]
  int* any_s = blk_s + ch;            // [1]

  const size_t q_base = ((size_t)b * H + h0) * d;
  for (int i = threadIdx.x; i < gs * d; i += blockDim.x) {
    q_s[i] = to_f<T>(q[q_base + i]);
    acc[i] = 0.f;
  }
  for (int g = threadIdx.x; g < gs; g += blockDim.x) {
    m_s[g] = DTX_NEG_INF;
    l_s[g] = 0.f;
  }
  const int qp = q_pos[b];
  const int* trow = tables + (size_t)b * nbps;
  for (int pass = 0; pass < 2; ++pass) {
    for (int j0 = 0; j0 < nbps; j0 += ch) {
      if (!load_chunk(trow, j0, nbps, ch, blk_s, any_s)) continue;
      stage_chunk<T, P>(kp, vp, ksc, vsc, blk_s, ch, kv, KV, d, bs,
                        pass == 1, vec, k_s, v_s);
      for (int i = threadIdx.x; i < cb; i += blockDim.x) {
        const int blk = blk_s[i / bs];
        ok_s[i] = blk >= 0 && pos_pool[(size_t)blk * bs + i % bs] <= qp;
      }
      __syncthreads();
      chunk_rows<T, 1, 1, 1>(pass, gs, ch, bs, d, scale, blk_s, q_s, k_s,
                             v_s, s_s, m_s, l_s, acc,
                             [&](int, int ct) { return ok_s[ct] != 0; });
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < gs * d; i += blockDim.x)
    out[q_base + i] = from_f<T>(acc[i]);
}

// ---------------------------------------------------------------- K8
// grid (KV, B, ceil(T / tq)); one block per (KV head, slot, tile of tq query
// rows) handles G*tq rows, row r = g*tq + tt.
template <typename T, typename P>
__global__ void paged_multitoken_kernel(const T* __restrict__ q,
                                        const P* __restrict__ kp,
                                        const P* __restrict__ vp,
                                        const float* __restrict__ ksc,
                                        const float* __restrict__ vsc,
                                        const int* __restrict__ tables,
                                        const uint8_t* __restrict__ allow,
                                        T* __restrict__ out, int Tq, int H,
                                        int KV, int d, int bs, int nbps,
                                        int tq, int ch, float scale,
                                        bool vec) {
  const int kv = blockIdx.x, b = blockIdx.y, t0 = blockIdx.z * tq;
  const int G = H / KV;
  const int R = G * tq;
  const int cb = ch * bs;
  const size_t W = (size_t)nbps * bs;
  extern __shared__ float smem[];
  float* q_s = smem;                  // [R, d]
  float* acc = q_s + R * d;           // [R, d]
  float* k_s = acc + R * d;           // [ch*bs, d+1]
  float* v_s = k_s + cb * (d + 1);    // [ch*bs, d]
  float* s_s = v_s + cb * d;          // [R, ch*bs]
  float* m_s = s_s + R * cb;          // [R]
  float* l_s = m_s + R;               // [R]
  int* ok_s = (int*)(l_s + R);        // [tq, ch*bs]
  int* blk_s = ok_s + tq * cb;        // [ch]
  int* any_s = blk_s + ch;            // [1]

  for (int i = threadIdx.x; i < R * d; i += blockDim.x) {
    const int r = i / d, c = i - r * d;
    const int g = r / tq, t = t0 + (r - g * tq);
    q_s[i] = t < Tq ? to_f<T>(q[(((size_t)b * Tq + t) * H + (size_t)kv * G + g) * d + c])
                    : 0.f;
    acc[i] = 0.f;
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    m_s[r] = DTX_NEG_INF;
    l_s[r] = 0.f;
  }
  const int* trow = tables + (size_t)b * nbps;
  for (int pass = 0; pass < 2; ++pass) {
    for (int j0 = 0; j0 < nbps; j0 += ch) {
      if (!load_chunk(trow, j0, nbps, ch, blk_s, any_s)) continue;
      stage_chunk<T, P>(kp, vp, ksc, vsc, blk_s, ch, kv, KV, d, bs,
                        pass == 1, vec, k_s, v_s);
      for (int i = threadIdx.x; i < tq * cb; i += blockDim.x) {
        const int tt = i / cb, ct = i - tt * cb;
        const int t = t0 + tt;
        ok_s[i] = t < Tq && blk_s[ct / bs] >= 0 &&
                  allow[((size_t)b * Tq + t) * W + (size_t)j0 * bs + ct] != 0;
      }
      __syncthreads();
      chunk_rows<T, 4, 4, 2>(
          pass, R, ch, bs, d, scale, blk_s, q_s, k_s, v_s, s_s, m_s, l_s, acc,
          [&](int r, int ct) { return ok_s[(r % tq) * cb + ct] != 0; });
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < R * d; i += blockDim.x) {
    const int r = i / d, c = i - r * d;
    const int g = r / tq, t = t0 + (r - g * tq);
    if (t < Tq)
      out[(((size_t)b * Tq + t) * H + (size_t)kv * G + g) * d + c] =
          from_f<T>(acc[i]);
  }
}

// ------------------------------------------------- bf16 K8: mma.sync
// grid (KV, B, ceil(T / tq)) as above. The block's R = G*tq rows (r = g*tq
// + tt; rows past R or past T are zero queries, never stored) fall into
// nwr = ceil(R / 16) row groups of 16, and the keys into KS splits: warp w
// takes row group w % nwr and split w / nwr, so a block runs nwr * KS warps
// and KS of them share each row group. The keys walk the flat [nbps*bs]
// lane view of the slot's table in chunks of KS * 64 lanes, split s taking
// lanes [64 s, 64 s + 64) of each chunk; lane w is pool row
// (tables[w / bs], w % bs). A chunk none of whose table entries is live is
// skipped without touching memory. Pass 0 folds each split's running max m
// and normaliser l over the live chunks, and the splits' (m, l) then merge
// through shared memory; pass 1 walks the chunks again, forms
// p = exp(s - m) / max(l, 1e-30) on the f32 C fragments, rounds it to bf16
// as the A operand of O += P V (the gather path's probs.astype rounding)
// and accumulates in f32; the splits' partial outputs are summed through
// shared memory at the end. Both passes are one sequence of (pass, chunk)
// items through a two-stage ring. The splits only reorder f32 sums.
constexpr int KT = 64;  // key lanes per split and chunk

template <int D, int KS>
struct Mt {
  static constexpr int P = D + 8, KC = KS * KT;
  // the K/V ring, whose memory takes the splits' partial outputs
  // [KS - 1][nwr][D/2][32 lanes] at the end
  __host__ __device__ static size_t ring(int nwr) {
    const size_t st = 4 * (size_t)KC * P * 2;
    const size_t red = (size_t)(KS - 1) * nwr * 16 * D * 4;
    return st > red ? st : red;
  }
  static size_t smem(int nwr, int tq) {
    return (size_t)nwr * 16 * P * 2 + ring(nwr)  // sQ, the ring
           + 2 * KC * 4                          // sLive [2][KC]
           + (size_t)KS * nwr * 16 * 2 * 4       // sML [KS][nwr*16][2]
           + 2 * (size_t)tq * KC;                // sA [2][tq][KC]
  }
};

// The first chunk >= c with a live table entry (nc if none). Every thread
// of the block reads the same entries, so all agree without a barrier.
__device__ __forceinline__ int next_live(const int* trow, int bs, int W,
                                         int kc, int c, int nc) {
  for (; c < nc; ++c) {
    const int j1 = min(c * kc + kc - 1, W - 1) / bs;
    for (int j = c * kc / bs; j <= j1; ++j)
      if (trow[j] >= 0) return c;
  }
  return nc;
}

template <typename P, int D, int KS>
__global__ void __launch_bounds__(KS * 128) paged_multitoken_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const P* __restrict__ kp,
    const P* __restrict__ vp, const float* __restrict__ ksc,
    const float* __restrict__ vsc, const int* __restrict__ tables,
    const uint8_t* __restrict__ allow, __nv_bfloat16* __restrict__ out,
    int Tq, int H, int KV, int bs, int nbps, int tq, float scale,
    bool allow_vec) {
  using namespace dtx_mma;
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  constexpr int PT = D + 8, NB = KT / 8, KC = KS * KT;
  const int kv = blockIdx.x, b = blockIdx.y, t0 = blockIdx.z * tq;
  const int G = H / KV, R = G * tq, nwr = (R + 15) / 16;
  const int W = nbps * bs, nchunks = (W + KC - 1) / KC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rw = warp % nwr, ks = warp / nwr;
  const int g = lane >> 2, t = lane & 3;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [nwr*16][PT]
  bf16* sK = sQ + nwr * 16 * PT;                  // [2][KC][PT]
  bf16* sV = sK + 2 * KC * PT;                    // [2][KC][PT]
  float* sRed = reinterpret_cast<float*>(sK);     // at the end
  int* sLive = reinterpret_cast<int*>(smem_raw + (size_t)nwr * 16 * PT * 2 +
                                      Mt<D, KS>::ring(nwr));  // [2][KC]
  float* sML = reinterpret_cast<float*>(sLive + 2 * KC);  // [KS][nwr*16][2]
  uint8_t* sA = reinterpret_cast<uint8_t*>(sML + KS * nwr * 16 * 2);
  const int* trow = tables + (size_t)b * nbps;
  const uint8_t* arow = allow + (size_t)b * Tq * W;

  // the query rows: zero past R or past T
  for (int u = threadIdx.x; u < nwr * 16 * (D / 8); u += blockDim.x) {
    const int r = u / (D / 8), col = (u % (D / 8)) * 8;
    const int gq = r / tq, tt = r - gq * tq;
    const bool ok = r < R && t0 + tt < Tq;
    cp16(sQ + r * PT + col,
         ok ? q + (((size_t)b * Tq + t0 + tt) * H + (size_t)kv * G + gq) * D +
                  col
            : q,
         ok);
  }

  // Stage chunk c into stage st: its K rows, V rows in pass 1, which lanes
  // are live, and the allow bytes [tq][KC] of the block's query rows. Dead
  // lanes are zero rows.
  auto fill = [&](int c, int st, bool with_v) {
    const int k0 = c * KC;
    bf16* tK = sK + st * KC * PT;
    bf16* tV = sV + st * KC * PT;
    if constexpr (!kQuant) {
      for (int u = threadIdx.x; u < KC * (D / 8); u += blockDim.x) {
        const int r = u / (D / 8), col = (u % (D / 8)) * 8, w = k0 + r;
        const int blk = w < W ? trow[w / bs] : -1;
        const size_t off =
            blk >= 0 ? (((size_t)blk * bs + w % bs) * KV + kv) * D + col : 0;
        cp16(tK + r * PT + col, kp + off, blk >= 0);
        if (with_v) cp16(tV + r * PT + col, vp + off, blk >= 0);
      }
    } else {
      // int8 pools: f32(x) * scale, rounded once to bf16 (kv_dequantize's
      // arithmetic; an explicit multiply, so no contraction changes a bit)
      for (int u = threadIdx.x; u < KC * (D / 16); u += blockDim.x) {
        const int r = u / (D / 16), col = (u % (D / 16)) * 16, w = k0 + r;
        const int blk = w < W ? trow[w / bs] : -1;
        const size_t sc = blk >= 0 ? ((size_t)blk * bs + w % bs) * KV + kv : 0;
        for (int x = 0; x < (with_v ? 2 : 1); ++x) {
          uint4 o[2] = {make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};
          if (blk >= 0) {
            const uint4 raw =
                *reinterpret_cast<const uint4*>((x ? vp : kp) + sc * D + col);
            const float s = (x ? vsc : ksc)[sc];
            const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
            uint32_t* ow = reinterpret_cast<uint32_t*>(o);
#pragma unroll
            for (int i = 0; i < 8; ++i)
              ow[i] = pack_bf16(__fmul_rn((float)e[2 * i], s),
                                __fmul_rn((float)e[2 * i + 1], s));
          }
          uint4* dst =
              reinterpret_cast<uint4*>((x ? tV : tK) + r * PT + col);
          dst[0] = o[0];
          dst[1] = o[1];
        }
      }
    }
    for (int r = threadIdx.x; r < KC; r += blockDim.x) {
      const int w = k0 + r;
      sLive[st * KC + r] = w < W && trow[w / bs] >= 0;
    }
    uint8_t* tA = sA + st * tq * KC;
    if (allow_vec) {  // W % 4 == 0 and allow 4-byte aligned
      for (int u = threadIdx.x; u < tq * (KC / 4); u += blockDim.x) {
        const int tt = u / (KC / 4), cc = (u % (KC / 4)) * 4;
        const bool ok = t0 + tt < Tq && k0 + cc < W;
        cp4(tA + tt * KC + cc,
            ok ? arow + (size_t)(t0 + tt) * W + k0 + cc : arow, ok);
      }
    } else {
      for (int u = threadIdx.x; u < tq * KC; u += blockDim.x) {
        const int tt = u / KC, cc = u - tt * KC;
        tA[u] = (t0 + tt < Tq && k0 + cc < W)
                    ? arow[(size_t)(t0 + tt) * W + k0 + cc]
                    : 0;
      }
    }
  };

  // the thread's two rows (g, g + 8 of its row group)
  int row[2], tt_[2];
  bool vr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = rw * 16 + g + 8 * i;
    const int gq = row[i] / tq;
    tt_[i] = row[i] - gq * tq;
    vr[i] = row[i] < R && t0 + tt_[i] < Tq;
    if (!vr[i]) tt_[i] = 0;
  }
  const float sl2 = scale * 1.4426950408889634f;
  const float kDead = __int_as_float(0xff800000);  // -inf
  float m[2] = {DTX_NEG_INF, DTX_NEG_INF}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  uint32_t qa[D / 16][4];

  const int first = next_live(trow, bs, W, KC, 0, nchunks);
  int cur = first, pass = 0;
  if (cur < nchunks) fill(cur, 0, false);
  cp_commit();  // Q and the first chunk
  for (int it = 0; cur < nchunks; ++it) {
    const int st = it & 1;
    cp_wait<0>();
    __syncthreads();  // one barrier an item, as in flash K2
    int nx = next_live(trow, bs, W, KC, cur + 1, nchunks), nx_pass = pass;
    if (nx == nchunks && pass == 0) nx = first, nx_pass = 1;
    if (nx < nchunks) fill(nx, st ^ 1, nx_pass == 1);
    cp_commit();
    if (it == 0) load_a_rows<D>(sQ, rw * 16, qa);
    if (pass == 1 && cur == first) {
      // pass 0 is over: merge the splits' (m, l) of each row; l becomes
      // 1 / max(l, 1e-30)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float lq = quad_sum(l[i]);
        if (t == 0) {
          sML[((ks * nwr) * 16 + row[i]) * 2] = m[i];
          sML[((ks * nwr) * 16 + row[i]) * 2 + 1] = lq;
        }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mm = DTX_NEG_INF, ll = 0.f;
        for (int k = 0; k < KS; ++k)
          mm = fmaxf(mm, sML[((k * nwr) * 16 + row[i]) * 2]);
        for (int k = 0; k < KS; ++k) {
          const float* e = sML + ((k * nwr) * 16 + row[i]) * 2;
          ll += e[1] * exp2f(e[0] - mm);
        }
        m[i] = mm;
        l[i] = 1.f / fmaxf(ll, 1e-30f);
      }
    }

    float s[NB][4];
    mma_scores_a<D, KT>(s, qa, sK + (st * KC + ks * KT) * PT);
    const int* tl = sLive + st * KC + ks * KT;
    const uint8_t* tA = sA + st * tq * KC + ks * KT;
    // masked live lanes score NEG_INF, as in the plain version (a row with
    // no allowed lane gets uniform weights); dead lanes score -inf, so they
    // add nothing to the max or the sums
    float mx[2] = {DTX_NEG_INF, DTX_NEG_INF};
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int c = 8 * j + 2 * t;
      const int2 live = *reinterpret_cast<const int2*>(tl + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, odd = e & 1;
        const bool on = odd ? live.y : live.x;
        const bool ok = vr[i] && tA[tt_[i] * KC + c + odd] != 0;
        s[j][e] = !on ? kDead : ok ? s[j][e] * sl2 : DTX_NEG_INF;
        mx[i] = fmaxf(mx[i], s[j][e]);
      }
    }
    if (pass == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[i], quad_max(mx[i]));
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NB; ++j)
          sum += exp2f(s[j][2 * i] - m_new) + exp2f(s[j][2 * i + 1] - m_new);
        l[i] = l[i] * exp2f(m[i] - m_new) + sum;
        m[i] = m_new;
      }
    } else {
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = exp2f(s[j][e] - m[e >> 1]) * l[e >> 1];
      // p rounded to bf16 as the A operand
      mma_pv<D, KT>(acc, s, sV + (st * KC + ks * KT) * PT);
    }
    if (nx == nchunks) break;
    cur = nx;
    pass = nx_pass;
  }
  cp_wait<0>();

  if constexpr (KS > 1) {
    // the splits' partial outputs, summed in split order into split 0's
    __syncthreads();  // every warp is done with the ring, whose memory
                      // takes them
    if (ks > 0)
#pragma unroll
      for (int je = 0; je < D / 2; ++je)
        sRed[(((ks - 1) * nwr + rw) * (D / 2) + je) * 32 + lane] =
            acc[je >> 2][je & 3];
    __syncthreads();
    if (ks == 0)
      for (int k = 1; k < KS; ++k)
#pragma unroll
        for (int je = 0; je < D / 2; ++je)
          acc[je >> 2][je & 3] +=
              sRed[(((k - 1) * nwr + rw) * (D / 2) + je) * 32 + lane];
  }
  if (ks != 0) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!vr[i]) continue;
    const int gq = row[i] / tq;
    __nv_bfloat16* o =
        out + (((size_t)b * Tq + t0 + tt_[i]) * H + (size_t)kv * G + gq) * D +
        2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) =
          __floats2bfloat162_rn(acc[j][2 * i], acc[j][2 * i + 1]);
  }
}

constexpr size_t kSmemCap = 200 * 1024;  // of the 227 KB a block may use

template <typename K>
int set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

size_t decode_smem(int gs, int ch, int bs, int d) {
  const size_t cb = (size_t)ch * bs;
  return sizeof(float) * (2 * (size_t)gs * d + cb * (d + 1) + cb * d +
                          (size_t)gs * cb + 2 * (size_t)gs) +
         sizeof(int) * (cb + ch + 1);
}

size_t multitoken_smem(int R, int tq, int ch, int bs, int d) {
  const size_t cb = (size_t)ch * bs;
  return sizeof(float) * (2 * (size_t)R * d + cb * (d + 1) + cb * d +
                          (size_t)R * cb + 2 * (size_t)R) +
         sizeof(int) * ((size_t)tq * cb + ch + 1);
}

// 16-byte loads need rows of whole vectors and aligned pools.
template <typename P>
bool vec_ok(const void* a, const void* b, int d) {
  return d % Vec16<P>::W == 0 && (uintptr_t)a % 16 == 0 &&
         (uintptr_t)b % 16 == 0;
}

template <typename T, typename P>
int launch_decode(const void* q, const void* k_pool, const void* v_pool,
                  const float* k_scale, const float* v_scale,
                  const int* tables, const int* pos_pool, const int* q_pos,
                  void* out, int B, int H, int KV, int d, int bs, int nbps,
                  float scale, cudaStream_t stream) {
  const int G = H / KV;
  // fewer heads per block until the grid fills the card
  int gs = G;
  while (gs % 2 == 0 && (long)B * KV * (G / gs) < 256) gs /= 2;
  int ch = DTX_MAX_CHUNK;
  while (ch > 1 && decode_smem(gs, ch, bs, d) > kSmemCap) ch /= 2;
  const size_t smem = decode_smem(gs, ch, bs, d);
  int err = set_smem(paged_decode_kernel<T, P>, smem);
  if (err) return err;
  dim3 grid(KV * (G / gs), B);
  paged_decode_kernel<T, P><<<grid, 128, smem, stream>>>(
      (const T*)q, (const P*)k_pool, (const P*)v_pool, k_scale, v_scale,
      tables, pos_pool, q_pos, (T*)out, H, KV, d, bs, nbps, gs, ch, scale,
      vec_ok<P>(k_pool, v_pool, d));
  return (int)cudaGetLastError();
}

// The bf16 K8 on tensor cores: KS key splits (4 at d <= 64; 2 at d = 128,
// whose accumulators need the registers), ceil(R / 16) <= 4 row groups.
template <int D>
constexpr int mma_splits() {
  return D <= 64 ? 4 : 2;
}

template <typename P, int D>
int launch_multitoken_mma(const void* q, const void* k_pool,
                          const void* v_pool, const float* k_scale,
                          const float* v_scale, const int* tables,
                          const uint8_t* allow, void* out, int B, int Tq,
                          int H, int KV, int bs, int nbps, int tq,
                          float scale, cudaStream_t stream) {
  constexpr int KS = mma_splits<D>();
  const int nwr = ((H / KV) * tq + 15) / 16;
  const size_t smem = Mt<D, KS>::smem(nwr, tq);
  auto kern = paged_multitoken_mma_kernel<P, D, KS>;
  if (int err = set_smem(kern, smem)) return err;
  const bool allow_vec = (nbps * bs) % 4 == 0 && (uintptr_t)allow % 4 == 0;
  dim3 grid(KV, B, (Tq + tq - 1) / tq);
  kern<<<grid, 32 * nwr * KS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const P*)k_pool, (const P*)v_pool, k_scale,
      v_scale, tables, allow, (__nv_bfloat16*)out, Tq, H, KV, bs, nbps, tq,
      scale, allow_vec);
  return (int)cudaGetLastError();
}

// Whether the tensor-core K8 takes G heads a KV head and tq rows a block
// at head dim D: at most 4 row groups, shared memory within the cap
template <int D>
bool mma_fits(int G, int tq) {
  const int nwr = (G * tq + 15) / 16;
  return nwr <= 4 && Mt<D, mma_splits<D>()>::smem(nwr, tq) <= kSmemCap;
}

// The tensor-core K8's launch code if it takes the call, else -1
template <typename P>
int multitoken_mma(const void* q, const void* k_pool, const void* v_pool,
                   const float* k_scale, const float* v_scale,
                   const int* tables, const uint8_t* allow, void* out, int B,
                   int Tq, int H, int KV, int d, int bs, int nbps, int tq,
                   float scale, cudaStream_t stream) {
#define MMA(D)                                                           \
  case D:                                                                \
    return mma_fits<D>(H / KV, tq)                                       \
               ? launch_multitoken_mma<P, D>(q, k_pool, v_pool, k_scale, \
                                             v_scale, tables, allow, out, \
                                             B, Tq, H, KV, bs, nbps, tq,  \
                                             scale, stream)               \
               : -1;
  switch (d) { MMA(16) MMA(32) MMA(64) MMA(128) }
#undef MMA
  return -1;
}

template <typename T, typename P>
int launch_multitoken(const void* q, const void* k_pool, const void* v_pool,
                      const float* k_scale, const float* v_scale,
                      const int* tables, const uint8_t* allow, void* out,
                      int B, int Tq, int H, int KV, int d, int bs, int nbps,
                      int tq, float scale, cudaStream_t stream) {
  // bf16 over pools read 16 bytes at a time, where the tensor-core kernel
  // takes the shape (tinyllama's always); f32, and the rest, take the
  // CUDA-core kernel below
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (vec_ok<P>(k_pool, v_pool, d)) {
      const int code =
          multitoken_mma<P>(q, k_pool, v_pool, k_scale, v_scale, tables,
                            allow, out, B, Tq, H, KV, d, bs, nbps, tq, scale,
                            stream);
      if (code >= 0) return code;
    }
  }
  const int R = (H / KV) * tq;
  int ch = DTX_MAX_CHUNK;
  while (ch > 1 && multitoken_smem(R, tq, ch, bs, d) > kSmemCap) ch /= 2;
  const size_t smem = multitoken_smem(R, tq, ch, bs, d);
  int err = set_smem(paged_multitoken_kernel<T, P>, smem);
  if (err) return err;
  dim3 grid(KV, B, (Tq + tq - 1) / tq);
  paged_multitoken_kernel<T, P><<<grid, 256, smem, stream>>>(
      (const T*)q, (const P*)k_pool, (const P*)v_pool, k_scale, v_scale,
      tables, allow, (T*)out, Tq, H, KV, d, bs, nbps, tq, ch, scale,
      vec_ok<P>(k_pool, v_pool, d));
  return (int)cudaGetLastError();
}

// What the bf16 K8 takes of an SM at head dim D for G heads a KV head and
// tq query rows a block: registers, local (spill) bytes per thread, dynamic
// shared bytes per block and resident blocks per SM, over bf16 pools
// (out[0..3]) and int8 pools (out[4..7]).
template <typename P, int D>
int mma_resources(int nwr, int tq, int* out) {
  constexpr int KS = mma_splits<D>();
  auto kern = paged_multitoken_mma_kernel<P, D, KS>;
  const size_t smem = Mt<D, KS>::smem(nwr, tq);
  cudaFuncAttributes a;
  if (int e = (int)cudaFuncGetAttributes(&a, kern)) return e;
  if (int e = set_smem(kern, smem)) return e;
  int blocks = 0;
  if (int e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kern, 32 * nwr * KS, smem))
    return e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)smem;
  out[3] = blocks;
  return 0;
}

template <int D>
int multitoken_resources_d(int nwr, int tq, int* out) {
  if (int e = mma_resources<__nv_bfloat16, D>(nwr, tq, out)) return e;
  return mma_resources<int8_t, D>(nwr, tq, out + 4);
}

int multitoken_resources(int d, int G, int tq, int* out) {
  const int nwr = (G * tq + 15) / 16;
  switch (d) {
    case 16: return multitoken_resources_d<16>(nwr, tq, out);
    case 32: return multitoken_resources_d<32>(nwr, tq, out);
    case 64: return multitoken_resources_d<64>(nwr, tq, out);
    case 128: return multitoken_resources_d<128>(nwr, tq, out);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int dtx_paged_multitoken_resources(int d, int G, int tq,
                                              int* out) {
  return multitoken_resources(d, G, tq, out);
}

// Pools in the compute dtype (SUFFIX bf16/f32) and int8 pools with their
// scale pools (i8_bf16/i8_f32).
#define DTX_PAGED_ENTRIES(SUFFIX, T)                                          \
  extern "C" int dtx_paged_decode_##SUFFIX(                                   \
      const void* q, const void* k_pool, const void* v_pool,                  \
      const void* tables, const void* pos_pool, const void* q_pos,            \
      void* out, int B, int H, int KV, int d, int bs, int nbps, float scale,  \
      void* stream) {                                                         \
    return launch_decode<T, T>(                                               \
        q, k_pool, v_pool, nullptr, nullptr, (const int*)tables,              \
        (const int*)pos_pool, (const int*)q_pos, out, B, H, KV, d, bs, nbps,  \
        scale, (cudaStream_t)stream);                                         \
  }                                                                           \
  extern "C" int dtx_paged_decode_i8_##SUFFIX(                                \
      const void* q, const void* k_pool, const void* v_pool,                  \
      const void* k_scale, const void* v_scale, const void* tables,           \
      const void* pos_pool, const void* q_pos, void* out, int B, int H,       \
      int KV, int d, int bs, int nbps, float scale, void* stream) {           \
    return launch_decode<T, int8_t>(                                          \
        q, k_pool, v_pool, (const float*)k_scale, (const float*)v_scale,      \
        (const int*)tables, (const int*)pos_pool, (const int*)q_pos, out, B,  \
        H, KV, d, bs, nbps, scale, (cudaStream_t)stream);                     \
  }                                                                           \
  extern "C" int dtx_paged_multitoken_##SUFFIX(                               \
      const void* q, const void* k_pool, const void* v_pool,                  \
      const void* tables, const void* allow, void* out, int B, int Tq, int H, \
      int KV, int d, int bs, int nbps, int tq, float scale, void* stream) {   \
    return launch_multitoken<T, T>(                                           \
        q, k_pool, v_pool, nullptr, nullptr, (const int*)tables,              \
        (const uint8_t*)allow, out, B, Tq, H, KV, d, bs, nbps, tq, scale,     \
        (cudaStream_t)stream);                                                \
  }                                                                           \
  extern "C" int dtx_paged_multitoken_i8_##SUFFIX(                            \
      const void* q, const void* k_pool, const void* v_pool,                  \
      const void* k_scale, const void* v_scale, const void* tables,           \
      const void* allow, void* out, int B, int Tq, int H, int KV, int d,      \
      int bs, int nbps, int tq, float scale, void* stream) {                  \
    return launch_multitoken<T, int8_t>(                                      \
        q, k_pool, v_pool, (const float*)k_scale, (const float*)v_scale,      \
        (const int*)tables, (const uint8_t*)allow, out, B, Tq, H, KV, d, bs,  \
        nbps, tq, scale, (cudaStream_t)stream);                               \
  }

DTX_PAGED_ENTRIES(bf16, __nv_bfloat16)
DTX_PAGED_ENTRIES(f32, float)
