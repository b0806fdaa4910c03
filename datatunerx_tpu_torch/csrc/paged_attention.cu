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
// block order. Still simple: CUDA-core f32 FMAs, no wgmma/TMA, no split
// over table entries.
//
// int8 pools (the int8 KV cache; reference :89-108 and :312-323) are further
// instantiations of the same two kernels, not another algorithm: the staging
// step loads 16 int8 values per 16-byte load, multiplies each by the f32
// scale of its (token, KV head) from the scale pools [NB, bs, KV], rounds
// the product through the compute dtype (kv_dequantize's one rounding;
// identity for f32) and stores f32 in shared memory. The multiply is an
// explicit __fmul_rn whose result is rounded and stored before any score
// product reads it, so no FMA contraction can change a bit and bf16 results
// equal the gather path's dequantized read. Tiles are staged as f32 either
// way, so the shared-memory budget per chunk is unchanged; the bytes read
// per cached token halve (d int8 + one f32 scale per head vector against 2*d).
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

template <typename T, typename P>
int launch_multitoken(const void* q, const void* k_pool, const void* v_pool,
                      const float* k_scale, const float* v_scale,
                      const int* tables, const uint8_t* allow, void* out,
                      int B, int Tq, int H, int KV, int d, int bs, int nbps,
                      int tq, float scale, cudaStream_t stream) {
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

}  // namespace

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
