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
// What bounds it on an H100: bytes, and for decode latency. Decode (K7)
// reads each live K and V block once and does ~2*G flops per K element
// (G = H/KV query heads per KV head, 8 for tinyllama) — far below the ~295
// flop/byte ridge; at a few slots its time is a chain of memory latencies.
// A chunk of T query rows reuses every K/V block T*G times, so K8 leans
// towards the operation bound as T grows.
//
// What the designs do about it: the gathered [B, W, KV, d] view of the
// gather path never exists — thread blocks walk the slot's table and stage
// the live [bs, d] K (then V) tiles in shared memory with 16-byte loads,
// skipping table entries < 0 without touching memory, so traffic scales
// with the slot's live blocks rather than the table width.
//
// K7 splits the table ("flash-decoding"): one block per (slot, KV head,
// split of the table) holds all G query heads of the KV head, so each
// cached byte is read once, and B * KV * splits blocks fill the card even
// at 4 slots; the splits' statistics and partial outputs merge in split
// order in two more launches (the K7 section below). K8 launches one block
// per (slot, KV head, tile of query rows), all G heads of the group sharing
// each staged tile; a loop iteration stages up to `ch` table blocks at once
// (8 where shared memory allows), so the sequential walk takes few, wide
// steps.
//
// The two passes of the reference are kept on purpose: pass 0 computes the
// f32 running max m and normaliser l; pass 1 forms p = exp(s - m) /
// max(l, 1e-30), rounds p to the compute dtype, and only then accumulates
// p*V into the f32 output — the rounding point of the gather path's
// probs.astype(v.dtype), which a one-pass online accumulator cannot
// reproduce. Staging several blocks per iteration, or splitting the table,
// changes no rounding: only the order of the f32 sums.
//
// Two designs for K8. In f32 (or at a head dim outside 16/32/64/128, or
// over pools that are not 16-byte aligned): CUDA-core f32 FMAs over f32
// tiles in shared memory (chunk_rows). The bf16
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
// blocks. K7 does ~2 G flops a cached byte, so it stays on CUDA-core FMAs
// in every dtype.
//
// int8 pools (the int8 KV cache; reference :89-108 and :312-323) are further
// instantiations of the same kernels, not another algorithm: the staging
// step multiplies each int8 value by the f32 scale of its (token, KV head)
// from the scale pools [NB, bs, KV], rounds the product through the compute
// dtype (kv_dequantize's one rounding; identity for f32) and stores it in
// shared memory: as f32 in the CUDA-core K8, as the compute dtype in K7
// (which copies the int8 rows and their scales with cp.async and
// dequantizes them out of the ring), as bf16 (exact, since the value was
// rounded to bf16) in the tensor-core K8, whose int8 staging is synchronous
// (loads, multiply, store) rather than cp.async. The multiply is an
// explicit __fmul_rn whose result is rounded and stored before any score
// product reads it, so no FMA contraction can change a bit and bf16 results
// equal the gather path's dequantized read up to the order of the sums.
// The bytes read per cached token halve (d int8 + one f32 scale per head
// vector against 2*d).
// In K8 a head dim that is not a multiple of 16 takes the element-wise
// loop; K7 takes head dims 8..128 in steps of 8.
//
// Masking: K7 compares the pos pool (POS_SENTINEL on unwritten lanes) with
// the query's rope position; K8 reads the [B, T, nbps*bs] allow operand,
// the same boolean the gather path turns into its bias. A slot with no live
// block writes zeros; a fully masked slot (K7) or row (K8) writes finite
// junk (uniform weights), as in the reference's garbage contract.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>
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
// Split-table decode. The slot's table is cut into S splits of E entries
// (decode_splits in ops/cuda_paged_attention.py): split s takes entries
// [s E, min(s E + E, nbps)). One block per (split, group of R query heads of
// one KV head, slot): grid (S, KV * G / R, B) of DEC_NT threads; R = G at
// tinyllama's heads, so every cached K/V byte is read once from device
// memory. The S blocks of a (slot, head group) form one thread-block
// cluster (S <= 16), and the reference's two passes run in one launch as
// two phases that meet through distributed shared memory:
//   phase 0  each split's masked scores, kept in its shared memory, and
//            its f32 max m and normaliser l per head, written with its live
//            flag into every block of the cluster; cluster barrier;
//   phase 1  every block merges the S splits' (m, l) in split order into
//            the slot's (m, l) (all compute the same values), forms
//            p = exp(s - m) / max(l, 1e-30) rounded to T over its stored
//            scores, and its split's f32 p.V partial, each output of which
//            it writes into the block that sums it; cluster barrier;
//   sum      block s sums its share of the group's outputs over the live
//            splits' partials in split order, from its own shared memory,
//            rounds once to T, and writes them.
// A block writes into the others' shared memory and reads only its own, so
// none is read after the last barrier. Nothing goes through device memory
// but the pools and the output, and the result does not depend on the
// blocks' timing. A split with no live
// table entry has (NEG_INF, 0) and no partial; the sum skips every split
// whose l is 0 (a live split has l >= 1), so an empty slot writes zeros.
//
// Inside a split, stages of TK lanes (lane w is pool row (tables[w / bs],
// w % bs)) come through a two-stage cp.async ring: the K rows (phase 0) or
// the V rows (phase 1), the lanes' positions and, for int8 pools, the
// rows' scales. A stage none of whose table entries is live is skipped
// unread; dead lanes of a live stage are zero rows scoring -inf. Phase 0
// prefetches the V rows into L2, and phase 1's first V stage is in flight
// while the blocks wait at the barrier. An int8 stage is dequantized into
// a T tile (f32(x) * scale rounded through T, an explicit multiply, as
// kv_dequantize). Scores: a thread owns one lane and two heads at a time,
// so each K element loaded feeds both, each score two fmaf chains over the
// halves of d; (m, l): a warp per head, shuffle max and sum; P.V: a thread
// owns two columns and up to 8 heads, p read 4 lanes at a time into two
// chains a column.
constexpr int DEC_NT = 256;
constexpr int DEC_MAX_SPLITS = 16;  // blocks a cluster (above 8: non-portable)

struct DecArgs {
  int H, KV, d, bs, nbps, S, E;
  int R;      // query heads a block
  int TK;     // lanes a stage
  int pitch;  // T elements a tile row
  int rowb;   // bytes a staged row of the ring
  int chunk;  // bytes a cp.async of a pool row
  float scale;
};

// Byte offsets of a K7 block's shared memory (each 16-byte aligned): q; the
// scores, then p, of the split's NL lanes [R][NL + 4]; m and l; what the
// cluster's blocks write into this one (every split's (m, l) per head, its
// live flag, its partial of the outputs this block sums); the ring of two
// stages (K or V rows,
// positions, live flags, int8 scales) and, for int8 pools, the dequantized
// tile.
struct DecSmem {
  size_t q, s, m, l, st, flag, part, ring, stage, raw, pos, live, sc, t,
      total;
};

__host__ __device__ inline size_t up16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// outputs of a head group each block sums: block j takes outputs
// [j n / S, (j + 1) n / S) of n = R d, at most this many
__host__ __device__ inline int dec_share(const DecArgs& a) {
  return (a.R * a.d + a.S - 1) / a.S;
}

// lanes of a split's score rows: its E blocks, rounded up to whole stages
__host__ __device__ inline int dec_lanes(const DecArgs& a) {
  return (a.E * a.bs + a.TK - 1) / a.TK * a.TK;
}

template <typename T, typename P>
__host__ __device__ inline DecSmem dec_smem(const DecArgs& a) {
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  DecSmem o;
  size_t at = 0, st = 0;
  o.q = at;
  at += up16((size_t)a.R * a.d * 4);
  o.s = at;
  at += up16((size_t)a.R * (dec_lanes(a) + 4) * 4);
  o.m = at;
  at += up16((size_t)a.R * 4);
  o.l = at;
  at += up16((size_t)a.R * 4);
  o.st = at;  // every split's (m, l) per head [S][R][2]
  at += up16((size_t)a.S * a.R * 8);
  o.flag = at;  // every split's live flag [S]
  at += up16((size_t)a.S * 4);
  o.part = at;  // every split's partial of this block's outputs [S][CH]
  at += up16((size_t)a.S * dec_share(a) * 4);
  o.raw = st;
  st += (size_t)a.TK * a.rowb;
  o.pos = st;
  st += up16((size_t)a.TK * 4);
  o.live = st;
  st += up16((size_t)a.TK * 4);
  o.sc = st;
  if (kQuant) st += up16((size_t)a.TK * 4);
  o.ring = at;
  o.stage = st;
  at += 2 * st;
  o.t = at;
  if (kQuant) at += up16((size_t)a.TK * a.pitch * sizeof(T));
  o.total = at;
  return o;
}

// The heads a block, lanes a stage and row layouts for G heads a KV head at
// head dim d (d % 8 == 0, d <= 128).
template <typename T, typename P>
DecArgs dec_plan(int G, int d) {
  DecArgs a{};
  a.d = d;
  const int ng = DEC_NT / (d / 2);  // P.V row groups
  a.R = G;  // the largest divisor of G that leaves a thread <= 8 P.V rows
  while ((a.R + ng - 1) / ng > 8 || G % a.R) --a.R;
  a.TK = d * (int)sizeof(T) <= 128 ? 64 : 32;
  a.pitch = d + 16 / (int)sizeof(T);
  a.rowb = std::is_same<P, int8_t>::value ? (int)up16(d)
                                          : a.pitch * (int)sizeof(T);
  a.chunk = 16;
  return a;
}

__device__ __forceinline__ void cp_n(void* dst, const void* src, bool ok,
                                     int n) {
  if (n == 16)
    dtx_mma::cp16(dst, src, ok);
  else if (n == 8)
    dtx_mma::cp8(dst, src, ok);
  else
    dtx_mma::cp4(dst, src, ok);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The first stage start >= w (stages TK lanes apart, from the split's first
// lane) holding a live table entry in [w, min(w + TK, hi)); hi if none.
// Every thread reads the same entries, so all agree without a barrier.
__device__ __forceinline__ int next_live_lane(const int* trow, int bs, int hi,
                                              int TK, int w) {
  for (; w < hi; w += TK) {
    const int j1 = (min(w + TK, hi) - 1) / bs;
    for (int j = w / bs; j <= j1; ++j)
      if (trow[j] >= 0) return w;
  }
  return hi;
}

// An int8 stage [TK][rowb] with its row scales -> the T tile [TK][pitch]:
// round_T(f32(x) * scale), 8 values a thread at a time.
template <typename T>
__device__ __forceinline__ void dequant_stage(const unsigned char* raw,
                                              const float* sc, T* tile,
                                              const DecArgs& a) {
  const int per = a.d / 8;
  for (int u = threadIdx.x; u < a.TK * per; u += DEC_NT) {
    const int r = u / per, c = (u - r * per) * 8;
    const uint2 v = *reinterpret_cast<const uint2*>(raw + r * a.rowb + c);
    const float s = sc[r];
    float f[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // byte i of each word, sign-extended
      f[i] = __fmul_rn((float)((int)(v.x << (24 - 8 * i)) >> 24), s);
      f[4 + i] = __fmul_rn((float)((int)(v.y << (24 - 8 * i)) >> 24), s);
    }
    T* dst = tile + r * a.pitch + c;
    if constexpr (std::is_same<T, float>::value) {
      float4* o = reinterpret_cast<float4*>(dst);
      o[0] = make_float4(f[0], f[1], f[2], f[3]);
      o[1] = make_float4(f[4], f[5], f[6], f[7]);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(
          dtx_mma::pack_bf16(f[0], f[1]), dtx_mma::pack_bf16(f[2], f[3]),
          dtx_mma::pack_bf16(f[4], f[5]), dtx_mma::pack_bf16(f[6], f[7]));
    }
  }
}

// Two consecutive T values as floats.
template <typename T>
struct Vec2;
template <>
struct Vec2<__nv_bfloat16> {
  __device__ __forceinline__ static float2 ld(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
};
template <>
struct Vec2<float> {
  __device__ __forceinline__ static float2 ld(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
};

template <typename T, typename P>
__global__ void __launch_bounds__(DEC_NT, 2) paged_decode_split_kernel(
    const T* __restrict__ q, const P* __restrict__ kp,
    const P* __restrict__ vp, const float* __restrict__ ksc,
    const float* __restrict__ vsc, const int* __restrict__ tables,
    const int* __restrict__ pos_pool, const int* __restrict__ q_pos,
    T* __restrict__ out, const DecArgs a) {
  namespace cg = cooperative_groups;
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  constexpr int W = Vec16<T>::W;  // T values in 16 bytes
  const float kDead = __int_as_float(0xff800000);  // -inf
  cg::cluster_group cluster = cg::this_cluster();
  const int sp = blockIdx.x, b = blockIdx.z;  // split = rank in the cluster
  const int G = a.H / a.KV, ngrp = G / a.R;
  const int kv = blockIdx.y / ngrp;
  const int h0 = kv * G + (blockIdx.y - kv * ngrp) * a.R;
  const int R = a.R, d = a.d, TK = a.TK, bs = a.bs, S = a.S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const DecSmem L = dec_smem<T, P>(a);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw + L.q);
  float* s_s = reinterpret_cast<float*>(smem_raw + L.s);  // [R][TK + 4]
  float* m_s = reinterpret_cast<float*>(smem_raw + L.m);
  float* l_s = reinterpret_cast<float*>(smem_raw + L.l);
  float* st_s = reinterpret_cast<float*>(smem_raw + L.st);  // [S][R][2]
  int* flag_s = reinterpret_cast<int*>(smem_raw + L.flag);  // [S]
  float* part_s = reinterpret_cast<float*>(smem_raw + L.part);  // [S][CH]
  const int* trow = tables + (size_t)b * a.nbps;
  const int lo = sp * a.E * bs, hi = min(sp * a.E + a.E, a.nbps) * bs;
  const int first = next_live_lane(trow, bs, hi, TK, lo);
  const bool live = first < hi;

  // Stage the TK lanes from ws into ring stage st: the K rows (and a
  // prefetch of the V rows into L2), or the V rows; their positions, live
  // flags and int8 scales.
  auto fill = [&](int ws, int st, bool v_rows) {
    unsigned char* base = smem_raw + L.ring + st * L.stage;
    const P* pool = v_rows ? vp : kp;
    const float* scp = v_rows ? vsc : ksc;
    const int cpr = d * (int)sizeof(P) / a.chunk;  // copies a row
    for (int u = tid; u < TK * cpr; u += DEC_NT) {
      const int r = u / cpr, cc = (u - r * cpr) * a.chunk, w = ws + r;
      const int blk = w < hi ? trow[w / bs] : -1;
      const size_t off =
          blk >= 0 ? (((size_t)blk * bs + w % bs) * a.KV + kv) * d : 0;
      cp_n(base + L.raw + r * a.rowb + cc,
           reinterpret_cast<const unsigned char*>(pool + off) + cc, blk >= 0,
           a.chunk);
      if (!v_rows && blk >= 0 && cc % 128 == 0)
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
            reinterpret_cast<const unsigned char*>(vp + off) + cc));
    }
    for (int r = tid; r < TK; r += DEC_NT) {
      const int w = ws + r;
      const int blk = w < hi ? trow[w / bs] : -1;
      const size_t t = blk >= 0 ? (size_t)blk * bs + w % bs : 0;
      reinterpret_cast<int*>(base + L.live)[r] = blk >= 0;
      dtx_mma::cp4(base + L.pos + 4 * r, pos_pool + t, blk >= 0);
      if (kQuant)
        dtx_mma::cp4(base + L.sc + 4 * r, scp + t * a.KV + kv, blk >= 0);
    }
  };
  // The T tile of ring stage st (int8 rows dequantized into L.t first).
  auto tile = [&](int st) -> const T* {
    unsigned char* base = smem_raw + L.ring + st * L.stage;
    if constexpr (kQuant) {
      dequant_stage<T>(base + L.raw,
                       reinterpret_cast<const float*>(base + L.sc),
                       reinterpret_cast<T*>(smem_raw + L.t), a);
      __syncthreads();
      return reinterpret_cast<const T*>(smem_raw + L.t);
    }
    return reinterpret_cast<const T*>(base + L.raw);
  };

  const int NL = dec_lanes(a), SP = NL + 4;  // score rows' lanes and pitch
  const int qp = q_pos[b];
  const int sw = tid % TK, srg = tid / TK, sstep = DEC_NT / TK;  // scores
  // P.V: a thread owns columns c, c + 1 and heads rg, rg + ng, ...
  const int hd = d / 2, ng = DEC_NT / hd, c = 2 * (tid % hd), rg = tid / hd;
  const int rpt = (R + ng - 1) / ng;

  // phase 0: the split's masked scores (masked live lanes NEG_INF — a fully
  // masked slot gets uniform weights, as in the plain version — dead lanes
  // and skipped stages -inf), then its (m, l) per head
  if (live) {
    fill(first, 0, false);
    dtx_mma::cp_commit();
    const size_t qb = ((size_t)b * a.H + h0) * d;
    for (int i = tid; i < R * d; i += DEC_NT) q_s[i] = to_f<T>(q[qb + i]);
    for (int i = tid; i < R * SP; i += DEC_NT) s_s[i] = kDead;
    for (int it = 0, w0 = first;; ++it) {
      const int st = it & 1;
      dtx_mma::cp_wait<0>();
      __syncthreads();  // stage it has landed; stage it - 1 is consumed
      const int nx = next_live_lane(trow, bs, hi, TK, w0 + TK);
      if (nx < hi) fill(nx, st ^ 1, false);
      dtx_mma::cp_commit();
      const unsigned char* base = smem_raw + L.ring + st * L.stage;
      const bool on = reinterpret_cast<const int*>(base + L.live)[sw] != 0;
      const bool ok =
          on && reinterpret_cast<const int*>(base + L.pos)[sw] <= qp;
      const T* krow = tile(st) + sw * a.pitch;
      for (int r0 = srg; r0 < R; r0 += 2 * sstep) {
        // heads r0 and r0 + sstep, each as two fmaf chains (the even and
        // the odd 16-byte chunks of d), added at the end
        float dot[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
        const float* qr[2];
#pragma unroll
        for (int k = 0; k < 2; ++k)
          qr[k] = q_s + min(r0 + k * sstep, R - 1) * d;
        for (int c2 = 0; c2 < d; c2 += 2 * W)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c0 = c2 + h * W;
            if (c0 >= d) break;
            float kf[W];
            Vec16<T>::cvt(*reinterpret_cast<const uint4*>(krow + c0), kf);
#pragma unroll
            for (int k = 0; k < 2; ++k)
#pragma unroll
              for (int i = 0; i < W / 4; ++i) {
                const float4 x =
                    reinterpret_cast<const float4*>(qr[k] + c0)[i];
                float& t = dot[k][h];
                t = fmaf(x.x, kf[4 * i], t);
                t = fmaf(x.y, kf[4 * i + 1], t);
                t = fmaf(x.z, kf[4 * i + 2], t);
                t = fmaf(x.w, kf[4 * i + 3], t);
              }
          }
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int r = r0 + k * sstep;
          if (r < R)
            s_s[r * SP + w0 - lo + sw] =
                !on ? kDead
                    : ok ? (dot[k][0] + dot[k][1]) * a.scale : DTX_NEG_INF;
        }
      }
      if (nx >= hi) break;
      w0 = nx;
    }
    __syncthreads();  // the scores are all in; the ring is free
    fill(first, 0, true);  // phase 1's first V stage flies over the barrier
    dtx_mma::cp_commit();
    for (int r = warp; r < R; r += DEC_NT / 32) {
      const float* sr = s_s + r * SP;
      float mx = kDead;
      for (int w = lane; w < NL; w += 32) mx = fmaxf(mx, sr[w]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int w = lane; w < NL; w += 32) sum += expf(sr[w] - mx);
      sum = warp_sum(sum);
      if (lane == 0) {
        m_s[r] = mx;
        l_s[r] = sum;
      }
    }
  } else {
    for (int r = tid; r < R; r += DEC_NT) {
      m_s[r] = DTX_NEG_INF;
      l_s[r] = 0.f;
    }
  }
  __syncthreads();
  // into every block of the cluster: this split's (m, l) and live flag
  for (int i = tid; i < S * R; i += DEC_NT) {
    const int j = i / R, r = i - j * R;
    *reinterpret_cast<float2*>(cluster.map_shared_rank(st_s, j) +
                               (sp * R + r) * 2) = make_float2(m_s[r], l_s[r]);
  }
  if (tid < S) cluster.map_shared_rank(flag_s, tid)[sp] = live;
  cluster.sync();

  // phase 1: the merge, in split order (a warp a head: the max over the
  // splits, exact in any order; then l in split order), p rounded to T
  // over the stored scores, then the split's partial over its V stages
  if (live) {
    for (int r = warp; r < R; r += DEC_NT / 32) {
      // lane s takes split s's (m, l); S <= 32
      const float2 e = lane < S ? *reinterpret_cast<const float2*>(
                                      st_s + (lane * R + r) * 2)
                                : make_float2(DTX_NEG_INF, 0.f);
      const float mx = warp_max(e.x);
      // each split's l * exp(m_s - m), summed in split order (scratch: the
      // head's score row, rewritten only after this merge)
      float* tm = s_s + r * SP;
      const float own = tm[lane];
      tm[lane] = e.y * expf(e.x - mx);
      __syncwarp();
      if (lane == 0) {
        float ll = 0.f;
        for (int s = 0; s < S; ++s) ll += tm[s];
        m_s[r] = mx;
        l_s[r] = fmaxf(ll, 1e-30f);
      }
      __syncwarp();
      tm[lane] = own;
    }
    __syncthreads();
    for (int i = tid; i < R * NL; i += DEC_NT) {
      const int r = i / NL, w = i - r * NL;
      float* e = s_s + r * SP + w;
      *e = round_to<T>(expf(*e - m_s[r]) / l_s[r]);
    }
    float acc[8][2][2];  // [head][column][lanes w % 4 < 2, >= 2]
#pragma unroll
    for (int k = 0; k < 8; ++k)
      acc[k][0][0] = acc[k][0][1] = acc[k][1][0] = acc[k][1][1] = 0.f;
    for (int it = 0, w0 = first;; ++it) {
      const int st = it & 1;
      dtx_mma::cp_wait<0>();
      __syncthreads();  // stage it has landed; stage it - 1 is consumed
      const int nx = next_live_lane(trow, bs, hi, TK, w0 + TK);
      if (nx < hi) fill(nx, st ^ 1, true);
      dtx_mma::cp_commit();
      const T* vt = tile(st);
      if (rg < ng) {
        const float* ps = s_s + w0 - lo;
        for (int w = 0; w < TK; w += 4) {
          float2 v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            v[i] = Vec2<T>::ld(vt + (w + i) * a.pitch + c);
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            if (k >= rpt) break;
            const float4 p = *reinterpret_cast<const float4*>(
                ps + min(rg + k * ng, R - 1) * SP + w);
            acc[k][0][0] = fmaf(p.x, v[0].x, acc[k][0][0]);
            acc[k][1][0] = fmaf(p.x, v[0].y, acc[k][1][0]);
            acc[k][0][1] = fmaf(p.z, v[2].x, acc[k][0][1]);
            acc[k][1][1] = fmaf(p.z, v[2].y, acc[k][1][1]);
            acc[k][0][0] = fmaf(p.y, v[1].x, acc[k][0][0]);
            acc[k][1][0] = fmaf(p.y, v[1].y, acc[k][1][0]);
            acc[k][0][1] = fmaf(p.w, v[3].x, acc[k][0][1]);
            acc[k][1][1] = fmaf(p.w, v[3].y, acc[k][1][1]);
          }
        }
      }
      if (nx >= hi) break;
      w0 = nx;
    }
    // each output of the partial into the block that sums it
    const int n = R * d, ch = dec_share(a);
    if (rg < ng)
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int r = rg + k * ng;
        if (k >= rpt || r >= R) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = r * d + c + e, j = ((i + 1) * S - 1) / n;
          cluster.map_shared_rank(part_s, j)[sp * ch + i - j * n / S] =
              acc[k][e][0] + acc[k][e][1];
        }
      }
  }
  cluster.sync();  // the pushes have landed; nothing reads another block

  // the sum: this block's outputs [sp n / S, (sp + 1) n / S) of the
  // group's n = R d, each over the live splits in split order
  const int n = R * d, ch = dec_share(a), i0 = sp * n / S;
  const int i1 = (sp + 1) * n / S;
  const size_t ob = ((size_t)b * a.H + h0) * d;
  for (int i = i0 + tid; i < i1; i += DEC_NT) {
    float sum = 0.f;
    for (int s = 0; s < S; ++s)
      if (flag_s[s]) sum += part_s[s * ch + i - i0];
    out[ob + i] = from_f<T>(sum);
  }
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

// K7: one launch, a cluster of the S split blocks of each (slot, head
// group).
template <typename T, typename P>
int launch_decode(const void* q, const void* k_pool, const void* v_pool,
                  const float* k_scale, const float* v_scale,
                  const int* tables, const int* pos_pool, const int* q_pos,
                  void* out, int B, int H, int KV, int d, int bs, int nbps,
                  int S, int E, float scale, cudaStream_t stream) {
  if (d % 8 || d > DEC_NT || KV <= 0 || H % KV || S < 1 ||
      S > DEC_MAX_SPLITS || E < 1)
    return (int)cudaErrorInvalidValue;
  DecArgs a = dec_plan<T, P>(H / KV, d);
  a.H = H, a.KV = KV, a.bs = bs, a.nbps = nbps, a.S = S, a.E = E;
  a.scale = scale;
  // the widest copy that a pool row and the pools' alignment allow
  const int rb = d * (int)sizeof(P);
  while (a.chunk > 4 && (rb % a.chunk || (uintptr_t)k_pool % a.chunk ||
                         (uintptr_t)v_pool % a.chunk))
    a.chunk /= 2;
  if (rb % a.chunk || (uintptr_t)k_pool % a.chunk ||
      (uintptr_t)v_pool % a.chunk)
    return (int)cudaErrorMisalignedAddress;
  auto kern = paged_decode_split_kernel<T, P>;
  const size_t smem = dec_smem<T, P>(a).total;
  if (int e = set_smem(kern, smem)) return e;
  if (S > 8)
    if (int e = (int)cudaFuncSetAttribute(
            kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1))
      return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, KV * (H / KV / a.R), B);
  cfg.blockDim = dim3(DEC_NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (int e = (int)cudaLaunchKernelEx(
          &cfg, kern, (const T*)q, (const P*)k_pool, (const P*)v_pool,
          k_scale, v_scale, tables, pos_pool, q_pos, (T*)out, a))
    return e;
  return (int)cudaGetLastError();
}

// What the bf16 K7 takes of an SM for G heads a KV head at head dim d:
// registers, local (spill) bytes per thread, dynamic shared bytes per block
// and resident blocks per SM (out[0..3] over bf16 pools, out[4..7] over
// int8 pools).
template <typename P>
int decode_resources_p(int G, int d, int* out) {
  const DecArgs a = dec_plan<__nv_bfloat16, P>(G, d);
  auto kern = paged_decode_split_kernel<__nv_bfloat16, P>;
  const size_t smem = dec_smem<__nv_bfloat16, P>(a).total;
  cudaFuncAttributes fa;
  if (int e = (int)cudaFuncGetAttributes(&fa, kern)) return e;
  if (int e = set_smem(kern, smem)) return e;
  int blocks = 0;
  if (int e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kern, DEC_NT, smem))
    return e;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)smem;
  out[3] = blocks;
  return 0;
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

extern "C" int dtx_paged_decode_resources(int d, int G, int* out) {
  if (d % 8 || d > DEC_NT || G < 1) return (int)cudaErrorInvalidValue;
  if (int e = decode_resources_p<__nv_bfloat16>(G, d, out)) return e;
  return decode_resources_p<int8_t>(G, d, out + 4);
}

// Pools in the compute dtype (SUFFIX bf16/f32) and int8 pools with their
// scale pools (i8_bf16/i8_f32).
#define DTX_PAGED_ENTRIES(SUFFIX, T)                                          \
  extern "C" int dtx_paged_decode_##SUFFIX(                                   \
      const void* q, const void* k_pool, const void* v_pool,                  \
      const void* tables, const void* pos_pool, const void* q_pos,            \
      void* out, int B, int H, int KV, int d, int bs, int nbps, int S, int E, \
      float scale, void* stream) {                                            \
    return launch_decode<T, T>(                                               \
        q, k_pool, v_pool, nullptr, nullptr, (const int*)tables,              \
        (const int*)pos_pool, (const int*)q_pos, out, B, H, KV, d, bs, nbps,  \
        S, E, scale, (cudaStream_t)stream);                                   \
  }                                                                           \
  extern "C" int dtx_paged_decode_i8_##SUFFIX(                                \
      const void* q, const void* k_pool, const void* v_pool,                  \
      const void* k_scale, const void* v_scale, const void* tables,           \
      const void* pos_pool, const void* q_pos, void* out, int B, int H,       \
      int KV, int d, int bs, int nbps, int S, int E, float scale,             \
      void* stream) {                                                         \
    return launch_decode<T, int8_t>(                                          \
        q, k_pool, v_pool, (const float*)k_scale, (const float*)v_scale,      \
        (const int*)tables, (const int*)pos_pool, (const int*)q_pos, out, B,  \
        H, KV, d, bs, nbps, S, E, scale, (cudaStream_t)stream);               \
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
