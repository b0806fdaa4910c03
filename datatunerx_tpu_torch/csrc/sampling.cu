// Fused sampling epilogue: one token id per row of pre-scaled logits (K9).
//
// Replaces (TPU kernel):
//   K9  datatunerx_tpu/ops/pallas_sampling.py::_sample_kernel
//       (entered via _kernel_sample / fused_sample / sample_rows)
//
// What bounds it on an H100: bytes, and at decode sizes launch latency.
// Per row it reads the [Vp] f32 logits (128 KB for V = 32000) once per
// phase and does a handful of flops per element; the whole call moves a few
// hundred KB, which the card streams in well under a microsecond.
//
// What the design does about it: one thread block per row, three block-wide
// passes over the row with no intermediate ever written to device memory
// (the [S, vocab] distribution never exists): (1) the max with the
// first-index tie rule — every thread keeps its strictly-greater maximum
// over its strided lanes, and the block reduction prefers the smaller index
// on equal values, which is torch.argmax's and jnp.argmax's first-maximum
// rule; (2) Z = sum exp(x - m); (3) each thread owns a contiguous chunk of
// the row, a block-wide exclusive scan of the chunk sums gives each chunk's
// running-CDF offset, and the first lane whose running sum exceeds u*Z wins
// (block min over the chunks' first crossings). No crossing (u*Z at the
// float tail) falls back to the argmax; rows with temp <= 0 and greedy mode
// stop after pass 1. The uniforms u arrive as an operand, exactly as the TPU
// kernel takes them, so tests feed kernel and plain version the same draws.

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>

#define DTX_NEG_INF (-1e30f)
#define DTX_SAMPLE_THREADS 1024

namespace {

__device__ __forceinline__ void argmax_pair(float& m, int& i, float m2,
                                            int i2) {
  if (m2 > m || (m2 == m && i2 < i)) {
    m = m2;
    i = i2;
  }
}

// block-wide (max, first index); every thread gets the result
__device__ void block_argmax(float& m, int& idx, float* sm, int* si) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_down_sync(0xffffffffu, m, off);
    const int i2 = __shfl_down_sync(0xffffffffu, idx, off);
    argmax_pair(m, idx, m2, i2);
  }
  if (lane == 0) {
    sm[warp] = m;
    si[warp] = idx;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    m = lane < nw ? sm[lane] : DTX_NEG_INF;
    idx = lane < nw ? si[lane] : INT_MAX;
    for (int off = 16; off > 0; off >>= 1) {
      const float m2 = __shfl_down_sync(0xffffffffu, m, off);
      const int i2 = __shfl_down_sync(0xffffffffu, idx, off);
      argmax_pair(m, idx, m2, i2);
    }
    if (lane == 0) {
      sm[0] = m;
      si[0] = idx;
    }
  }
  __syncthreads();
  m = sm[0];
  idx = si[0];
  __syncthreads();
}

__device__ float block_sum(float v, float* sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) sm[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    v = lane < nw ? sm[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) sm[0] = v;
  }
  __syncthreads();
  v = sm[0];
  __syncthreads();
  return v;
}

// exclusive prefix sum over threads, in thread order
__device__ float block_exclusive_scan(float v, float* sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float inc = v;
  for (int off = 1; off < 32; off <<= 1) {
    const float n = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += n;
  }
  if (lane == 31) sm[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    float w = lane < nw ? sm[lane] : 0.f;
    for (int off = 1; off < 32; off <<= 1) {
      const float n = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += n;
    }
    if (lane < nw) sm[lane] = w;  // inclusive per-warp totals
  }
  __syncthreads();
  const float warp_off = warp > 0 ? sm[warp - 1] : 0.f;
  __syncthreads();
  return warp_off + inc - v;
}

__device__ int block_min(int v, int* si) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_down_sync(0xffffffffu, v, off));
  if (lane == 0) si[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    v = lane < nw ? si[lane] : INT_MAX;
    for (int off = 16; off > 0; off >>= 1)
      v = min(v, __shfl_down_sync(0xffffffffu, v, off));
    if (lane == 0) si[0] = v;
  }
  __syncthreads();
  v = si[0];
  __syncthreads();
  return v;
}

__global__ void fused_sample_kernel(const float* __restrict__ x,
                                    const float* __restrict__ temps,
                                    const float* __restrict__ us,
                                    int* __restrict__ out, int Vp,
                                    int greedy) {
  __shared__ float sm[32];
  __shared__ int si[32];
  const int row = blockIdx.x;
  const float* xr = x + (size_t)row * Vp;

  // pass 1: max and its first index
  float m = DTX_NEG_INF;
  int idx = 0;
  for (int i = threadIdx.x; i < Vp; i += blockDim.x) {
    const float v = xr[i];
    if (v > m) {
      m = v;
      idx = i;
    }
  }
  block_argmax(m, idx, sm, si);
  if (greedy || temps[row] <= 0.f) {
    if (threadIdx.x == 0) out[row] = idx;
    return;
  }

  // pass 2: the normaliser
  float z = 0.f;
  for (int i = threadIdx.x; i < Vp; i += blockDim.x) z += expf(xr[i] - m);
  z = block_sum(z, sm);
  const float thresh = us[row] * z;

  // pass 3: first crossing of the running CDF over contiguous chunks
  const int chunk = (Vp + blockDim.x - 1) / blockDim.x;
  const int lo = min(Vp, (int)threadIdx.x * chunk);
  const int hi = min(Vp, lo + chunk);
  float own = 0.f;
  for (int i = lo; i < hi; ++i) own += expf(xr[i] - m);
  float cum = block_exclusive_scan(own, sm);
  int first = INT_MAX;
  for (int i = lo; i < hi; ++i) {
    cum += expf(xr[i] - m);
    if (cum > thresh) {
      first = i;
      break;
    }
  }
  first = block_min(first, si);
  if (threadIdx.x == 0) out[row] = first != INT_MAX ? first : idx;
}

}  // namespace

extern "C" int dtx_fused_sample(const void* x, const void* temps,
                                const void* us, void* out, int S, int Vp,
                                int greedy, void* stream) {
  fused_sample_kernel<<<S, DTX_SAMPLE_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)temps, (const float*)us, (int*)out, Vp,
      greedy);
  return (int)cudaGetLastError();
}
