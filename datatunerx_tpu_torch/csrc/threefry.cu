// The threefry2x32 bits of jax.random (partitionable layout) for one key
// over n elements, written out as a LoRA-dropout keep mask
// (bernoulli: uniform < p) or as float32 uniforms in [lo, lo + span) (the
// NEFTune noise). Integer-exact against the plain version in ops/prng.py
// (int64 torch ops), which is jax.random's twin bit for bit.
//
// Replaces no Pallas kernel: on the TPU, XLA fuses the threefry rounds of
// jax.random.bernoulli / uniform (datatunerx_tpu/models/llama.py:120-122,
// :226-233) into the ops around them. The plain version is some fifty
// int64 elementwise launches a draw, each moving 8 bytes an element.
//
// Bound: 32-bit integer work. An element costs the 20 threefry rounds (add,
// rotate, xor), six key injections and the float conversion, about 76
// operations, against 1 byte (mask) or 4 bytes (uniform) written; nothing
// is read. Design: one thread computes four consecutive elements (counter
// = the flattened index, split into its high and low words as JAX does)
// and writes them with one 4- or 16-byte store; a grid-stride loop covers
// any n, and the ragged tail (n % 4) takes scalar stores.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Threefry-2x32, 20 rounds (Random123), as ops/prng.threefry2x32.
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  const uint32_t ks[3] = {k0, k1, k2};
  x0 += k0;
  x1 += k1;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int r0 = (i % 2) ? 17 : 13, r1 = (i % 2) ? 29 : 15;
    const int r2 = (i % 2) ? 16 : 26, r3 = (i % 2) ? 24 : 6;
    x0 += x1; x1 = rotl(x1, r0) ^ x0;
    x0 += x1; x1 = rotl(x1, r1) ^ x0;
    x0 += x1; x1 = rotl(x1, r2) ^ x0;
    x0 += x1; x1 = rotl(x1, r3) ^ x0;
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return x0 ^ x1;
}

// jax.random.uniform's float in [0, 1): the top 23 bits as a mantissa.
__device__ __forceinline__ float unit_float(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

__device__ __forceinline__ uint32_t bits_at(uint32_t k0, uint32_t k1,
                                            uint64_t i) {
  return threefry_bits(k0, k1, static_cast<uint32_t>(i >> 32),
                       static_cast<uint32_t>(i));
}

__global__ void threefry_bernoulli_kernel(uint32_t k0, uint32_t k1,
                                          uint64_t n, float p,
                                          uint8_t* __restrict__ out) {
  const uint64_t quads = n / 4;
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t q = static_cast<uint64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
       q < quads; q += stride) {
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t keep = unit_float(bits_at(k0, k1, 4 * q + j)) < p;
      word |= keep << (8 * j);
    }
    reinterpret_cast<uint32_t*>(out)[q] = word;
  }
  if (blockIdx.x == 0 && threadIdx.x < n % 4) {
    const uint64_t i = 4 * quads + threadIdx.x;
    out[i] = unit_float(bits_at(k0, k1, i)) < p;
  }
}

__global__ void threefry_uniform_kernel(uint32_t k0, uint32_t k1, uint64_t n,
                                        float lo, float span,
                                        float* __restrict__ out) {
  const uint64_t quads = n / 4;
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t q = static_cast<uint64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
       q < quads; q += stride) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = fmaxf(fmaf(unit_float(bits_at(k0, k1, 4 * q + j)), span, lo),
                   lo);
    }
    reinterpret_cast<float4*>(out)[q] = make_float4(v[0], v[1], v[2], v[3]);
  }
  if (blockIdx.x == 0 && threadIdx.x < n % 4) {
    const uint64_t i = 4 * quads + threadIdx.x;
    out[i] = fmaxf(fmaf(unit_float(bits_at(k0, k1, i)), span, lo), lo);
  }
}

constexpr int kThreads = 256;

int grid_for(uint64_t n) {
  const uint64_t quads = n / 4 + 1;
  const uint64_t blocks = (quads + kThreads - 1) / kThreads;
  // enough blocks to fill 132 SMs many times over; the loop covers the rest
  return static_cast<int>(blocks < 132 * 32 ? blocks : 132 * 32);
}

}  // namespace

extern "C" int dtx_threefry_bernoulli(uint32_t k0, uint32_t k1, long long n,
                                      float p, void* out, void* stream) {
  if (n <= 0) return 0;
  threefry_bernoulli_kernel<<<grid_for(n), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      k0, k1, static_cast<uint64_t>(n), p, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dtx_threefry_uniform(uint32_t k0, uint32_t k1, long long n,
                                    float lo, float span, void* out,
                                    void* stream) {
  if (n <= 0) return 0;
  threefry_uniform_kernel<<<grid_for(n), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      k0, k1, static_cast<uint64_t>(n), lo, span, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
