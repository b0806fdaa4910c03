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
//
// A rank of a sharded run draws its block of the global draw: the element
// counter is `offset + i0 * s0 + i1 * s1 + i2` over the block's local
// shape [n / (n1 * n2), n1, n2] (the wrapper collapses a block of a
// row-major array to at most three such dims). The kernels are templated
// on the layout: the whole draw (offset 0, one dim; every unsharded draw)
// takes the counter `e` and so the instruction stream it had before blocks
// existed, a contiguous range (a data-parallel rank's rows) `offset + e`,
// and a strided block (a sequence chunk, a column shard) pays two 32-bit
// divisions an element.

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

// Where element e of the block sits in the global draw.
enum Layout { kWhole, kRange, kBlock };

struct Index {
  uint64_t offset;
  uint32_t n1, n2;  // the block's inner dims (n2 innermost)
  uint64_t s0, s1;  // global strides of the outer two dims
};

template <int L>
__device__ __forceinline__ uint64_t counter(const Index& ix, uint64_t e) {
  if (L == kWhole) return e;
  if (L == kRange) return ix.offset + e;
  const uint32_t el = static_cast<uint32_t>(e);
  const uint32_t row = el / ix.n2;
  const uint32_t i2 = el - row * ix.n2;
  const uint32_t i0 = row / ix.n1;
  const uint32_t i1 = row - i0 * ix.n1;
  return ix.offset + i0 * ix.s0 + i1 * ix.s1 + i2;
}

template <int L>
__global__ void threefry_bernoulli_kernel(uint32_t k0, uint32_t k1,
                                          uint64_t n, float p, Index ix,
                                          uint8_t* __restrict__ out) {
  const uint64_t quads = n / 4;
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t q = static_cast<uint64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
       q < quads; q += stride) {
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t keep =
          unit_float(bits_at(k0, k1, counter<L>(ix, 4 * q + j))) < p;
      word |= keep << (8 * j);
    }
    reinterpret_cast<uint32_t*>(out)[q] = word;
  }
  if (blockIdx.x == 0 && threadIdx.x < n % 4) {
    const uint64_t i = 4 * quads + threadIdx.x;
    out[i] = unit_float(bits_at(k0, k1, counter<L>(ix, i))) < p;
  }
}

template <int L>
__global__ void threefry_uniform_kernel(uint32_t k0, uint32_t k1, uint64_t n,
                                        float lo, float span, Index ix,
                                        float* __restrict__ out) {
  const uint64_t quads = n / 4;
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t q = static_cast<uint64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
       q < quads; q += stride) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float u = unit_float(bits_at(k0, k1, counter<L>(ix, 4 * q + j)));
      v[j] = fmaxf(fmaf(u, span, lo), lo);
    }
    reinterpret_cast<float4*>(out)[q] = make_float4(v[0], v[1], v[2], v[3]);
  }
  if (blockIdx.x == 0 && threadIdx.x < n % 4) {
    const uint64_t i = 4 * quads + threadIdx.x;
    const float u = unit_float(bits_at(k0, k1, counter<L>(ix, i)));
    out[i] = fmaxf(fmaf(u, span, lo), lo);
  }
}

constexpr int kThreads = 256;

int grid_for(uint64_t n) {
  const uint64_t quads = n / 4 + 1;
  const uint64_t blocks = (quads + kThreads - 1) / kThreads;
  // enough blocks to fill 132 SMs many times over; the loop covers the rest
  return static_cast<int>(blocks < 132 * 32 ? blocks : 132 * 32);
}

Index make_index(long long offset, long long n1, long long n2,
                 long long s0, long long s1, long long n, int* layout) {
  Index ix;
  ix.offset = static_cast<uint64_t>(offset);
  ix.n1 = static_cast<uint32_t>(n1 > 0 ? n1 : 1);
  ix.n2 = static_cast<uint32_t>(n2 > 0 ? n2 : n);
  ix.s0 = static_cast<uint64_t>(s0);
  ix.s1 = static_cast<uint64_t>(s1);
  const bool contiguous = n2 <= 0 || (n1 <= 1 && n2 == n);
  *layout = !contiguous ? kBlock : offset != 0 ? kRange : kWhole;
  return ix;
}

}  // namespace

// `offset`, `n1`, `n2`, `s0`, `s1`: the block's place in the global draw
// (see Index); offset 0 with n1 = 1 and n2 = n is the whole draw. A
// strided block counts its elements in 32 bits.
extern "C" int dtx_threefry_bernoulli(uint32_t k0, uint32_t k1, long long n,
                                      float p, long long offset, long long n1,
                                      long long n2, long long s0,
                                      long long s1, void* out, void* stream) {
  if (n <= 0) return 0;
  int layout;
  const Index ix = make_index(offset, n1, n2, s0, s1, n, &layout);
  if (layout == kBlock && n >= (1LL << 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const uint64_t m = static_cast<uint64_t>(n);
  auto* o = static_cast<uint8_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const int g = grid_for(m);
  switch (layout) {
    case kWhole:
      threefry_bernoulli_kernel<kWhole><<<g, kThreads, 0, st>>>(k0, k1, m, p,
                                                                ix, o);
      break;
    case kRange:
      threefry_bernoulli_kernel<kRange><<<g, kThreads, 0, st>>>(k0, k1, m, p,
                                                                ix, o);
      break;
    default:
      threefry_bernoulli_kernel<kBlock><<<g, kThreads, 0, st>>>(k0, k1, m, p,
                                                                ix, o);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dtx_threefry_uniform(uint32_t k0, uint32_t k1, long long n,
                                    float lo, float span, long long offset,
                                    long long n1, long long n2, long long s0,
                                    long long s1, void* out, void* stream) {
  if (n <= 0) return 0;
  int layout;
  const Index ix = make_index(offset, n1, n2, s0, s1, n, &layout);
  if (layout == kBlock && n >= (1LL << 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const uint64_t m = static_cast<uint64_t>(n);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const int g = grid_for(m);
  switch (layout) {
    case kWhole:
      threefry_uniform_kernel<kWhole><<<g, kThreads, 0, st>>>(k0, k1, m, lo,
                                                              span, ix, o);
      break;
    case kRange:
      threefry_uniform_kernel<kRange><<<g, kThreads, 0, st>>>(k0, k1, m, lo,
                                                              span, ix, o);
      break;
    default:
      threefry_uniform_kernel<kBlock><<<g, kThreads, 0, st>>>(k0, k1, m, lo,
                                                              span, ix, o);
  }
  return static_cast<int>(cudaGetLastError());
}
