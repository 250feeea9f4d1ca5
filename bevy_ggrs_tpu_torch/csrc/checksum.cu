// Entity checksum kernel: per slot two murmur3 chains over a word column,
// fmix, alive mask, wrapping sum into two u32 lanes per batch row.
//
// Replaces the Pallas kernel bevy_ggrs_tpu/ops/checksum.py::_entity_hash_sum
// (kernel body _hash_kernel). Bitwise equal to its plain PyTorch version,
// bevy_ggrs_tpu_torch/ops/checksum.py::_entity_hash_sum_plain, and so to
// bevy_ggrs_tpu/state.py::checksum once the resource hash is added.
//
// What bounds it on an H100: device-memory bytes. Each word is read once
// and costs about twenty integer operations for both lanes, far below the
// card's operations-per-byte line. At the main path's shape (one world of
// 1,024 slots x 9 words, about 41 KB) the bound is about 12 ns, so the
// launch itself dominates.
//
// Design: one thread per (batch row, slot), slot the fastest axis, so a
// warp's loads of one word row are 128 contiguous bytes. The word chain of
// both lanes runs in registers as uint32_t arithmetic, which wraps exactly
// like the JAX and plain versions. Dead slots skip their loads. Each warp
// reduces its lanes with shuffles and adds them to out[b] with one integer
// atomicAdd per lane: a wrapping integer sum is order-free, so the result
// is bitwise the same whatever order the warps land in. The batch axis
// (blockIdx.y) carries ring rows in one launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kC1 = 0xCC9E2D51u;
constexpr uint32_t kC2 = 0x1B873593u;
constexpr uint32_t kSeed = 0x9747B28Cu;
constexpr uint32_t kHiTweak = 0x9E3779B9u;
constexpr int kBlock = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t mix_one(uint32_t h, uint32_t w) {
  uint32_t k = w * kC1;
  k = rotl(k, 15) * kC2;
  h ^= k;
  return rotl(h, 13) * 5u + 0xE6546B64u;
}

__device__ __forceinline__ uint32_t fmix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// words: u32[B, W, cap]; alive: u8[B, cap]; out: u32[B, 2], zeroed.
__global__ void entity_hash_sum_kernel(const uint32_t* __restrict__ words,
                                       const uint8_t* __restrict__ alive,
                                       uint32_t* __restrict__ out, int W,
                                       int cap) {
  const size_t b = blockIdx.y;
  const int slot = blockIdx.x * kBlock + threadIdx.x;
  uint32_t lo = 0, hi = 0;
  if (slot < cap && alive[b * cap + slot]) {
    const uint32_t* col = words + b * W * cap + slot;
    uint32_t h0 = kSeed, h1 = kSeed ^ kHiTweak;
    for (int i = 0; i < W; ++i) {
      const uint32_t w = __ldg(col + (size_t)i * cap);
      h0 = mix_one(h0, w);
      h1 = mix_one(h1, w);
    }
    lo = fmix(h0);
    hi = fmix(h1);
  }
  for (int off = 16; off > 0; off >>= 1) {
    lo += __shfl_xor_sync(0xffffffffu, lo, off);
    hi += __shfl_xor_sync(0xffffffffu, hi, off);
  }
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(out + 2 * b, lo);
    atomicAdd(out + 2 * b + 1, hi);
  }
}

}  // namespace

extern "C" int ggrs_entity_hash_sum(const void* words, const void* alive,
                                    void* out, int B, int W, int cap,
                                    void* stream) {
  const dim3 grid((cap + kBlock - 1) / kBlock, B);
  entity_hash_sum_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const uint8_t*)alive, (uint32_t*)out, W, cap);
  return (int)cudaGetLastError();
}
