// World checksum kernel: per slot two murmur3 chains over the world's own
// tensors, fmix, alive mask, wrapping sum into two u32 lanes per world row,
// plus the position-keyed resource hash; in save mode also the ring row's
// copy, frame and digest, in guard mode the check of a ring row in place.
//
// Replaces the Pallas kernel bevy_ggrs_tpu/ops/checksum.py::_entity_hash_sum
// (kernel body _hash_kernel) together with the word matrix and the resource
// hash that XLA fuses around it there. Bitwise equal to its plain PyTorch
// versions, bevy_ggrs_tpu_torch/ops/checksum.py::checksum_plain, save_plain
// and guard_plain, and so to bevy_ggrs_tpu/state.py::checksum.
//
// What bounds it on an H100: not the bytes. Each word is read once and
// costs about twenty integer operations for both lanes, far below the
// card's operations-per-byte line; one boids-1,024 world is 28,676 bytes
// (8.6 ns at 3.35 TB/s, twice that for a save, which writes them again).
// At the main path's shape the time is the launch (about 3 us with the
// cluster's barriers and reductions) and the walk's instruction issue on
// the few SMs a row runs on. So the design does everything in one launch,
// nothing around it, and spreads a row over up to 8 SMs.
//
// Design: the parameter struct, passed by value (__grid_constant__), lists
// the parts in mixing order: rollback id, per sorted component its
// presence row and its words, the alive row, the resource leaves. Each
// gives its pointer, bytes a world row, u32 words a slot and how a word is
// read (1, 2 or 4 bytes, bool as 0/1; an 8-byte element is two 4-byte
// words, low first). Each block copies the part table to shared memory
// first. A world row runs on a cluster of P blocks of T threads (P = 1 ..
// 8, T up to 1,024; ops/checksum.py launch_shape: up to 128 slots a block
// before P doubles, then a thread a slot); block `rank` walks the
// contiguous slots [rank cap / P, (rank + 1) cap / P), each thread kUnroll
// slots at once. Dead slots load nothing. The walk goes part by part, the
// word size's branch and the slot's address hoisted out of the word loop;
// a component's words are loaded whatever its presence, so no load waits
// on another, and masked by the presence bit in registers. Threads of the
// first block hash the resource words, strided. Each block reduces its
// lanes with shuffles and one shared-memory step; after cluster.sync()
// rank 0 adds the P blocks' lanes through distributed shared memory in
// ascending rank and the resources' constant term, and writes the row's
// lanes as int64 values in [0, 2^32): no zeroed output, no atomics. All
// sums are wrapping integer sums, so every order gives the same bits; no
// float is used. The batch axis (ring rows, [S, depth] stacks) runs over
// the grid.
//
// Save mode copies every part's bytes into the ring row (16-byte vectors
// where both sides are aligned, bytes otherwise) with all threads of the
// cluster, and writes the row's frame and digest and the caller's output.
// Guard mode hashes a ring row through pointers the host offset to it, and
// writes 1 when the row does not hold the frame or its digest equals the
// stored one, else 0.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

constexpr uint32_t kC1 = 0xCC9E2D51u;
constexpr uint32_t kC2 = 0x1B873593u;
constexpr uint32_t kSeed = 0x9747B28Cu;
constexpr uint32_t kHiTweak = 0x9E3779B9u;
constexpr int kMaxThreads = 1024;  // threads of a block at most
constexpr int kUnroll = 4;

enum Role : int { kWords = 0, kPresence = 1, kComponent = 2, kAlive = 3, kResource = 4 };
enum Mode : int { kChecksum = 0, kSave = 1, kGuard = 2 };

// Field for field the ctypes structures of ops/checksum.py.
struct Part {
  const unsigned char* src;  // the first world row's first byte
  unsigned char* dst;        // save: the ring row's first byte
  long long row_bytes;       // bytes of one world row
  int words;                 // u32 words a slot (a world row for a resource)
  int word_bytes;            // 1, 2 or 4
  int role;
  int is_bool;
  uint32_t seed_lo, seed_hi;  // resource: lane seeds xor the name seed
  int base;                   // resource: position of its first word
  int first;                  // resource: index among all resource words
};

struct Header {
  long long* lanes;        // checksum: [B, 2]; save: the returned [2]
  long long* lanes_ring;   // save: ring.checksums[slot]
  long long* lanes_out;    // save: the caller's out, or null
  int* frame_out;          // save: ring.frames[slot]
  const long long* expect; // guard: ring.checksums[row]
  const int* frames_row;   // guard: ring.frames[row]
  int* flag;               // guard: 1 clean or not resident, 0 corrupt
  int n_parts, cap, mode, frame, resource_words, alive_part, first_resource;
  uint32_t const_lo, const_hi;  // the resources' constant terms, summed
};

template <int K>
struct Params {
  Header h;
  Part parts[K];
};

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

// Word i of a row, as state.py::_to_u32_words makes it.
__device__ __forceinline__ uint32_t load_word(const unsigned char* row,
                                              long long i, int word_bytes,
                                              int is_bool) {
  if (word_bytes == 4) return __ldg(reinterpret_cast<const uint32_t*>(row) + i);
  if (word_bytes == 2)
    return __ldg(reinterpret_cast<const unsigned short*>(row) + i);
  const uint32_t b = __ldg(row + i);
  return is_bool ? (uint32_t)(b != 0) : b;
}

__device__ void copy_bytes(unsigned char* dst, const unsigned char* src,
                           long long n, int t, int stride) {
  long long done = 0;
  if ((((uintptr_t)dst | (uintptr_t)src) & 15) == 0) {
    const long long v = n / 16;
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (long long k = t; k < v; k += stride) d[k] = __ldg(s + k);
    done = v * 16;
  }
  for (long long k = done + t; k < n; k += stride) dst[k] = __ldg(src + k);
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int K>
__global__ void __launch_bounds__(kMaxThreads)
    world_checksum_kernel(const __grid_constant__ Params<K> p) {
  __shared__ Part s_parts[K];
  __shared__ uint32_t s_warp[kMaxThreads / 32][2];
  __shared__ uint32_t s_block[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int P = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const Header& h = p.h;
  const int T = (int)blockDim.x;
  for (int i = threadIdx.x; i < h.n_parts; i += T) s_parts[i] = p.parts[i];
  __syncthreads();
  const long long b = blockIdx.x / P;  // the world row
  const int s0 = (int)((long long)rank * h.cap / P);
  const int s1 = (int)((long long)(rank + 1) * h.cap / P);
  const int n = h.first_resource;  // the entity parts come first
  const unsigned char* alive =
      s_parts[h.alive_part].src + b * s_parts[h.alive_part].row_bytes;

  uint32_t lo = 0, hi = 0;
  for (int c = s0; c < s1; c += T * kUnroll) {
    int slot[kUnroll];
    bool live[kUnroll], present[kUnroll];
    uint32_t h0[kUnroll], h1[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      slot[j] = c + j * T + (int)threadIdx.x;
      live[j] = slot[j] < s1 && __ldg(alive + slot[j]) != 0;
      present[j] = true;
      h0[j] = kSeed;
      h1[j] = kSeed ^ kHiTweak;
    }
    // The parts in mixing order. A component's words are loaded whatever
    // its presence (no load waits for another) and masked when mixed.
    for (int i = 0; i < n; ++i) {
      const Part& q = s_parts[i];
      if (q.role == kAlive) continue;
      const bool masked = q.role == kComponent, presence = q.role == kPresence;
      const int words = q.words;
      const unsigned char* row = q.src + b * q.row_bytes;
      if (q.word_bytes == 4) {
        const uint32_t* at[kUnroll];
#pragma unroll
        for (int j = 0; j < kUnroll; ++j)
          at[j] = reinterpret_cast<const uint32_t*>(row) + (long long)slot[j] * words;
#pragma unroll 2
        for (int k = 0; k < words; ++k) {
#pragma unroll
          for (int j = 0; j < kUnroll; ++j) {
            const uint32_t w = live[j] ? __ldg(at[j] + k) : 0u;
            const uint32_t v = masked && !present[j] ? 0u : w;
            h0[j] = mix_one(h0[j], v);
            h1[j] = mix_one(h1[j], v);
          }
        }
      } else {
        for (int k = 0; k < words; ++k) {
#pragma unroll
          for (int j = 0; j < kUnroll; ++j) {
            const uint32_t w = live[j] ? load_word(row, (long long)slot[j] * words + k,
                                                   q.word_bytes, q.is_bool)
                                       : 0u;
            const uint32_t v = masked && !present[j] ? 0u : w;
            h0[j] = mix_one(h0[j], v);
            h1[j] = mix_one(h1[j], v);
            if (presence) present[j] = v != 0;
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (live[j]) {
        lo += fmix(h0[j]);
        hi += fmix(h1[j]);
      }
    }
  }

  if (rank == 0) {
    for (int w = threadIdx.x; w < h.resource_words; w += T) {
      int i = n;
      while (w >= s_parts[i].first + s_parts[i].words) ++i;
      const Part& q = s_parts[i];
      const int k = w - q.first;
      const uint32_t word =
          load_word(q.src + b * q.row_bytes, k, q.word_bytes, q.is_bool);
      const uint32_t pos = (uint32_t)(q.base + k) * kHiTweak;
      lo += fmix(mix_one(q.seed_lo ^ pos, word));
      hi += fmix(mix_one(q.seed_hi ^ pos, word));
    }
  }

  if (h.mode == kSave) {  // one world row: b == 0
    const int t = rank * T + (int)threadIdx.x, stride = P * T;
    for (int i = 0; i < h.n_parts; ++i)
      copy_bytes(s_parts[i].dst, s_parts[i].src, s_parts[i].row_bytes, t, stride);
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  lo = warp_sum(lo);
  hi = warp_sum(hi);
  if (lane == 0) {
    s_warp[warp][0] = lo;
    s_warp[warp][1] = hi;
  }
  __syncthreads();
  if (warp == 0) {
    lo = warp_sum(lane < T / 32 ? s_warp[lane][0] : 0u);
    hi = warp_sum(lane < T / 32 ? s_warp[lane][1] : 0u);
    if (lane == 0) {
      s_block[0] = lo;
      s_block[1] = hi;
    }
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    uint32_t a = h.const_lo, d = h.const_hi;
    for (int q = 0; q < P; ++q) {
      const uint32_t* sb = cluster.map_shared_rank(s_block, q);
      a += sb[0];
      d += sb[1];
    }
    const long long la = (long long)a, ld = (long long)d;
    if (h.mode == kGuard) {
      *h.flag = (*h.frames_row != h.frame) || (h.expect[0] == la && h.expect[1] == ld);
    } else {
      h.lanes[2 * b] = la;
      h.lanes[2 * b + 1] = ld;
    }
    if (h.mode == kSave) {
      h.lanes_ring[0] = la;
      h.lanes_ring[1] = ld;
      if (h.lanes_out != nullptr) {
        h.lanes_out[0] = la;
        h.lanes_out[1] = ld;
      }
      *h.frame_out = h.frame;
    }
  }
  cluster.sync();  // no block leaves while rank 0 reads its lanes
}

template <int K>
cudaError_t launch(const Header* header, const Part* parts, int B, int P,
                   int threads, cudaStream_t stream) {
  Params<K> p = {};
  p.h = *header;
  for (int i = 0; i < header->n_parts; ++i) p.parts[i] = parts[i];
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(B * P);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, world_checksum_kernel<K>, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// One launch in any mode. The kernel is instantiated for part arrays of
// 16, 64 and 256 (the parameter struct is 14,432 bytes at 256 parts, inside
// the 32,764 bytes CUDA 12.1 allows); the smallest that holds the world's
// parts is launched. P: blocks per world row, from
// ops/checksum.py::launch_shape. A launch the card refuses returns its
// error; nothing falls back.
extern "C" int ggrs_world_checksum(const void* header, const void* parts,
                                   int B, int P, int threads, void* stream) {
  const Header* h = (const Header*)header;
  const Part* q = (const Part*)parts;
  if (P != 1 && P != 2 && P != 4 && P != 8) return (int)cudaErrorInvalidValue;
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (h->n_parts <= 16) return (int)launch<16>(h, q, B, P, threads, s);
  if (h->n_parts <= 64) return (int)launch<64>(h, q, B, P, threads, s);
  if (h->n_parts <= 256) return (int)launch<256>(h, q, B, P, threads, s);
  return (int)cudaErrorInvalidValue;
}
