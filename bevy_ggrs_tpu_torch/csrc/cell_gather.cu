// Grid-mode pair interactions per cell: the K slot rows of each cell
// against the M candidates gathered for it (its nine neighbour buckets'
// slots and the shared spill row).
//
// Replaces the Pallas kernel
// bevy_ggrs_tpu/ops/cell_gather.py::cell_slot_forces_pallas. Its plain
// PyTorch version is
// bevy_ggrs_tpu_torch/ops/cell_gather.py::cell_slot_forces_plain.
//
// In JAX the pair interaction is a Python PairKernel (accumulate, combine)
// traced into the Pallas body. Here it is a device functor with the same
// two members, and the kernel is a template instantiated once per pair
// kernel; the wrapper maps a PairKernel's name to its instantiation.
// FlockPair is boids' FLOCK_PAIR_KERNEL (bevy_ggrs_tpu/models/boids.py,
// _flock_accumulate and _flock_combine): 7 terms, 2 outputs, row and
// column features px, py, active, vx, vy.
//
// What bounds it on an H100: operations. Each slot-candidate pair costs
// about 30 f32 operations and one rsqrt. At the boids-32,768 grid (256
// cells x 256 slots x 2,816 candidates) the tables hold 184.5 M pairs a
// call, but only 37.8 M of them are between live entities: the spawn
// spiral fills about half of each cell's slots and no entity spills, so
// most rows and most candidates are sentinels. Bytes (16 MB gathered) are
// far below the operations' time.
//
// Design: the work follows the live pairs. One block per cell. The block
// compacts the indices of its live rows (a chunk of up to kThreads slots
// at a time) and, tile by tile, of its live candidates into shared memory
// in ascending order (__ballot_sync and a __popc prefix per warp, then the
// warp offsets), stages only those candidates' features, padded to whole
// float4s so a thread reads a candidate in two vector loads, and walks
// them. A pair kernel chooses what it skips: FlockPair skips inactive rows
// and candidates, whose terms are all +0 or -0 (see there). Each live row gets
// S = kThreads / W threads, W its live-row count rounded up to a warp:
// thread (s, row) walks the s-th contiguous range of each tile's compacted
// list, so every warp reads one candidate at a time (a broadcast), and
// the S partial sums are added in ascending s in shared memory before the
// combine. Every sum runs in one order fixed by the inputs and nothing is
// summed with atomics, so launches on the same inputs are bitwise equal.
// d2 is never contracted into an FMA: the membership masks then see the
// same float d2 as the plain version and JAX, and borderline pairs
// classify alike.
//
// Tables stacked over B speculative branches are [feature][B][C][K] and
// [feature][B][C][M] (ops/cell_gather.py stacks the features in front):
// a branch is C more cells. The launch is a grid of (C, B), the branch
// blockIdx.y (folded into blockIdx.z past 65,535: branch_grid.cuh), and
// each cell's block runs as in an unbatched launch, so every branch's
// outputs are bitwise its unbatched launch's.

#include <cuda_runtime.h>

#include "branch_grid.cuh"

namespace {

constexpr int kThreads = 512;  // threads a block; also the rows per chunk
constexpr int kTile = 1024;    // candidates examined per shared-memory tile

// rsqrtf for an argument known to be a normal float: the same hardware
// approximation without rsqrtf's scaling of subnormal arguments, so the
// same bits in three instructions fewer.
__device__ inline float rsqrt_normal(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// boids' FLOCK_PAIR_KERNEL. Row and column features, in PairKernel's
// row_names / col_names order: px, py, active, vx, vy.
struct FlockPair {
  static constexpr int kRowFeats = 5;
  static constexpr int kColFeats = 5;
  static constexpr int kTerms = 7;
  static constexpr int kOut = 2;
  static constexpr int kActive = 2;  // index of active in both feature lists
  // Every term below is multiplied by neigh, which holds row.active *
  // col.active, and the sums start at +0. An inactive candidate therefore
  // adds +0 or -0 to each sum, which leaves the sum's bits unchanged:
  // skipping it, in order, gives the sums of the full walk. An inactive
  // row's outputs are zero (combine's final * row.active), and the
  // scatter drops sentinel rows.
  static constexpr bool kSkipInactiveCols = true;
  static constexpr bool kSkipInactiveRows = true;
  float nr2, sr2, ws, wa, wc;

  __device__ void accumulate(const float* row, const float* col,
                             float* acc) const {
    const float dx = __fsub_rn(row[0], col[0]);
    const float dy = __fsub_rn(row[1], col[1]);
    const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
    const float both = row[2] * col[2];
    const float is_self = d2 < 1e-10f ? 1.f : 0.f;
    const float neigh = both * (d2 < nr2 ? 1.f : 0.f) * (1.f - is_self);
    const float inv_d = rsqrt_normal(fmaxf(d2, 1e-12f));
    const float close = neigh * (d2 < sr2 ? 1.f : 0.f);
    const float w = inv_d * close;
    acc[0] += neigh;
    acc[1] += dx * w;
    acc[2] += dy * w;
    acc[3] += col[3] * neigh;
    acc[4] += col[4] * neigh;
    acc[5] += col[0] * neigh;
    acc[6] += col[1] * neigh;
  }

  __device__ void combine(const float* acc, const float* row,
                          float* out) const {
    const float n = acc[0];
    const float n_safe = fmaxf(n, 1.f);
    const float has = n > 0.f ? 1.f : 0.f;
    const float fx = ws * acc[1] + wa * (acc[3] / n_safe - row[3]) * has +
                     wc * (acc[5] / n_safe - row[0]) * has;
    const float fy = ws * acc[2] + wa * (acc[4] / n_safe - row[4]) * has +
                     wc * (acc[6] / n_safe - row[1]) * has;
    out[0] = fx * row[2];
    out[1] = fy * row[2];
  }
};

// The indices i in [0, n) with keep(i), in ascending order, into idx;
// returns their count. Every thread of the block calls it.
template <class Keep>
__device__ int compact(int n, Keep keep, short* idx, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int total = 0;
  for (int base = 0; base < n; base += kThreads) {
    const int i = base + threadIdx.x;
    const bool k = i < n && keep(i);
    const unsigned mask = __ballot_sync(0xffffffffu, k);
    if (lane == 0) s_warp[warp] = __popc(mask);
    __syncthreads();
    int before = 0, chunk = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      before += w < warp ? s_warp[w] : 0;
      chunk += s_warp[w];
    }
    if (k) idx[total + before + __popc(mask & ((1u << lane) - 1u))] = (short)i;
    total += chunk;
    __syncthreads();  // s_warp is read before the next chunk writes it
  }
  return total;
}

// rows: f32 [kRowFeats, B, C, K]; cols: f32 [kColFeats, B, C, M];
// out: f32 [kOut, B, C, K].
template <class P>
__global__ void __launch_bounds__(kThreads, 2) cell_slot_forces_kernel(
    const float* __restrict__ rows, const float* __restrict__ cols,
    float* __restrict__ out, int B, int C, int K, int M, P pair) {
  // A staged candidate's features, padded to whole float4s so that a
  // thread reads them in kColVec vector loads; the row partials reuse the
  // same shared memory once the last tile is walked.
  constexpr int kColVec = (P::kColFeats + 3) / 4;
  constexpr int kTileBytes = kTile * kColVec * 16;
  constexpr int kPartBytes = P::kTerms * kThreads * 4;
  __shared__ __align__(16) unsigned char s_buf[kTileBytes > kPartBytes ? kTileBytes : kPartBytes];
  __shared__ short s_cand[kTile];
  __shared__ short s_rows[kThreads];
  __shared__ int s_warp[kThreads / 32];
  auto* s_col = reinterpret_cast<float4*>(s_buf);         // [kTile][kColVec]
  auto* s_part = reinterpret_cast<float(*)[kThreads]>(s_buf);  // [kTerms][kThreads]
  // The branch (ggrs_branch_grid), then the cell over all branches.
  const long branch = blockIdx.y + (long)gridDim.y * blockIdx.z;
  if (branch >= B) return;
  const long cell = branch * C + blockIdx.x;
  const float* row_base = rows + cell * K;
  const float* col_base = cols + cell * M;
  const long row_stride = (long)B * C * K, col_stride = (long)B * C * M;

  for (int r0 = 0; r0 < K; r0 += kThreads) {
    const int n_rows = min(kThreads, K - r0);
    const int live = compact(
        n_rows,
        [&](int i) {
          return !P::kSkipInactiveRows ||
                 row_base[P::kActive * row_stride + r0 + i] != 0.f;
        },
        s_rows, s_warp);
    // A skipped row writes zeros.
    if (P::kSkipInactiveRows && threadIdx.x < n_rows &&
        row_base[P::kActive * row_stride + r0 + threadIdx.x] == 0.f) {
#pragma unroll
      for (int f = 0; f < P::kOut; ++f)
        out[f * row_stride + cell * K + r0 + threadIdx.x] = 0.f;
    }
    if (live == 0) continue;

    // Thread t is split s = t / W of live row t % W; warps never straddle
    // two splits, since W is a whole number of warps.
    const int W = (live + 31) / 32 * 32;
    const int S = kThreads / W;
    const int s = threadIdx.x / W, lr = threadIdx.x % W;
    const bool walks = s < S && lr < live;
    float row[P::kRowFeats], acc[P::kTerms];
#pragma unroll
    for (int f = 0; f < P::kRowFeats; ++f) row[f] = 0.f;
    if (walks) {
#pragma unroll
      for (int f = 0; f < P::kRowFeats; ++f)
        row[f] = row_base[f * row_stride + r0 + s_rows[lr]];
    }
#pragma unroll
    for (int t = 0; t < P::kTerms; ++t) acc[t] = 0.f;

    for (int base = 0; base < M; base += kTile) {
      const int cnt = min(kTile, M - base);
      const int n = compact(
          cnt,
          [&](int j) {
            return !P::kSkipInactiveCols ||
                   col_base[P::kActive * col_stride + base + j] != 0.f;
          },
          s_cand, s_warp);
      for (int j = threadIdx.x; j < n; j += kThreads) {
        const int src = base + s_cand[j];
        float* dst = reinterpret_cast<float*>(s_col + j * kColVec);
#pragma unroll
        for (int f = 0; f < P::kColFeats; ++f)
          dst[f] = col_base[f * col_stride + src];
      }
      __syncthreads();
      if (walks) {
        const int j1 = (int)((long)n * (s + 1) / S);
        for (int j = (int)((long)n * s / S); j < j1; ++j) {
          float col[kColVec * 4];
#pragma unroll
          for (int v = 0; v < kColVec; ++v)
            reinterpret_cast<float4*>(col)[v] = s_col[j * kColVec + v];
          pair.accumulate(row, col, acc);
        }
      }
      __syncthreads();  // the tile is consumed before the next is staged
    }

    if (walks) {
#pragma unroll
      for (int t = 0; t < P::kTerms; ++t) s_part[t][threadIdx.x] = acc[t];
    }
    __syncthreads();
    if (walks && s == 0) {
#pragma unroll
      for (int t = 0; t < P::kTerms; ++t) {
        for (int q = 1; q < S; ++q) acc[t] += s_part[t][q * W + lr];
      }
      float o[P::kOut];
      pair.combine(acc, row, o);
#pragma unroll
      for (int f = 0; f < P::kOut; ++f)
        out[f * row_stride + cell * K + r0 + s_rows[lr]] = o[f];
    }
    __syncthreads();  // s_rows and s_part are read before the next chunk
  }
}

}  // namespace

// B: branches (1 for one world).
extern "C" int ggrs_cell_slot_forces_flock(const void* rows, const void* cols,
                                           void* out, int B, int C, int K,
                                           int M, float nr2, float sr2,
                                           float ws, float wa, float wc,
                                           void* stream) {
  if (B < 1) return (int)cudaErrorInvalidValue;
  const FlockPair pair{nr2, sr2, ws, wa, wc};
  cell_slot_forces_kernel<FlockPair>
      <<<ggrs_branch_grid(C, B), kThreads, 0, (cudaStream_t)stream>>>(
          (const float*)rows, (const float*)cols, (float*)out, B, C, K, M,
          pair);
  return (int)cudaGetLastError();
}
