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
// about 30 f32 operations and one rsqrt; at the boids-32,768 grid (256
// cells x 256 slots x 2,816 candidates) that is 184.5 M pairs a call,
// most of them against empty slots, against 14 MB of gathered inputs.
//
// Design: one block per cell and one thread per slot row, its n_terms
// sums in registers. Candidate tiles of all column features are staged
// in shared memory and walked in order, every thread reading the same
// candidate at once (a broadcast). The combine runs at the end. Each sum
// runs over the candidates in one fixed order and nothing is summed with
// atomics, so launches on the same inputs are bitwise equal. d2 is never
// contracted into an FMA: the membership masks then see the same float
// d2 as the plain version and JAX, and borderline pairs classify alike.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 512;        // candidates staged per shared-memory tile
constexpr int kMaxThreads = 512;  // slot rows per pass of a block

// boids' FLOCK_PAIR_KERNEL. Row and column features, in PairKernel's
// row_names / col_names order: px, py, active, vx, vy.
struct FlockPair {
  static constexpr int kRowFeats = 5;
  static constexpr int kColFeats = 5;
  static constexpr int kTerms = 7;
  static constexpr int kOut = 2;
  float nr2, sr2, ws, wa, wc;

  __device__ void accumulate(const float* row, const float* col,
                             float* acc) const {
    const float dx = __fsub_rn(row[0], col[0]);
    const float dy = __fsub_rn(row[1], col[1]);
    const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
    const float both = row[2] * col[2];
    const float is_self = d2 < 1e-10f ? 1.f : 0.f;
    const float neigh = both * (d2 < nr2 ? 1.f : 0.f) * (1.f - is_self);
    const float inv_d = rsqrtf(fmaxf(d2, 1e-12f));
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

// rows: f32 [kRowFeats, C, K]; cols: f32 [kColFeats, C, M];
// out: f32 [kOut, C, K].
template <class P>
__global__ void cell_slot_forces_kernel(const float* __restrict__ rows,
                                        const float* __restrict__ cols,
                                        float* __restrict__ out, int C, int K,
                                        int M, P pair) {
  __shared__ float s_col[P::kColFeats][kTile];
  const long cell = blockIdx.x;
  for (int r0 = 0; r0 < K; r0 += blockDim.x) {
    const int r = r0 + threadIdx.x;
    const bool has_row = r < K;
    float row[P::kRowFeats], acc[P::kTerms];
#pragma unroll
    for (int f = 0; f < P::kRowFeats; ++f)
      row[f] = has_row ? rows[(f * C + cell) * K + r] : 0.f;
#pragma unroll
    for (int t = 0; t < P::kTerms; ++t) acc[t] = 0.f;
    for (int base = 0; base < M; base += kTile) {
      const int cnt = min(kTile, M - base);
      __syncthreads();  // the previous tile is consumed
      for (int j = threadIdx.x; j < cnt; j += blockDim.x) {
#pragma unroll
        for (int f = 0; f < P::kColFeats; ++f)
          s_col[f][j] = cols[(f * C + cell) * M + base + j];
      }
      __syncthreads();
      for (int j = 0; j < cnt; ++j) {
        float col[P::kColFeats];
#pragma unroll
        for (int f = 0; f < P::kColFeats; ++f) col[f] = s_col[f][j];
        pair.accumulate(row, col, acc);
      }
    }
    if (has_row) {
      float o[P::kOut];
      pair.combine(acc, row, o);
#pragma unroll
      for (int f = 0; f < P::kOut; ++f) out[(f * C + cell) * K + r] = o[f];
    }
  }
}

}  // namespace

extern "C" int ggrs_cell_slot_forces_flock(const void* rows, const void* cols,
                                           void* out, int C, int K, int M,
                                           float nr2, float sr2, float ws,
                                           float wa, float wc, void* stream) {
  const int rounded = (K + 31) / 32 * 32;
  const int threads = rounded < kMaxThreads ? rounded : kMaxThreads;
  const FlockPair pair{nr2, sr2, ws, wa, wc};
  cell_slot_forces_kernel<FlockPair><<<C, threads, 0, (cudaStream_t)stream>>>(
      (const float*)rows, (const float*)cols, (float*)out, C, K, M, pair);
  return (int)cudaGetLastError();
}
