// Dense boids forces: separation, alignment and cohesion on R row boids
// from N column boids.
//
// Replaces the Pallas kernel
// bevy_ggrs_tpu/ops/pairwise.py::pairwise_force_rows_pallas (kernel body
// _force_kernel). Its plain PyTorch version is
// bevy_ggrs_tpu_torch/ops/pairwise.py::pairwise_force_rows_plain.
//
// What bounds it on an H100: operations. Each pair costs about 30 FP32
// operations with one rsqrt, against 20 bytes per boid read once, so at
// the main path's R = N = 1,024 the work is ~31 MFLOP for 20 KB: 0.47 us
// at the card's 67 TFLOP/s, below one launch. What the time depends on
// there is how many SMs share the pairs and how short each thread's
// dependent chain of adds is.
//
// Design: one warp per row boid, W rows (warps) a block, W in {1, 2, 4,
// 8} from ops/pairwise.py::force_rows_launch_shape (8 at R = 1,024: 128
// blocks on 132 SMs, 32 pairs a thread; 4 or 2 rows a block measured
// slower, every block staging all the columns). The block stages column
// tiles of positions, velocities and active flags in shared memory; lane
// l of every warp takes the tile's columns l, l + 32, ... in ascending
// order, so the warp reads 32 consecutive columns at once, with its seven
// accumulators (count, separation x/y, velocity sum x/y, position sum
// x/y) in registers from +0. The 32 lanes' sums then meet in a fixed
// __shfl_xor_sync tree (offsets 16, 8, 4, 2, 1), and lane 0 combines as
// _force_kernel's _combine does. Nothing is summed with atomics and every
// sum has one order, so repeated launches on the same inputs give bitwise
// the same forces: SyncTest compares a resimulated frame's checksum with
// the original's, and any wobble would be a desync. d2 is computed with
// __fmul_rn and __fadd_rn, never contracted into an FMA, so it has the
// same float value as the plain version's and borderline pairs fall on
// the same side of each radius.

#include <cuda_runtime.h>

#include "branch_grid.cuh"

namespace {

constexpr int kTile = 1024;       // column boids staged per shared-memory tile
constexpr int kMaxWarps = 8;      // rows per block at most
constexpr unsigned kFull = 0xffffffffu;

__device__ inline float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

__global__ void __launch_bounds__(kMaxWarps * 32) pairwise_force_rows_kernel(
    const float2* __restrict__ row_pos, const float2* __restrict__ row_vel,
    const float* __restrict__ row_active, const float2* __restrict__ all_pos,
    const float2* __restrict__ all_vel, const float* __restrict__ all_active,
    float2* __restrict__ out, int B, int R, int N, float nr2, float sr2,
    float ws, float wa, float wc) {
  __shared__ float2 s_pos[kTile];
  __shared__ float2 s_vel[kTile];
  __shared__ float s_act[kTile];

  // The branch: blockIdx.y, and past gridDim.y's cap of 65,535 the
  // blockIdx.z folds (ggrs_branch_grid).
  const long b = blockIdx.y + (long)gridDim.y * blockIdx.z;
  if (b >= B) return;
  row_pos += b * R;
  row_vel += b * R;
  row_active += b * R;
  all_pos += b * N;
  all_vel += b * N;
  all_active += b * N;
  out += b * R;
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const bool has_row = i < R;
  const float2 p = has_row ? row_pos[i] : make_float2(0.f, 0.f);
  const float2 v = has_row ? row_vel[i] : make_float2(0.f, 0.f);
  const float a = has_row ? row_active[i] : 0.f;

  float n = 0.f, sx = 0.f, sy = 0.f, svx = 0.f, svy = 0.f, spx = 0.f,
        spy = 0.f;
  for (int base = 0; base < N; base += kTile) {
    const int cnt = min(kTile, N - base);
    for (int j = threadIdx.x; j < cnt; j += blockDim.x) {
      s_pos[j] = all_pos[base + j];
      s_vel[j] = all_vel[base + j];
      s_act[j] = all_active[base + j];
    }
    __syncthreads();
#pragma unroll 4
    for (int j = lane; j < cnt; j += 32) {
      const float2 q = s_pos[j];
      const float dx = __fsub_rn(p.x, q.x);
      const float dy = __fsub_rn(p.y, q.y);
      const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      const float both = a * s_act[j];
      const float not_self = 1.f - (d2 < 1e-10f ? 1.f : 0.f);
      const float neigh = both * (d2 < nr2 ? 1.f : 0.f) * not_self;
      const float close = neigh * (d2 < sr2 ? 1.f : 0.f);
      const float inv_d = rsqrtf(fmaxf(d2, 1e-12f));
      const float2 w = s_vel[j];
      n += neigh;
      sx += dx * inv_d * close;
      sy += dy * inv_d * close;
      svx += w.x * neigh;
      svy += w.y * neigh;
      spx += q.x * neigh;
      spy += q.y * neigh;
    }
    __syncthreads();
  }
  n = warp_sum(n);
  sx = warp_sum(sx);
  sy = warp_sum(sy);
  svx = warp_sum(svx);
  svy = warp_sum(svy);
  spx = warp_sum(spx);
  spy = warp_sum(spy);
  if (!has_row || lane != 0) return;
  const float n_safe = fmaxf(n, 1.f);
  const float has = n > 0.f ? 1.f : 0.f;
  const float fx = ws * sx + wa * (svx / n_safe - v.x) * has +
                   wc * (spx / n_safe - p.x) * has;
  const float fy = ws * sy + wa * (svy / n_safe - v.y) * has +
                   wc * (spy / n_safe - p.y) * has;
  out[i] = make_float2(fx * a, fy * a);
}

}  // namespace

// B: branches (1 for one world); warps: rows per block, from
// ops/pairwise.py::force_rows_launch_shape.
extern "C" int ggrs_pairwise_force_rows(
    const void* row_pos, const void* row_vel, const void* row_active,
    const void* all_pos, const void* all_vel, const void* all_active,
    void* out, int B, int R, int N, int warps, float nr2, float sr2,
    float ws, float wa, float wc, void* stream) {
  if (warps != 1 && warps != 2 && warps != 4 && warps != kMaxWarps)
    return (int)cudaErrorInvalidValue;
  if (B < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid = ggrs_branch_grid((R + warps - 1) / warps, B);
  pairwise_force_rows_kernel<<<grid, warps * 32, 0, (cudaStream_t)stream>>>(
      (const float2*)row_pos, (const float2*)row_vel,
      (const float*)row_active, (const float2*)all_pos,
      (const float2*)all_vel, (const float*)all_active, (float2*)out, B, R, N,
      nr2, sr2, ws, wa, wc);
  return (int)cudaGetLastError();
}
