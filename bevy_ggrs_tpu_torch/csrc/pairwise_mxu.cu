// Dense boids forces with the neighbourhood sums on the tensor cores: R row
// boids against N column boids.
//
// Replaces the Pallas kernel
// bevy_ggrs_tpu/ops/pairwise.py::pairwise_force_rows_mxu2 (kernel body
// _force_kernel_mxu2). Its plain PyTorch version is
// bevy_ggrs_tpu_torch/ops/pairwise.py::pairwise_force_rows_mxu2_plain.
//
// The function: every neighbourhood sum is a product of a pair matrix with
// a per-column feature, Sum_j M_ij f_j. The features are bf16 hi/lo
// stacks, feat_t [10, N] (active, px, py, vx, vy times active, hi then lo
// halves) and sep_t [6, N] (the first three, hi then lo). The kernel
// builds the pair matrices per tile in f32 and multiplies in bf16 with f32
// sums: acc_n[f][r] = feat_t[f][c] . neigh[r][c] and
// acc_w = sep_t . (w_hi + w_lo), the MXU's feature-major products, here
// wmma 16x16x16 bf16 fragments. A bf16 x bf16 product is exact in f32, so
// the kernel and its plain version differ only in the order and rounding
// of the f32 sums.
//
// What bounds it on an H100: operations on the CUDA cores. Each pair
// costs about 18 f32 operations and one rsqrt to build the three masks,
// against 44 useful tensor-core flops (2 x (10 + 6 + 6) products), which
// the 989 TFLOP/s bf16 rate makes about 15 times cheaper than the masks at
// 67 TFLOP/s f32. Bytes are 20 per boid, negligible. At the main path's
// R = N = 1,024 that bound (0.28 us) is far below one launch's latency:
// what the time depends on there is how many SMs share the work and how
// little the host does around the launch.
//
// Design: the columns of one 64-row block are split over a thread-block
// cluster of P blocks (P in {1, 2, 4, 8}; the wrapper picks it so that
// row blocks x P reaches the 132 SMs where there are enough column tiles).
// Block rank q walks the contiguous, ascending column tiles
// [q T / P, (q + 1) T / P) of the T tiles. Per tile its 256 threads build
// the columns' bf16 hi/lo features from the boids (as _lane_feats does,
// with __fmul_rn, so the wrapper runs no PyTorch op on them) and the
// tile's neigh, w_hi and w_lo in shared memory (16 pairs a thread); then
// eight warps multiply, warp w taking row group w & 3 and the k-half
// w >> 2 of the tile, each with its own f32 accumulator fragments held
// across tiles. After its last tile a block leaves its accumulators in its
// own shared memory ([k-half][acc_n, acc_w][16][64] f32, 16 KB; their
// element layout is opaque). After cluster.sync() the P blocks split the
// 64 rows' combine: each reads the P stages through distributed shared
// memory in ascending rank, each rank's two k-halves added first, then
// combines one row a thread. A second cluster.sync() keeps every block's
// shared memory alive while the others read it. One launch, no scratch,
// no atomics: launches on the same inputs are bitwise equal, which
// SyncTest needs. d2 is __fadd_rn(__fmul_rn(dx,dx), __fmul_rn(dy,dy)),
// never an FMA, so borderline pairs fall on the same side of each radius
// as in the plain version and in JAX.
//
// A world stacked over B speculative branches is one launch of grid
// (row_blocks x P, B) with clusters of (P, 1, 1): blockIdx.y is the
// branch, whose operands and output start b R or b N boids in, and a
// cluster never spans two branches. P comes from R and N alone, never
// from B: it fixes the order in which the stages add, so every branch's
// forces are bitwise its unbatched launch's.

#include <cooperative_groups.h>

#include "branch_grid.cuh"
#include "pair_mxu.cuh"

namespace {

using namespace ggrs_mxu;
namespace cg = cooperative_groups;

constexpr int kParts = kFeat + kSep;  // accumulator rows the combine reads

__global__ void __launch_bounds__(kThreads) pairwise_force_rows_mxu_kernel(
    const float2* __restrict__ row_pos, const float2* __restrict__ row_vel,
    const float* __restrict__ row_active, const float2* __restrict__ all_pos,
    const float2* __restrict__ all_vel, const float* __restrict__ all_active,
    float2* __restrict__ out, int B, int R, int N, float nr2, float sr2,
    float ws, float wa, float wc) {
  __shared__ __align__(128) unsigned char smem[kMaskBytes + 2 * kFeatBytes];
  __shared__ float s_rpx[kTile], s_rpy[kTile], s_cpx[kTile], s_cpy[kTile];
  __shared__ float s_sum[kParts][kTile];
  auto* s_neigh = reinterpret_cast<__nv_bfloat16*>(smem);
  auto* s_whi = s_neigh + kTile * kLd;
  auto* s_wlo = s_whi + kTile * kLd;
  auto* s_feat = s_wlo + kTile * kLd;
  auto* s_sep = s_feat + 16 * kLd;

  // The branch (ggrs_branch_grid); a cluster lies in one branch, so a
  // cluster past B leaves whole, before any cluster barrier.
  const long b = blockIdx.y + (long)gridDim.y * blockIdx.z;
  if (b >= B) return;
  row_pos += b * R;
  row_vel += b * R;
  row_active += b * R;
  all_pos += b * N;
  all_vel += b * N;
  all_active += b * N;
  out += b * R;
  cg::cluster_group cluster = cg::this_cluster();
  const int P = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / P) * kTile;
  for (int r = threadIdx.x; r < kTile; r += blockDim.x) {
    const int i = row0 + r;
    const float2 p = i < R ? row_pos[i] : make_float2(0.f, 0.f);
    s_rpx[r] = p.x;
    s_rpy[r] = p.y;
  }
  const int warp = threadIdx.x / 32, g = warp & 3, h = warp >> 2;
  FragAcc acc_n, acc_w;
  wmma::fill_fragment(acc_n, 0.f);
  wmma::fill_fragment(acc_w, 0.f);
  const int tiles = (N + kTile - 1) / kTile;
  const int t0 = rank * tiles / P, t1 = (rank + 1) * tiles / P;
  for (int t = t0; t < t1; ++t) {
    const int base = t * kTile;
    build_features(all_pos, all_vel, all_active, N, base, s_cpx, s_cpy,
                   s_feat, s_sep);
    __syncthreads();
    build_masks(s_rpx, s_rpy, s_cpx, s_cpy, N - base, nr2, sr2, s_neigh,
                s_whi, s_wlo);
    __syncthreads();
    mma_rows(s_feat, s_sep, s_neigh, s_whi, s_wlo, g, 2 * h, 2 * h + 2, acc_n,
             acc_w);
    __syncthreads();
  }

  // Accumulators to shared memory over the mask tiles, as float
  // [k-half][acc_n, acc_w][16][kTile].
  float* stage = reinterpret_cast<float*>(smem);
  wmma::store_matrix_sync(stage + (h * 2 + 0) * 16 * kTile + 16 * g, acc_n,
                          kTile, wmma::mem_row_major);
  wmma::store_matrix_sync(stage + (h * 2 + 1) * 16 * kTile + 16 * g, acc_w,
                          kTile, wmma::mem_row_major);
  cluster.sync();

  // This block's rows of the combine, [r0, r1): first each used
  // accumulator row summed over the cluster's stages, one (row, part) a
  // thread, then one row a thread.
  const int r0 = rank * kTile / P, r1 = (rank + 1) * kTile / P;
  const int nr = r1 - r0;
  for (int i = threadIdx.x; i < kParts * nr; i += blockDim.x) {
    const int part = i / nr, r = r0 + i % nr;
    const int src = (part < kFeat ? part : 16 + part - kFeat) * kTile + r;
    float sum = 0.f;
    for (int q = 0; q < P; ++q) {
      const float* st = cluster.map_shared_rank(stage, q);
      const float v = st[src] + st[2 * 16 * kTile + src];
      sum = q == 0 ? v : sum + v;
    }
    s_sum[part][r] = sum;
  }
  __syncthreads();
  for (int r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const int i = row0 + r;
    if (i >= R) continue;
    float sn[kFeat], sw[kSep];
#pragma unroll
    for (int f = 0; f < kFeat; ++f) sn[f] = s_sum[f][r];
#pragma unroll
    for (int f = 0; f < kSep; ++f) sw[f] = s_sum[kFeat + f][r];
    const float2 v = row_vel[i];
    out[i] = combine(sn, sw, s_rpx[r], s_rpy[r], v.x, v.y, row_active[i], ws,
                     wa, wc);
  }
  cluster.sync();  // no block leaves while another reads its stage
}

}  // namespace

// B: branches (1 for one world); P: blocks per cluster, from
// ops/pairwise.py::mxu2_launch_shape. A cluster launch the card refuses
// returns its error; nothing falls back to another P.
extern "C" int ggrs_pairwise_force_rows_mxu(
    const void* row_pos, const void* row_vel, const void* row_active,
    const void* all_pos, const void* all_vel, const void* all_active,
    void* out, int B, int R, int N, int P, float nr2, float sr2, float ws,
    float wa, float wc, void* stream) {
  if (P != 1 && P != 2 && P != 4 && P != 8) return (int)cudaErrorInvalidValue;
  if (B < 1) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t config = {};
  config.gridDim = ggrs_branch_grid((R + kTile - 1) / kTile * P, B);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = 0;
  config.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, pairwise_force_rows_mxu_kernel, (const float2*)row_pos,
      (const float2*)row_vel, (const float*)row_active,
      (const float2*)all_pos, (const float2*)all_vel,
      (const float*)all_active, (float2*)out, B, R, N, nr2, sr2, ws, wa, wc);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
