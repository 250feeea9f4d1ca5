// Square all-vs-all boids forces with symmetry-halved mask work, the
// neighbourhood sums on the tensor cores.
//
// Replaces the Pallas kernel
// bevy_ggrs_tpu/ops/pairwise.py::pairwise_force_square_mxu_tri (kernel
// body _force_kernel_tri). Its plain PyTorch version is
// bevy_ggrs_tpu_torch/ops/pairwise.py::pairwise_force_square_mxu_tri_plain.
//
// The function is pairwise_mxu.cu's with every boid both a row and a
// column. Both pair matrices are symmetric, so a tile's masks, built once
// for the tile (ri, cj) with cj >= ri, serve two products: the row side,
// feat_c . M^T, into the sums of strip ri's boids, and the column side,
// feat_r . M, into the sums of strip cj's boids. Mask work drops from n^2
// tiles to n(n+1)/2.
//
// What bounds it on an H100: operations on the CUDA cores, as in
// pairwise_mxu.cu, but over half the pairs: about 18 f32 operations and
// one rsqrt per unordered pair (2.3 us at N = 4,096), against 44
// tensor-core flops per ordered pair at the bf16 rate (0.75 us). The
// partial sums cost 4 KB per tile and side of scratch traffic, 17 MB at
// N = 4,096, which the 50 MB L2 holds.
//
// Design: the column-side sums cross blocks, and Hopper blocks run in no
// order, so a sum carried from grid step to grid step as on the TPU
// becomes two passes with no float atomics (ROADMAP: deterministic
// reductions).
//
// Pass 1 (tri_tiles_kernel) runs one block of 256 threads per
// upper-triangle tile (64 x 64) on a 1-D grid of nb(nb+1)/2 blocks, block
// b taking the b-th tile of the triangle in row-major order (tile_of;
// ops/pairwise.py::tri_tile_of mirrors it), so no block is idle. Threads
// 0-63 build the column tile's bf16 hi/lo features from the boids and
// threads 64-127 the row tile's (build_feature_column, bitwise
// _lane_feats), so the wrapper runs no PyTorch op on them. The masks are
// built two columns a thread, rows by warp (build_masks). Warps 0-3 take
// the row side of row groups 0-3 and warps 4-7 the column side of column
// groups 0-3 (diagonal tiles have no column side), each over all four
// k-steps. The block writes its 16 used accumulator rows per side (10
// neighbour sums, 6 separation sums, for 64 boids) to scratch that the
// wrapper allocates, one float4 a thread and side.
//
// Pass 2 (tri_combine_kernel) gives each (boid, accumulator row) its own
// thread: blocks of 16 warps over 32 boids, warp q summing row q for its
// 32 boids, 2 blocks a strip. For strip k it adds the row-side partials
// of tiles (k, cj >= k) in ascending cj, then the column-side partials of
// tiles (ri < k, k) in ascending ri, each from +0 with the loads of 8
// partials issued before their adds; then the two sums, as JAX's
// _acc_sums does; then one warp combines a boid a lane. That is the order
// of the design before this one (one thread per boid), so the forces are
// bitwise the same. Every sum has one fixed order, so launches on the
// same inputs are bitwise equal, as SyncTest needs. d2 is never
// contracted into an FMA.
//
// A world stacked over B speculative branches runs both passes once, with
// the branch as blockIdx.y: branch b's boids and output start b N in, and
// its scratch b [2][tiles][16][64] floats in (the wrapper allocates [B,
// *tri_scratch_shape(N)]). tile_of and every sum are as in an unbatched
// launch, so every branch's forces are bitwise its unbatched launch's.

#include "pair_mxu.cuh"

namespace {

using namespace ggrs_mxu;

constexpr int kParts = kFeat + kSep;  // accumulator rows kept per boid
constexpr int kCombineBoids = 32;     // boids per combine block, a lane each
constexpr int kAhead = 8;             // partials loaded before their adds

// First tile of strip ri among the upper-triangle tiles in row-major
// order: strip r holds the nb - r tiles (r, r..nb-1).
__device__ inline long strip_start(int ri, int nb) {
  return (long)ri * (2 * nb - ri + 1) / 2;
}

// The tile (ri, cj >= ri) that is the b-th of the upper triangle: ri from
// the root of strip_start(ri) = b, then put right in integers.
__device__ inline void tile_of(long b, int nb, int& ri, int& cj) {
  const double m = 2.0 * nb + 1.0;
  int r = (int)((m - sqrt(m * m - 8.0 * (double)b)) * 0.5);
  r = max(0, min(r, nb - 1));
  while (r > 0 && strip_start(r, nb) > b) --r;
  while (r + 1 < nb && strip_start(r + 1, nb) <= b) ++r;
  ri = r;
  cj = r + (int)(b - strip_start(r, nb));
}

// part: float [2 sides][tiles][kParts][kTile], side 0 the row side.
__global__ void __launch_bounds__(kThreads) tri_tiles_kernel(
    const float2* __restrict__ pos, const float2* __restrict__ vel,
    const float* __restrict__ active, float* __restrict__ part, int N, int nb,
    float nr2, float sr2) {
  const long b = blockIdx.y;  // the branch
  const long tiles = (long)nb * (nb + 1) / 2;
  pos += b * N;
  vel += b * N;
  active += b * N;
  part += b * 2 * tiles * kParts * kTile;
  int ri, cj;
  tile_of(blockIdx.x, nb, ri, cj);
  const bool off_diag = cj > ri;
  __shared__ __align__(128) unsigned char smem[kMaskBytes + 4 * kFeatBytes];
  __shared__ float s_rpx[kTile], s_rpy[kTile], s_cpx[kTile], s_cpy[kTile];
  auto* s_neigh = reinterpret_cast<__nv_bfloat16*>(smem);
  auto* s_whi = s_neigh + kTile * kLd;
  auto* s_wlo = s_whi + kTile * kLd;
  auto* s_feat_c = s_wlo + kTile * kLd;
  auto* s_sep_c = s_feat_c + 16 * kLd;
  auto* s_feat_r = s_sep_c + 16 * kLd;
  auto* s_sep_r = s_feat_r + 16 * kLd;

  const int row0 = ri * kTile, col0 = cj * kTile;
  if (threadIdx.x < kTile) {
    build_feature_column(pos, vel, active, N, col0, threadIdx.x, s_cpx,
                         s_cpy, s_feat_c, s_sep_c);
  } else if (threadIdx.x < 2 * kTile) {
    build_feature_column(pos, vel, active, N, row0, threadIdx.x - kTile,
                         s_rpx, s_rpy, s_feat_r, s_sep_r);
  }
  __syncthreads();
  build_masks(s_rpx, s_rpy, s_cpx, s_cpy, N - col0, nr2, sr2, s_neigh, s_whi,
              s_wlo);
  __syncthreads();

  const int warp = threadIdx.x / 32, g = warp & 3, side = warp >> 2;
  FragAcc acc_n, acc_w;
  wmma::fill_fragment(acc_n, 0.f);
  wmma::fill_fragment(acc_w, 0.f);
  if (side == 0) {
    mma_rows(s_feat_c, s_sep_c, s_neigh, s_whi, s_wlo, g, 0, kTile / 16,
             acc_n, acc_w);
  } else if (off_diag) {
    // Column side: acc[f][c] = Sum_r feat_r[f][r] * M[r][c]; M stored
    // [r][c] is B in row major, with the rows as the k axis.
    FragA a;
    FragBRow b;
    for (int k = 0; k < kTile / 16; ++k) {
      const int m = (16 * k) * kLd + 16 * g;
      wmma::load_matrix_sync(a, s_feat_r + 16 * k, kLd);
      wmma::load_matrix_sync(b, s_neigh + m, kLd);
      wmma::mma_sync(acc_n, a, b, acc_n);
      wmma::load_matrix_sync(a, s_sep_r + 16 * k, kLd);
      wmma::load_matrix_sync(b, s_whi + m, kLd);
      wmma::mma_sync(acc_w, a, b, acc_w);
      wmma::load_matrix_sync(b, s_wlo + m, kLd);
      wmma::mma_sync(acc_w, a, b, acc_w);
    }
  }
  __syncthreads();

  // Accumulators to shared memory over the mask tiles, as float
  // [side][acc_n, acc_w][16][kTile]; then the 16 used rows of each side to
  // scratch, one float4 a thread and side.
  float* stage = reinterpret_cast<float*>(smem);
  if (side == 0 || off_diag) {
    wmma::store_matrix_sync(stage + (side * 2 + 0) * 16 * kTile + 16 * g,
                            acc_n, kTile, wmma::mem_row_major);
    wmma::store_matrix_sync(stage + (side * 2 + 1) * 16 * kTile + 16 * g,
                            acc_w, kTile, wmma::mem_row_major);
  }
  __syncthreads();
  const long base = (long)blockIdx.x * kParts * kTile;
  for (int i = threadIdx.x; i < kParts * kTile / 4; i += blockDim.x) {
    const int q = i / (kTile / 4), t = 4 * (i % (kTile / 4));
    const int src = (q < kFeat ? q : 16 + q - kFeat) * kTile + t;
    const long dst = base + q * kTile + t;
    *reinterpret_cast<float4*>(part + dst) =
        *reinterpret_cast<const float4*>(stage + src);
    if (off_diag) {
      *reinterpret_cast<float4*>(part + tiles * kParts * kTile + dst) =
          *reinterpret_cast<const float4*>(stage + 2 * 16 * kTile + src);
    }
  }
}

// Sum of n partials of one (boid, accumulator row), the j-th at
// part[offset(j)], from +0 in ascending j; the loads of kAhead partials
// are issued before their adds.
template <typename Offset>
__device__ inline float sum_partials(const float* __restrict__ part, int n,
                                     Offset offset) {
  float s = 0.f;
  for (int j0 = 0; j0 < n; j0 += kAhead) {
    float v[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      v[u] = j0 + u < n ? part[offset(j0 + u)] : 0.f;
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (j0 + u < n) s += v[u];
  }
  return s;
}

__global__ void __launch_bounds__(kParts * kCombineBoids) tri_combine_kernel(
    const float2* __restrict__ pos, const float2* __restrict__ vel,
    const float* __restrict__ active, const float* __restrict__ part,
    float2* __restrict__ out, int N, int nb, float ws, float wa, float wc) {
  constexpr int kHalves = kTile / kCombineBoids;
  __shared__ float s_sum[kParts][kCombineBoids];
  const long b = blockIdx.y;  // the branch
  pos += b * N;
  vel += b * N;
  active += b * N;
  part += b * 2 * ((long)nb * (nb + 1) / 2) * kParts * kTile;
  out += b * N;
  const int k = blockIdx.x / kHalves, lane = threadIdx.x % 32;
  const int q = threadIdx.x / 32;
  const int t = (blockIdx.x % kHalves) * kCombineBoids + lane;
  const long stride = (long)kParts * kTile;  // floats per tile and side
  const float* rows = part + strip_start(k, nb) * stride + q * kTile + t;
  const float* cols = part + (long)nb * (nb + 1) / 2 * stride + q * kTile + t;
  const float s = sum_partials(rows, nb - k,
                               [&](int j) { return (long)j * stride; });
  const float c = sum_partials(cols, k, [&](int ri) {
    return (strip_start(ri, nb) + (k - ri)) * stride;
  });
  s_sum[q][lane] = s + c;
  __syncthreads();
  const int i = k * kTile + t;
  if (q != 0 || i >= N) return;
  float sn[kFeat], sw[kSep];
#pragma unroll
  for (int f = 0; f < kFeat; ++f) sn[f] = s_sum[f][lane];
#pragma unroll
  for (int f = 0; f < kSep; ++f) sw[f] = s_sum[kFeat + f][lane];
  const float2 p = pos[i], v = vel[i];
  out[i] = combine(sn, sw, p.x, p.y, v.x, v.y, active[i], ws, wa, wc);
}

}  // namespace

// part: the wrapper's scratch, [B, *ops/pairwise.py::tri_scratch_shape];
// B: branches (1 for one world).
extern "C" int ggrs_pairwise_force_square_tri(
    const void* pos, const void* vel, const void* active, void* part,
    void* out, int B, int N, float nr2, float sr2, float ws, float wa,
    float wc, void* stream) {
  if (B < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  const int nb = (N + kTile - 1) / kTile;
  const cudaStream_t s = (cudaStream_t)stream;
  tri_tiles_kernel<<<dim3(nb * (nb + 1) / 2, B), kThreads, 0, s>>>(
      (const float2*)pos, (const float2*)vel, (const float*)active,
      (float*)part, N, nb, nr2, sr2);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tri_combine_kernel<<<dim3(nb * (kTile / kCombineBoids), B),
                       kParts * kCombineBoids, 0, s>>>((const float2*)pos, (const float2*)vel,
                               (const float*)active, (const float*)part,
                               (float2*)out, N, nb, ws, wa, wc);
  return (int)cudaGetLastError();
}
