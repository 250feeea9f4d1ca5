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
// one rsqrt per unordered pair, against 44 tensor-core flops per ordered
// pair at the bf16 rate. The partial sums cost 4 KB per tile and side of
// scratch traffic, 17 MB at N = 4,096, which the 50 MB L2 mostly holds.
//
// Design: the column-side sums cross blocks, and Hopper blocks run in no
// order, so a sum carried from grid step to grid step as on the TPU
// becomes two passes with no float atomics (ROADMAP: deterministic
// reductions). Pass 1 runs one block per upper-triangle tile (64 x 64;
// blocks of the lower triangle exit at once): 256 threads build the masks,
// warps 0-3 take the row side of row groups 0-3 and warps 4-7 the column
// side of column groups 0-3 (diagonal tiles have no column side), each
// over all four k-steps. The block writes its 16 used accumulator rows per
// side (10 neighbour sums, 6 separation sums, for 64 boids) to scratch
// that the wrapper allocates. Pass 2 runs one thread per boid: for strip
// k it adds the row-side partials of tiles (k, cj >= k) in ascending cj,
// then the column-side partials of tiles (ri < k, k) in ascending ri, adds
// the two as JAX's _acc_sums does, and combines. Every sum has one fixed
// order, so launches on the same inputs are bitwise equal. d2 is never
// contracted into an FMA (pair_mxu.cuh).

#include "pair_mxu.cuh"

namespace {

using namespace ggrs_mxu;

constexpr int kParts = kFeat + kSep;  // accumulator rows kept per boid

// Index of the upper-triangle tile (ri, cj >= ri) among nb strips.
__device__ inline long tile_index(int ri, int cj, int nb) {
  return (long)ri * (2 * nb - ri + 1) / 2 + (cj - ri);
}

__global__ void __launch_bounds__(kThreads) tri_tiles_kernel(
    const float2* __restrict__ pos, const __nv_bfloat16* __restrict__ feat,
    const __nv_bfloat16* __restrict__ sep, float* __restrict__ rowpart,
    float* __restrict__ colpart, int N, int nb, float nr2, float sr2) {
  const int cj = blockIdx.x, ri = blockIdx.y;
  if (cj < ri) return;
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
  for (int t = threadIdx.x; t < kTile; t += blockDim.x) {
    const float2 p = row0 + t < N ? pos[row0 + t] : make_float2(0.f, 0.f);
    const float2 q = col0 + t < N ? pos[col0 + t] : make_float2(0.f, 0.f);
    s_rpx[t] = p.x;
    s_rpy[t] = p.y;
    s_cpx[t] = q.x;
    s_cpy[t] = q.y;
  }
  load_features(feat, sep, N, col0, s_feat_c, s_sep_c);
  if (off_diag) load_features(feat, sep, N, row0, s_feat_r, s_sep_r);
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
  // [side][acc_n, acc_w][16][kTile]; then the 16 used rows of each side
  // to scratch, as [tile][kParts][kTile].
  float* stage = reinterpret_cast<float*>(smem);
  if (side == 0 || off_diag) {
    wmma::store_matrix_sync(stage + (side * 2 + 0) * 16 * kTile + 16 * g,
                            acc_n, kTile, wmma::mem_row_major);
    wmma::store_matrix_sync(stage + (side * 2 + 1) * 16 * kTile + 16 * g,
                            acc_w, kTile, wmma::mem_row_major);
  }
  __syncthreads();
  const long base = tile_index(ri, cj, nb) * kParts * kTile;
  for (int i = threadIdx.x; i < kParts * kTile; i += blockDim.x) {
    const int q = i / kTile, t = i % kTile;
    const int src = (q < kFeat ? q : 16 + q - kFeat) * kTile + t;
    rowpart[base + i] = stage[src];
    if (off_diag) colpart[base + i] = stage[2 * 16 * kTile + src];
  }
}

__global__ void tri_combine_kernel(
    const float2* __restrict__ pos, const float2* __restrict__ vel,
    const float* __restrict__ active, const float* __restrict__ rowpart,
    const float* __restrict__ colpart, float2* __restrict__ out, int N, int nb,
    float ws, float wa, float wc) {
  const int k = blockIdx.x, t = threadIdx.x, i = k * kTile + t;
  if (i >= N) return;
  float s[kParts], c[kParts];
#pragma unroll
  for (int q = 0; q < kParts; ++q) s[q] = c[q] = 0.f;
  for (int cj = k; cj < nb; ++cj) {
    const float* p = rowpart + tile_index(k, cj, nb) * kParts * kTile + t;
#pragma unroll
    for (int q = 0; q < kParts; ++q) s[q] += p[q * kTile];
  }
  for (int ri = 0; ri < k; ++ri) {
    const float* p = colpart + tile_index(ri, k, nb) * kParts * kTile + t;
#pragma unroll
    for (int q = 0; q < kParts; ++q) c[q] += p[q * kTile];
  }
#pragma unroll
  for (int q = 0; q < kParts; ++q) s[q] = s[q] + c[q];
  const float2 p = pos[i], v = vel[i];
  out[i] = combine(s, s + kFeat, p.x, p.y, v.x, v.y, active[i], ws, wa, wc);
}

}  // namespace

extern "C" int ggrs_pairwise_force_square_tri(
    const void* pos, const void* vel, const void* active, const void* feat,
    const void* sep, void* rowpart, void* colpart, void* out, int N,
    float nr2, float sr2, float ws, float wa, float wc, void* stream) {
  const int nb = (N + kTile - 1) / kTile;
  const cudaStream_t s = (cudaStream_t)stream;
  tri_tiles_kernel<<<dim3(nb, nb), kThreads, 0, s>>>(
      (const float2*)pos, (const __nv_bfloat16*)feat,
      (const __nv_bfloat16*)sep, (float*)rowpart, (float*)colpart, N, nb, nr2,
      sr2);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tri_combine_kernel<<<nb, kTile, 0, s>>>(
      (const float2*)pos, (const float2*)vel, (const float*)active,
      (const float*)rowpart, (const float*)colpart, (float2*)out, N, nb, ws,
      wa, wc);
  return (int)cudaGetLastError();
}
