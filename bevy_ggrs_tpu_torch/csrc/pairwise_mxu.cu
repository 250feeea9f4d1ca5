// Dense boids forces with the neighbourhood sums on the tensor cores: R row
// boids against N column boids.
//
// Replaces the Pallas kernel
// bevy_ggrs_tpu/ops/pairwise.py::pairwise_force_rows_mxu2 (kernel body
// _force_kernel_mxu2). Its plain PyTorch version is
// bevy_ggrs_tpu_torch/ops/pairwise.py::pairwise_force_rows_mxu2_plain.
//
// The function: every neighbourhood sum is a product of a pair matrix with
// a per-column feature, Sum_j M_ij f_j. The wrapper builds the bf16
// feature stacks outside the kernel, as JAX does outside the pallas_call:
// feat_t [10, N] (active, px, py, vx, vy times active, hi then lo halves)
// and sep_t [6, N] (the first three, hi then lo). The kernel builds the
// pair matrices per tile in f32 and multiplies in bf16 with f32 sums:
// acc_n[f][r] = feat_t[f][c] . neigh[r][c] and acc_w = sep_t . (w_hi + w_lo),
// the MXU's feature-major products, here wmma 16x16x16 bf16 fragments.
// A bf16 x bf16 product is exact in f32, so the kernel and its plain
// version differ only in the order and rounding of the f32 sums.
//
// What bounds it on an H100: operations on the CUDA cores. Each pair
// costs about 18 f32 operations and one rsqrt to build the three masks,
// against 44 useful tensor-core flops (2 x (10 + 6 + 6) products), which
// the 989 TFLOP/s bf16 rate makes about 15 times cheaper than the masks at
// 67 TFLOP/s f32. Bytes are 20 per boid, negligible.
//
// Design: a block owns 64 row boids and walks the columns in tiles of 64,
// in one fixed order. Its 256 threads build the tile's neigh, w_hi and
// w_lo in shared memory (16 pairs a thread); then eight warps multiply,
// warp w taking row group w & 3 and the k-half w >> 2 of the tile, each
// with its own f32 accumulator fragments held across tiles. After the last
// tile the fragments go to shared memory (their element layout is
// opaque), the two k-halves are added in a fixed order, and one thread per
// row combines. No atomics: launches on the same inputs are bitwise equal,
// which SyncTest needs. d2 is __fadd_rn(__fmul_rn(dx,dx), __fmul_rn(dy,dy)),
// never an FMA, so borderline pairs fall on the same side of each radius
// as in the plain version and in JAX.
//
// Known limit: one block per 64 rows gives 16 blocks at N = 1,024 on 132
// SMs. Splitting the columns over blocks, with a fixed-order second pass as
// pairwise_tri.cu has, is the first thing to make it faster.

#include "pair_mxu.cuh"

namespace {

using namespace ggrs_mxu;

__global__ void __launch_bounds__(kThreads) pairwise_force_rows_mxu_kernel(
    const float2* __restrict__ row_pos, const float2* __restrict__ row_vel,
    const float* __restrict__ row_active, const float2* __restrict__ all_pos,
    const __nv_bfloat16* __restrict__ feat,
    const __nv_bfloat16* __restrict__ sep, float2* __restrict__ out, int R,
    int N, float nr2, float sr2, float ws, float wa, float wc) {
  __shared__ __align__(128) unsigned char smem[kMaskBytes + 2 * kFeatBytes];
  __shared__ float s_rpx[kTile], s_rpy[kTile], s_cpx[kTile], s_cpy[kTile];
  auto* s_neigh = reinterpret_cast<__nv_bfloat16*>(smem);
  auto* s_whi = s_neigh + kTile * kLd;
  auto* s_wlo = s_whi + kTile * kLd;
  auto* s_feat = s_wlo + kTile * kLd;
  auto* s_sep = s_feat + 16 * kLd;

  const int row0 = blockIdx.x * kTile;
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
  for (int base = 0; base < N; base += kTile) {
    for (int c = threadIdx.x; c < kTile; c += blockDim.x) {
      const int j = base + c;
      const float2 q = j < N ? all_pos[j] : make_float2(0.f, 0.f);
      s_cpx[c] = q.x;
      s_cpy[c] = q.y;
    }
    load_features(feat, sep, N, base, s_feat, s_sep);
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
  __syncthreads();
  for (int r = threadIdx.x; r < kTile; r += blockDim.x) {
    const int i = row0 + r;
    if (i >= R) continue;
    float sn[kFeat], sw[kSep];
#pragma unroll
    for (int f = 0; f < kFeat; ++f)
      sn[f] = stage[(0 * 16 + f) * kTile + r] + stage[(2 * 16 + f) * kTile + r];
#pragma unroll
    for (int f = 0; f < kSep; ++f)
      sw[f] = stage[(1 * 16 + f) * kTile + r] + stage[(3 * 16 + f) * kTile + r];
    const float2 v = row_vel[i];
    out[i] = combine(sn, sw, s_rpx[r], s_rpy[r], v.x, v.y, row_active[i], ws,
                     wa, wc);
  }
}

}  // namespace

extern "C" int ggrs_pairwise_force_rows_mxu(
    const void* row_pos, const void* row_vel, const void* row_active,
    const void* all_pos, const void* feat, const void* sep, void* out, int R,
    int N, float nr2, float sr2, float ws, float wa, float wc, void* stream) {
  const int blocks = (R + kTile - 1) / kTile;
  pairwise_force_rows_mxu_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)row_pos, (const float2*)row_vel, (const float*)row_active,
      (const float2*)all_pos, (const __nv_bfloat16*)feat,
      (const __nv_bfloat16*)sep, (float2*)out, R, N, nr2, sr2, ws, wa, wc);
  return (int)cudaGetLastError();
}
