// Shared pieces of the two tensor-core boids force kernels
// (pairwise_mxu.cu and pairwise_tri.cu): the pair-mask tile, the feature
// tiles (loaded from prebuilt stacks, or built from the boids), and the
// combine. Counterparts of _pair_masks, _lane_feats' tiles, _acc_sums and
// _combine_forces in bevy_ggrs_tpu/ops/pairwise.py.
//
// A tile pairs kTile row boids with kTile column boids. Its three pair
// matrices (the 0/1 neighbour mask and the hi/lo halves of the separation
// weight) are stored in shared memory as bf16 [row][col] with leading
// dimension kLd; the feature tiles as bf16 [16 features][kLd], rows past
// the 10 (or 6) real features zero. kLd = kTile + 8 keeps every 16 x 16
// fragment pointer 32-byte aligned (16 rows = 2,304 bytes) and is a
// multiple of 8, as wmma's bf16 loads require.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace ggrs_mxu {

using namespace nvcuda;

constexpr int kTile = 64;          // row and column boids per tile
constexpr int kLd = kTile + 8;     // bf16 leading dimension of every tile
constexpr int kFeat = 10;          // feat_t rows: 5 features, hi then lo
constexpr int kSep = 6;            // sep_t rows: 3 features, hi then lo
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaskBytes = 3 * kTile * kLd * 2;  // neigh, w_hi, w_lo
constexpr int kFeatBytes = 16 * kLd * 2;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Stage feature columns [base, base + kTile) of feat_t [10, N] and
// sep_t [6, N] (bf16, row-major) as zero-padded [16][kLd] tiles.
__device__ inline void load_features(const __nv_bfloat16* __restrict__ feat,
                                     const __nv_bfloat16* __restrict__ sep,
                                     int N, int base, __nv_bfloat16* s_feat,
                                     __nv_bfloat16* s_sep) {
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  for (int i = threadIdx.x; i < 16 * kTile; i += blockDim.x) {
    const int f = i / kTile, c = i % kTile, col = base + c;
    const bool in = col < N;
    s_feat[f * kLd + c] = (f < kFeat && in) ? feat[f * N + col] : zero;
    s_sep[f * kLd + c] = (f < kSep && in) ? sep[f * N + col] : zero;
  }
}

// Stage columns [base, base + kTile) of the boids, building the feature
// tiles from them as _lane_feats and _hi_lo do: positions into s_cpx and
// s_cpy; act, act*px, act*py, act*vx, act*vy in f32, each split into
// hi = bf16(x) and lo = bf16(x - hi), both rounded to nearest even. s_feat
// holds the five hi rows then the five lo rows, s_sep the hi then the lo
// rows of the first three; the rows past them and columns at or past N
// are zero.
__device__ inline void build_features(const float2* __restrict__ pos,
                                      const float2* __restrict__ vel,
                                      const float* __restrict__ active, int N,
                                      int base, float* s_cpx, float* s_cpy,
                                      __nv_bfloat16* s_feat,
                                      __nv_bfloat16* s_sep) {
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  for (int c = threadIdx.x; c < kTile; c += blockDim.x) {
    const int j = base + c;
    const bool in = j < N;
    const float2 p = in ? pos[j] : make_float2(0.f, 0.f);
    const float2 v = in ? vel[j] : make_float2(0.f, 0.f);
    const float a = in ? active[j] : 0.f;
    s_cpx[c] = p.x;
    s_cpy[c] = p.y;
    const float x[5] = {a, __fmul_rn(a, p.x), __fmul_rn(a, p.y),
                        __fmul_rn(a, v.x), __fmul_rn(a, v.y)};
#pragma unroll
    for (int f = 0; f < 5; ++f) {
      const __nv_bfloat16 hi = __float2bfloat16_rn(x[f]);
      const __nv_bfloat16 lo =
          __float2bfloat16_rn(__fsub_rn(x[f], __bfloat162float(hi)));
      s_feat[f * kLd + c] = hi;
      s_feat[(5 + f) * kLd + c] = lo;
      if (f < 3) {
        s_sep[f * kLd + c] = hi;
        s_sep[(3 + f) * kLd + c] = lo;
      }
    }
#pragma unroll
    for (int f = kFeat; f < 16; ++f) s_feat[f * kLd + c] = zero;
#pragma unroll
    for (int f = kSep; f < 16; ++f) s_sep[f * kLd + c] = zero;
  }
}

// The pair masks of rows (s_rpx, s_rpy) against columns (s_cpx, s_cpy),
// each kTile long, as _pair_masks builds them: d2 in f32 without FMA
// contraction, nb = d2 < r_n^2 and d2 >= 1e-10, w = rsqrt(d2) where also
// d2 < r_s^2 (no clamp: nb already excludes d2 < 1e-10), w split into
// round-to-nearest bf16 hi and lo. Columns at or past n_cols get zero.
__device__ inline void build_masks(const float* s_rpx, const float* s_rpy,
                                   const float* s_cpx, const float* s_cpy,
                                   int n_cols, float nr2, float sr2,
                                   __nv_bfloat16* s_neigh,
                                   __nv_bfloat16* s_whi,
                                   __nv_bfloat16* s_wlo) {
  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const int r = i / kTile, c = i % kTile;
    const float dx = __fsub_rn(s_rpx[r], s_cpx[c]);
    const float dy = __fsub_rn(s_rpy[r], s_cpy[c]);
    const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
    const bool nb = c < n_cols && d2 < nr2 && d2 >= 1e-10f;
    const float w = (nb && d2 < sr2) ? rsqrtf(d2) : 0.f;
    const __nv_bfloat16 hi = __float2bfloat16_rn(w);
    s_neigh[r * kLd + c] = __float2bfloat16_rn(nb ? 1.f : 0.f);
    s_whi[r * kLd + c] = hi;
    s_wlo[r * kLd + c] = __float2bfloat16_rn(__fsub_rn(w, __bfloat162float(hi)));
  }
}

// Row side of one tile for row group g (rows 16g..16g+15), k-steps
// [k0, k1): acc_n[f][r] += feat[f][c] * neigh[r][c], and acc_w the same
// with sep against w_hi, then w_lo. neigh stored [r][c] is B in column
// major.
__device__ inline void mma_rows(const __nv_bfloat16* s_feat,
                                const __nv_bfloat16* s_sep,
                                const __nv_bfloat16* s_neigh,
                                const __nv_bfloat16* s_whi,
                                const __nv_bfloat16* s_wlo, int g, int k0,
                                int k1, FragAcc& acc_n, FragAcc& acc_w) {
  FragA a;
  FragBCol b;
  for (int k = k0; k < k1; ++k) {
    const int m = (16 * g) * kLd + 16 * k;
    wmma::load_matrix_sync(a, s_feat + 16 * k, kLd);
    wmma::load_matrix_sync(b, s_neigh + m, kLd);
    wmma::mma_sync(acc_n, a, b, acc_n);
    wmma::load_matrix_sync(a, s_sep + 16 * k, kLd);
    wmma::load_matrix_sync(b, s_whi + m, kLd);
    wmma::mma_sync(acc_w, a, b, acc_w);
    wmma::load_matrix_sync(b, s_wlo + m, kLd);
    wmma::mma_sync(acc_w, a, b, acc_w);
  }
}

// The combine of _acc_sums and _combine_forces for one row: sn[10] and
// sw[6] are the summed accumulator rows, hi in the first half, lo in the
// second.
__device__ inline float2 combine(const float* sn, const float* sw, float rpx,
                                 float rpy, float rvx, float rvy, float ra,
                                 float ws, float wa, float wc) {
  const float n = sn[0] + sn[5];
  const float spx = sn[1] + sn[6], spy = sn[2] + sn[7];
  const float svx = sn[3] + sn[8], svy = sn[4] + sn[9];
  const float sw0 = sw[0] + sw[3], swx = sw[1] + sw[4], swy = sw[2] + sw[5];
  const float n_safe = fmaxf(n, 1.f);
  const float has = n > 0.f ? 1.f : 0.f;
  const float fx = ws * (rpx * sw0 - swx) + wa * (svx / n_safe - rvx) * has +
                   wc * (spx / n_safe - rpx) * has;
  const float fy = ws * (rpy * sw0 - swy) + wa * (svy / n_safe - rvy) * has +
                   wc * (spy / n_safe - rpy) * has;
  return make_float2(fx * ra, fy * ra);
}

}  // namespace ggrs_mxu
