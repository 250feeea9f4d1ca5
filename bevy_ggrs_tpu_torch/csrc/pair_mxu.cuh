// Shared pieces of the two tensor-core boids force kernels
// (pairwise_mxu.cu and pairwise_tri.cu): the pair-mask tile, the feature
// tiles (built from the boids), and the combine. Counterparts of
// _pair_masks, _lane_feats' tiles, _acc_sums and _combine_forces in
// bevy_ggrs_tpu/ops/pairwise.py.
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

// Stage boid j = base + c as column c of a tile, building its features as
// _lane_feats and _hi_lo do: its position into s_cpx[c] and s_cpy[c]; act,
// act*px, act*py, act*vx, act*vy in f32, each split into hi = bf16(x) and
// lo = bf16(x - hi), both rounded to nearest even. Column c of s_feat
// holds the five hi rows then the five lo rows, of s_sep the hi then the
// lo rows of the first three; the rows past them, and every row of a
// column at or past N, are zero.
__device__ inline void build_feature_column(const float2* __restrict__ pos,
                                            const float2* __restrict__ vel,
                                            const float* __restrict__ active,
                                            int N, int base, int c,
                                            float* s_cpx, float* s_cpy,
                                            __nv_bfloat16* s_feat,
                                            __nv_bfloat16* s_sep) {
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
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

// Stage columns [base, base + kTile) of the boids with
// build_feature_column, one column a thread.
__device__ inline void build_features(const float2* __restrict__ pos,
                                      const float2* __restrict__ vel,
                                      const float* __restrict__ active, int N,
                                      int base, float* s_cpx, float* s_cpy,
                                      __nv_bfloat16* s_feat,
                                      __nv_bfloat16* s_sep) {
  for (int c = threadIdx.x; c < kTile; c += blockDim.x)
    build_feature_column(pos, vel, active, N, base, c, s_cpx, s_cpy, s_feat,
                         s_sep);
}

// One pair of the masks, as _pair_masks builds it: d2 in f32 without FMA
// contraction, nb = d2 < r_n^2 and d2 >= 1e-10 (and the column inside
// the boids), w = rsqrt(d2) where also d2 < r_s^2 (no clamp: nb already
// excludes d2 < 1e-10).
__device__ inline void pair_mask(float rx, float ry, float cx, float cy,
                                 bool in, float nr2, float sr2, float& nb,
                                 float& w) {
  const float dx = __fsub_rn(rx, cx);
  const float dy = __fsub_rn(ry, cy);
  const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
  const bool near = in && d2 < nr2 && d2 >= 1e-10f;
  nb = near ? 1.f : 0.f;
  w = (near && d2 < sr2) ? rsqrtf(d2) : 0.f;
}

// The pair masks of rows (s_rpx, s_rpy) against columns (s_cpx, s_cpy),
// each kTile long (pair_mask), w split into round-to-nearest bf16 hi and
// lo; columns at or past n_cols get zero. For a block of kThreads
// threads: thread t takes columns 2 (t % 32) and 2 (t % 32) + 1, holding
// their positions in registers, and rows t / 32, t / 32 + kWarps, ...; a
// warp stores 64 consecutive bf16 of a matrix row at once, two a thread.
__device__ inline void build_masks(const float* s_rpx, const float* s_rpy,
                                   const float* s_cpx, const float* s_cpy,
                                   int n_cols, float nr2, float sr2,
                                   __nv_bfloat16* s_neigh,
                                   __nv_bfloat16* s_whi,
                                   __nv_bfloat16* s_wlo) {
  const int c = 2 * (threadIdx.x % 32);
  const float cx0 = s_cpx[c], cy0 = s_cpy[c];
  const float cx1 = s_cpx[c + 1], cy1 = s_cpy[c + 1];
  const bool in0 = c < n_cols, in1 = c + 1 < n_cols;
#pragma unroll 2
  for (int r = threadIdx.x / 32; r < kTile; r += kWarps) {
    const float rx = s_rpx[r], ry = s_rpy[r];
    float nb0, nb1, w0, w1;
    pair_mask(rx, ry, cx0, cy0, in0, nr2, sr2, nb0, w0);
    pair_mask(rx, ry, cx1, cy1, in1, nr2, sr2, nb1, w1);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(w0, w1);
    const int at = r * kLd + c;
    *reinterpret_cast<__nv_bfloat162*>(s_neigh + at) =
        __floats2bfloat162_rn(nb0, nb1);
    *reinterpret_cast<__nv_bfloat162*>(s_whi + at) = hi;
    *reinterpret_cast<__nv_bfloat162*>(s_wlo + at) = __floats2bfloat162_rn(
        __fsub_rn(w0, __low2float(hi)), __fsub_rn(w1, __high2float(hi)));
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
