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
// halves) and sep_t [6, N] (the first three, hi then lo); the pair
// matrices are the 0/1 neighbour mask and the hi/lo halves of the
// separation weight w = rsqrt(d2). Products are bf16 x bf16 with f32 sums.
// A bf16 x bf16 product is exact in f32, so the kernel and its plain
// version differ only in the order and rounding of the f32 sums.
//
// What bounds it on an H100: the instruction rate of the CUDA cores that
// build the masks. A pair costs about 14 instructions (d2 without FMA, three
// compares, the selects, the bf16 packing of nb, w_hi and w_lo) and one
// MUFU rsqrt, against 44 tensor-core flops (2 x (10 + 6 + 6) products)
// that the 989 TFLOP/s bf16 rate makes about 15 times cheaper. Bytes are
// 20 per boid, negligible. So the design spends nothing on the masks but
// their arithmetic: no shared memory and no barrier between building a
// mask and multiplying it. Compiled for sm_90a at M = 4, the loop runs
// 17.1 instructions a pair, features, loads and mma.sync included.
//
// Design: the pair matrix never leaves registers. A warp owns M row tiles
// of 16 rows (M in {1, 2, 4}) and one column rank, and walks the rank's
// columns 16 at a time. Each lane computes the 8 pairs of its
// mma.sync.m16n8k16 A fragment (rows lane/4 and lane/4 + 8 of each row
// tile, columns 2 (lane % 4) + {0, 1, 8, 9} of the step) with pair_mask's
// arithmetic, packs nb, w_hi and w_lo as bf16x2 A registers, and
// multiplies at once: neigh x feat as two n8 tiles (features 0-7, 8-15),
// then w_hi x sep and w_lo x sep into one n8 accumulator. The B fragments
// are the hi/lo features of the same four columns (feature lane/4), built
// in registers from pos, vel and active as build_feature_column builds
// them, once a step for the warp's M row tiles; one shuffle a register
// brings the lo halves that another lane's feature row holds. Row
// positions and the 12 accumulators a row tile stay in registers for the
// whole range. A block is 8 warps: P rank warps for each of 8 / P row
// groups. After its range each warp stores its accumulators to shared
// memory once; after one __syncthreads the block adds each (row, part)
// over the ranks in ascending order and combines one row a thread. No
// cluster, no distributed shared memory, no scratch, no atomics: launches
// on the same inputs are bitwise equal, which SyncTest needs. d2 is
// __fadd_rn(__fmul_rn(dx,dx), __fmul_rn(dy,dy)), never an FMA, so
// borderline pairs fall on the same side of each radius as in the plain
// version and in JAX.
//
// The order of a row's sums: P = mxu2_launch_shape(launch_rows, N)'s
// cluster width (now the number of column ranks), rank q's columns are the
// 64-column tiles mxu2_tile_ranges(N, P)[q], its partial is one chain of
// f32 accumulations over its columns in ascending order, and the ranks'
// partials add in ascending order before combine(). All of that is a
// function of (launch_rows, N) alone: M and the grid follow from B too
// (warp_tiles), but only decide which warp and block compute a row tile,
// never what the row's arithmetic is. So every branch of a batched launch
// is bitwise its unbatched launch, and a sharded row block with
// launch_rows = N gets the whole world's bits for its rows.
//
// A world stacked over B speculative branches is one launch of grid
// (blocks, B) (ggrs_branch_grid): blockIdx.y is the branch, whose
// operands and output start b R or b N boids in.

#include <cstdint>

#include "branch_grid.cuh"
#include "pair_mxu.cuh"

namespace {

using namespace ggrs_mxu;

constexpr int kRows = 16;             // rows of an mma.sync tile
constexpr int kStep = 16;             // columns of one k-step
constexpr int kParts = kFeat + kSep;  // accumulator rows the combine reads
constexpr int kLdStage = kParts + 1;  // floats a staged row: odd, so the
                                      // combine's row-a-thread reads spread
                                      // over the banks
constexpr int kFillBlocks = 4 * 132;  // blocks that fill the 132 SMs twice
                                      // over at two blocks an SM

// Row tiles a warp (M): the largest of 4, 2, 1 that still gives the launch
// kFillBlocks blocks, so a wide batch builds each column's features once
// for 64 rows and a single world still spreads over the SMs. Mirrored by
// ops/pairwise.py::mxu2_geometry.
inline int warp_tiles(long long B, int R, int P) {
  for (int m = 4; m > 1; m /= 2) {
    const long long rows = (long long)kRows * m * (kWarps / P);
    if (B * ((R + rows - 1) / rows) >= kFillBlocks) return m;
  }
  return 1;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// x0, x1 (two adjacent columns or pairs) as bf16x2 hi = bf16(x) and
// lo = bf16(x - hi), both rounded to nearest even (_hi_lo). hi's halves
// widen to f32 by a shift and a mask.
__device__ __forceinline__ void hi_lo(float x0, float x1, uint32_t& hi,
                                      uint32_t& lo) {
  hi = bits(__floats2bfloat162_rn(x0, x1));
  lo = bits(__floats2bfloat162_rn(__fsub_rn(x0, __uint_as_float(hi << 16)),
                                  __fsub_rn(x1, __uint_as_float(hi & 0xffff0000u))));
}

// pair_mask's tests and w for one pair, with the rsqrt flushing subnormal
// inputs: w is selected only where d2 >= 1e-10, a normal float, and there
// both give the same MUFU result.
__device__ __forceinline__ bool mask_pair(float rx, float ry, float cx,
                                          float cy, float nr2, float sr2,
                                          float& w) {
  const float dx = __fsub_rn(rx, cx);
  const float dy = __fsub_rn(ry, cy);
  const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
  const bool near = d2 < nr2 && d2 >= 1e-10f;
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d2));
  w = (near && d2 < sr2) ? r : 0.f;
  return near;
}

// d += a x b for one m16n8k16 tile: bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// What a lane needs of its feature row: with g = lane / 4, its column of
// the first n8 tile is feature g, which is x[g] (g < 5, hi) or x[g - 5]
// (lo), x = (a, a px, a py, a vx, a vy). The lo halves of feature 8 + g
// (second tile, g < 2: x[3 + g]) and of sep feature g (3 <= g < 6:
// x[g - 3]) are held by lane + 12 and lane + 8 (g + 3 and g + 2).
struct Lane {
  const float* coord;  // x's coordinate, stride 2 floats a boid
  bool own_a;          // x = a itself
  bool lo;             // the first tile takes the lo half
  bool n1, w_own, w_shfl;
  int src;             // the lane whose lo halves this lane takes
};

__device__ __forceinline__ Lane lane_of(const float2* pos, const float2* vel) {
  const int lane = threadIdx.x % 32, g = lane / 4;
  const int f = g < 5 ? g : g - 5;
  Lane l;
  l.coord = reinterpret_cast<const float*>(f <= 2 ? pos : vel) + (f == 2 || f == 4);
  l.own_a = f == 0;
  l.lo = g >= 5;
  l.n1 = g < 2;
  l.w_own = g < 3;
  l.w_shfl = g >= 3 && g < 6;
  l.src = (lane + (g < 2 ? 12 : 8)) & 31;
  return l;
}

// One k-step of a warp: the lane's four columns' positions and B
// fragments, then the A fragments and four mma.sync for each of the M row
// tiles. pos, active and coord point at the lane's first column, 2t after
// the step's; kEdge: the step reaches past N (left: the columns before N,
// counted from the step's first), and the columns past it read as zero
// features at the origin (their pairs then add +0).
template <int M, bool kEdge>
__device__ __forceinline__ void k_step(
    const float2* __restrict__ pos, const float* __restrict__ active,
    const float* __restrict__ coord, const Lane& l, int t, int left,
    const float (&rx)[M][2], const float (&ry)[M][2], float nr2, float sr2,
    float (&acc)[M][3][4]) {
  float cx[4], cy[4], x[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = (k & 1) + 8 * (k >> 1);
    const bool in = !kEdge || 2 * t + j < left;
    const float2 p = in ? pos[j] : make_float2(0.f, 0.f);
    const float a = in ? active[j] : 0.f;
    const float c = in ? coord[2 * j] : 0.f;
    cx[k] = p.x;
    cy[k] = p.y;
    x[k] = l.own_a ? a : __fmul_rn(a, c);
  }
  uint32_t b_n0[2], b_n1[2], b_w[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // columns 2t, 2t + 1, then 2t + 8, 2t + 9
    uint32_t hi, lo;
    hi_lo(x[2 * h], x[2 * h + 1], hi, lo);
    const uint32_t own = l.lo ? lo : hi;
    const uint32_t other = __shfl_sync(0xffffffffu, lo, l.src);
    b_n0[h] = own;
    b_n1[h] = l.n1 ? other : 0u;
    b_w[h] = l.w_own ? own : (l.w_shfl ? other : 0u);
  }
#pragma unroll
  for (int m = 0; m < M; ++m) {
    uint32_t an[4], ah[4], al[4];
#pragma unroll
    for (int h = 0; h < 2; ++h)      // column pair
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // row lane/4, then lane/4 + 8
        float w0, w1;
        const bool nb0 = mask_pair(rx[m][r], ry[m][r], cx[2 * h], cy[2 * h], nr2, sr2, w0);
        const bool nb1 = mask_pair(rx[m][r], ry[m][r], cx[2 * h + 1], cy[2 * h + 1],
                                   nr2, sr2, w1);
        // bf16 1.0 is 0x3f80: nb packed without a conversion.
        an[2 * h + r] = (nb0 ? 0x3f80u : 0u) | (nb1 ? 0x3f800000u : 0u);
        hi_lo(w0, w1, ah[2 * h + r], al[2 * h + r]);
      }
    mma(acc[m][0], an, b_n0[0], b_n0[1]);
    mma(acc[m][1], an, b_n1[0], b_n1[1]);
    mma(acc[m][2], ah, b_w[0], b_w[1]);
    mma(acc[m][2], al, b_w[0], b_w[1]);
  }
}

// combine() for one row, compiled once for every M, so that the FMAs the
// compiler contracts in it are the same whatever warp_tiles picks.
__device__ __noinline__ float2 combine_row(const float* s, float2 p, float2 v,
                                           float a, float ws, float wa,
                                           float wc) {
  return combine(s, s + kFeat, p.x, p.y, v.x, v.y, a, ws, wa, wc);
}

template <int M>
__global__ void __launch_bounds__(kThreads, 2) pairwise_force_rows_mxu_kernel(
        const float2* __restrict__ row_pos, const float2* __restrict__ row_vel,
        const float* __restrict__ row_active, const float2* __restrict__ all_pos,
        const float2* __restrict__ all_vel, const float* __restrict__ all_active,
        float2* __restrict__ out, int B, int R, int N, int P, float nr2,
        float sr2, float ws, float wa, float wc) {
  __shared__ float stage[kWarps * M * kRows * kLdStage];

  const long b = blockIdx.y + (long)gridDim.y * blockIdx.z;  // the branch
  if (b >= B) return;
  row_pos += b * R;
  row_vel += b * R;
  row_active += b * R;
  all_pos += b * N;
  all_vel += b * N;
  all_active += b * N;
  out += b * R;

  const int block_rows = kRows * M * (kWarps / P);
  const int row0 = blockIdx.x * block_rows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q = warp % P;                        // the column rank
  const int tile_row = (warp / P) * M * kRows;   // in the block
  const int g = lane / 4, t = lane % 4;

  float rx[M][2], ry[M][2], acc[M][3][4];
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row0 + tile_row + m * kRows + g + 8 * r;
      const float2 p = i < R ? row_pos[i] : make_float2(0.f, 0.f);
      rx[m][r] = p.x;
      ry[m][r] = p.y;
    }
#pragma unroll
    for (int s = 0; s < 3; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][s][e] = 0.f;
  }

  // Rank q's columns: the 64-column tiles [q T / P, (q + 1) T / P).
  const int tiles = (N + kTile - 1) / kTile;
  const int c_lo = q * tiles / P * kTile;
  const int c_hi = min((q + 1) * tiles / P * kTile, N);
  const Lane l = lane_of(all_pos, all_vel);
  const float2* pos = all_pos + c_lo + 2 * t;
  const float* act = all_active + c_lo + 2 * t;
  const float* coord = l.coord + 2 * (c_lo + 2 * t);
  int c0 = c_lo;
  for (; c0 + kStep <= c_hi; c0 += kStep) {
    k_step<M, false>(pos, act, coord, l, t, kStep, rx, ry, nr2, sr2, acc);
    pos += kStep;
    act += kStep;
    coord += 2 * kStep;
  }
  if (c0 < c_hi)
    k_step<M, true>(pos, act, coord, l, t, c_hi - c0, rx, ry, nr2, sr2, acc);

  // Accumulators to stage[rank][row][part]: parts 0-9 the neighbour sums
  // (tile 0's columns 2t, 2t + 1; tile 1's 8 + 2t, 9 + 2t for t = 0), 10-15
  // the separation sums (sep features 2t, 2t + 1 for t < 3).
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float* row = stage + (q * block_rows + tile_row + m * kRows + g + 8 * r) * kLdStage;
      row[2 * t] = acc[m][0][2 * r];
      row[2 * t + 1] = acc[m][0][2 * r + 1];
      if (t == 0) {
        row[8] = acc[m][1][2 * r];
        row[9] = acc[m][1][2 * r + 1];
      }
      if (t < 3) {
        row[kFeat + 2 * t] = acc[m][2][2 * r];
        row[kFeat + 2 * t + 1] = acc[m][2][2 * r + 1];
      }
    }
  __syncthreads();

  // Each (row, part) over the ranks in ascending order, into rank 0's
  // stage; then one row a thread.
  for (int i = threadIdx.x; i < block_rows * kParts; i += blockDim.x) {
    const int at = (i / kParts) * kLdStage + i % kParts;
    float sum = stage[at];
    for (int r = 1; r < P; ++r) sum = sum + stage[r * block_rows * kLdStage + at];
    stage[at] = sum;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < block_rows; r += blockDim.x) {
    const int i = row0 + r;
    if (i >= R) continue;
    out[i] = combine_row(stage + r * kLdStage, row_pos[i], row_vel[i],
                         row_active[i], ws, wa, wc);
  }
}

template <int M>
void launch(dim3 grid, cudaStream_t stream, const void* row_pos,
            const void* row_vel, const void* row_active, const void* all_pos,
            const void* all_vel, const void* all_active, void* out, int B,
            int R, int N, int P, float nr2, float sr2, float ws, float wa,
            float wc) {
  pairwise_force_rows_mxu_kernel<M><<<grid, kThreads, 0, stream>>>(
      (const float2*)row_pos, (const float2*)row_vel, (const float*)row_active,
      (const float2*)all_pos, (const float2*)all_vel, (const float*)all_active,
      (float2*)out, B, R, N, P, nr2, sr2, ws, wa, wc);
}

}  // namespace

// B: branches (1 for one world); P: column ranks, from
// ops/pairwise.py::mxu2_launch_shape.
extern "C" int ggrs_pairwise_force_rows_mxu(
    const void* row_pos, const void* row_vel, const void* row_active,
    const void* all_pos, const void* all_vel, const void* all_active,
    void* out, int B, int R, int N, int P, float nr2, float sr2, float ws,
    float wa, float wc, void* stream) {
  if (P != 1 && P != 2 && P != 4 && P != 8) return (int)cudaErrorInvalidValue;
  if (B < 1) return (int)cudaErrorInvalidValue;
  const int m = warp_tiles(B, R, P);
  const int block_rows = kRows * m * (kWarps / P);
  const dim3 grid = ggrs_branch_grid((R + block_rows - 1) / block_rows, B);
  auto run = &launch<1>;
  if (m == 4)
    run = &launch<4>;
  else if (m == 2)
    run = &launch<2>;
  run(grid, (cudaStream_t)stream, row_pos, row_vel, row_active, all_pos,
      all_vel, all_active, out, B, R, N, P, nr2, sr2, ws, wa, wc);
  return (int)cudaGetLastError();
}
