// K13, the SKIP root: cubic interpolation onto a 1-D grid and the rank-r
// Khatri-Rao products of the randomized range finder, without forming the
// (n, r^2) product M = R (.) F, M[i, a r + b] = R[i, a] F[i, b].
//
// Replaces simplex_gp_tpu/models/ski.py::SKIP._root (:87-124): the gather
// Fj = (w[:, :, None] * U[idx]).sum(1) (:108, after _interp_1d :46) and the
// Hadamard step M = R[:, :, None] * Fj[:, None, :] (:114-115), Y = M @ omega
// (:119) and B = Q.T @ M (:121), where XLA materialises M: 16 KB a row at
// r = 64, 1.07 GB at 65,536 rows and 6.6 GB at precipitation's 402,223, plus
// its cotangent under autodiff.
//
//   K13a sgp_ski_interp          F[i, :] = sum_t w[i, t] U[idx[i, t], :], the
//                                Keys weights and clipped taps computed once a
//                                point from x[i] and the grid's origin and
//                                step (device scalars); U staged once a block
//                                in shared memory; a team of r / 4 lanes a
//                                point, float4 columns (ski_interp_kernel).
//        sgp_ski_interp_scatter  its backward: dU[idx[i, t], :] += w[i, t] dF[i, :]
//                                in a fixed order, no atomics: a block owns a
//                                range of points, split into SKI_SCATTER_SLICES
//                                sub-ranges; thread (s, col) walks sub-range
//                                s in index order into column col of its own
//                                (g, r) slice in shared memory, the block adds
//                                its slices in order into its (g, r) partial,
//                                and a second pass adds the blocks' partials
//                                in block order (ski_gram_reduce_kernel), so
//                                dU repeats bit for bit.
//   K13b sgp_ski_kr_matmul       out = M W, W (r^2, k): for each a, the
//                                (rows, k) product T_a = F W_a (W_a = rows
//                                a r .. a r + r - 1 of W), then out +=
//                                R[:, a] T_a, on the tile engine below.
//   K13c sgp_ski_kr_gram         out = Q^T M, (k, r^2): for each a the (k x r)
//                                product (R[:, a] (.) Q)^T F, whose depth is
//                                the rows.  A block takes four values of a
//                                and one row chunk; the rows stream through
//                                a two-stage cp.async ring, R (.) Q is formed
//                                once a stage in shared memory, and each
//                                thread holds 8 x 8 outputs of one a from
//                                float4 fragments (K13b's 4 FFMAs a shared
//                                word).  The chunks fill the card in one
//                                wave; a second pass adds their partials in
//                                chunk order.  No atomics: it repeats bit
//                                for bit.
//   K13d sgp_ski_kr_adjoint      dR[i, a] = sum_b F[i, b] T_a[i, b] and
//                                dF[i, b] = sum_a R[i, a] T_a[i, b] with
//                                T_a = G W_a^T, on the same engine.
//
// The tile engine of K13b and K13d.  Each a is a (rows x 64) product 64 deep
// (depth b < r for K13b, c < k for K13d), so both are f32 FMA work:
// - A block of 256 threads takes SKI_ROWS = 256 rows and all k (K13b) or r
//   (K13d) columns.  Thread (ty, tx), ty < 32, tx < 8, holds rows 4 ty .. +3
//   and 128 + 4 ty .. +3 and columns 4 tx .. +3 and 32 + 4 tx .. +3: each
//   depth step loads 16 floats as four float4 from shared memory for 64
//   FFMAs, 4 FFMAs a word (the first design's 4 x 4 tiles of 64 rows: 2, by
//   scalar loads).
// - The left operand (F for K13b, G for K13d) is staged once a block,
//   transposed (depth-major) and XOR-swizzled by depth (ski_swz), so the
//   4-byte cp.async copies that transpose it write 32 banks a warp and a
//   thread's 4 rows stay one aligned float4.
// - R's (256, r) tile is staged once a block (row stride 65).  K13d
//   overwrites its column a with dR[:, a] once the row's lanes have read
//   it, and stores the tile coalesced at the end.
// - W_a streams through a ring of two cp.async stages in shared memory:
//   W_{a+1} is copied while the block multiplies by W_a, with one
//   __syncthreads an a; 16-byte copies when a stage's rows are a multiple
//   of 4 floats and 16-byte aligned, 4-byte ones otherwise.  K13b's
//   stage is W_a as it lies.  K13d reads W_a^T: the wrapper lays W out once
//   a call as Wt (r, k, r), Wt[a][c][b] = W[a r + b, c] (a copy of 4 r^2 k
//   bytes, 1 MB at r = k = 64), and the stage is swizzled like the left
//   operand.  Copies that put each element of W_a in its transposed place
//   inside the kernel (4-byte cp.async, no copy outside) measured 10% slower,
//   the wrapper's copy included (PERF.md).  At 256 rows a block, W
//   crosses L2 n / 256 times a call (0.27 GB at 65,536 rows; 1.07 GB at 64).
// - K13b adds R[:, a] T_a after each a's product (two register tiles).  R[i,
//   a] folded into each loaded F value instead (one tile, 8 more multiplies
//   a 64 FFMAs) measured 9-10% slower (PERF.md).
// - K13d's dR[i, a]: each lane dots its 8 columns of T_a with F's (F's
//   (256, 64) tile staged once), then the 8 lanes of a row group
//   reduce-scatter their 8 rows in 7 shuffles, each lane ending with one
//   row's sum, which it writes into R's tile.  dF stays in registers over
//   all a.
// - The depth loops run to a multiple of 8 over zeros: every staged position
//   past n, r or k is 0, and so is every ring position no copy writes.
// - Shared memory a block: K13b 164,864 bytes, K13d 230,400: one block an
//   SM, 8 warps.  Registers (ptxas, sm_90a): K13b 199, K13d 201; no spills
//   (the build log, simplex_gp_torch/build/*.log).
// - f32 FFMA only (TF32 off, no wgmma), a fixed summation order, no atomics:
//   a second call gives the same bits.
//
// Bound: K13b, K13c and K13d each do 2 n r^2 k multiply-adds' worth of f32
// FMA work (2 n r^3 flops at k = r: 34.4 GFLOP at n = 65,536, r = 64, a
// 0.51 ms bound at 67 TFLOP/s) against ~4 n r bytes of inputs, so they are
// compute-bound; K13a moves 4 n (r + 1) bytes and is byte-bound.  r and k
// are at most 64.
#include "common.cuh"

#define SKI_MAX_R 64
#define SKI_GRAM_A 4              // values of a one K13c block takes
#define SKI_GRAM_S 32             // rows of one K13c stage
#define SKI_GRAM_THREADS 256      // threads of a K13c block: 64 a value of a, 8 x 8 outputs each
#define SKI_GRAM_BLOCKS_PER_SM 2  // K13c blocks an SM (kernels/ski.py::_GRAM_SLOTS sizes its chunks by it)
#define SKI_SCATTER_SLICES 4  // point sub-ranges of a K13a backward block, each with its own (g, r) slice
#define SKI_ROWS 256          // rows of a K13b / K13d block
#define SKI_KR_THREADS 256    // threads of a K13b / K13d block, 8 x 8 outputs each
#define SKI_RS (SKI_MAX_R + 1)              // row stride of the staged R tile
#define SKI_AT (SKI_MAX_R * SKI_ROWS)       // floats of the staged, transposed left operand
#define SKI_RT (SKI_ROWS * SKI_RS)          // floats of the staged R tile
#define SKI_WSTAGE (SKI_MAX_R * SKI_MAX_R)  // floats of one stage of the W ring
#define SKI_GRAM_QS (SKI_GRAM_S * SKI_MAX_R)                // floats of a staged Q (or F) tile of K13c
#define SKI_GRAM_STAGE (2 * SKI_GRAM_QS + SKI_GRAM_S * SKI_GRAM_A)  // floats of a K13c ring slot: Q, F, R
#define SKI_GRAM_G (SKI_GRAM_A * SKI_GRAM_QS)               // floats of K13c's G tiles, R (.) Q for four a

// The four clipped grid indices and normalised Keys weights of x
// (_interp_1d), each float operation an explicit round-to-nearest one in
// the order of kernels/ski.py::interp_taps, so the taps are its bit for bit.
__device__ __forceinline__ float ski_cubic(float s) {
  s = fabsf(s);
  const float w1 = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(__fmul_rn(1.5f, s), 2.5f), s), s), 1.0f);
  const float w2 = __fadd_rn(__fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(__fmul_rn(-0.5f, s), 2.5f), s), 4.0f), s), 2.0f);
  return s <= 1.0f ? w1 : (s <= 2.0f ? w2 : 0.0f);
}

__device__ __forceinline__ void ski_taps(float x, float gmin, float step, int g, int* idx, float* w) {
  const float pos = __fdiv_rn(__fsub_rn(x, gmin), step);
  const int base = (int)floorf(pos);
  float sum = 0.0f;
  for (int t = 0; t < 4; ++t) {
    const int i = base + t - 1;
    w[t] = ski_cubic(__fsub_rn(pos, (float)i));
    idx[t] = min(max(i, 0), g - 1);
    sum = __fadd_rn(sum, w[t]);
  }
  sum = fmaxf(sum, 1e-12f);
  for (int t = 0; t < 4; ++t) w[t] = __fdiv_rn(w[t], sum);
}

// K13a.  A block stages the grid factor U (g, r) once in shared memory, its
// rows padded to r4 = 4 ceil(r / 4) floats (zeros past r), then takes
// SKI_INTERP_POINTS points a pass (the grid, at most the blocks resident at
// once, strides over the passes).  Thread t computes the taps of the pass's
// point t once (ski_taps; the first design recomputed them in each of the r
// threads of a point) into shared memory; then a team of `lanes` lanes a
// point (r4 / 4 rounded up to a power of two: 16 at r = 64) walks the
// pass's points, lane l summing columns 4 l .. 4 l + 3 over the taps t =
// 0..3 in order (each product and add rounded on its own) from float4 reads
// of the staged rows, and storing them as one float4: a point's row is one
// contiguous 16-byte store a lane across its team (scalar stores when r is
// not a multiple of 4).  Bound: bytes, x and U in, F (4 n r) out; U is read
// from device memory once a block, not four times an output.
#define SKI_INTERP_THREADS 256
#define SKI_INTERP_POINTS 256

__global__ void __launch_bounds__(SKI_INTERP_THREADS)
    ski_interp_kernel(const float* __restrict__ x, const float* __restrict__ gmin, const float* __restrict__ step,
                      const float* __restrict__ U, int n, int g, int r, int lanes, bool vec,
                      float* __restrict__ F) {
  extern __shared__ __align__(16) float ski_u[];  // (g, r4), then the pass's tap rows and weights
  const int r4 = (r + 3) & ~3;
  int* tap_row = reinterpret_cast<int*>(ski_u + g * r4);  // (4, SKI_INTERP_POINTS): idx[t] r4
  float* tap_w = reinterpret_cast<float*>(tap_row + 4 * SKI_INTERP_POINTS);
  if (vec) {  // r a multiple of 4 and U 16-byte aligned: the rows need no padding
    const int total = g * (r >> 2);
    for (int e = threadIdx.x; e < total; e += blockDim.x)
      reinterpret_cast<float4*>(ski_u)[e] = __ldg(reinterpret_cast<const float4*>(U) + e);
  } else {
    for (int e = threadIdx.x; e < g * r4; e += blockDim.x) {
      const int row = e / r4, col = e - row * r4;
      ski_u[e] = col < r ? __ldg(U + (long long)row * r + col) : 0.0f;
    }
  }
  const float gm = *gmin, st = *step;
  const int teams = blockDim.x / lanes, team = threadIdx.x / lanes, c0 = 4 * (threadIdx.x - team * lanes);
  for (long long p0 = (long long)blockIdx.x * SKI_INTERP_POINTS; p0 < n;
       p0 += (long long)gridDim.x * SKI_INTERP_POINTS) {
    const int np = n - p0 < SKI_INTERP_POINTS ? (int)(n - p0) : SKI_INTERP_POINTS;
    __syncthreads();  // the previous pass's taps are read
    if ((int)threadIdx.x < np) {
      int idx[4];
      float w[4];
      ski_taps(__ldg(x + p0 + threadIdx.x), gm, st, g, idx, w);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        tap_row[t * SKI_INTERP_POINTS + threadIdx.x] = idx[t] * r4;
        tap_w[t * SKI_INTERP_POINTS + threadIdx.x] = w[t];
      }
    }
    __syncthreads();
    if (c0 >= r) continue;
    for (int i = team; i < np; i += teams) {
      float acc[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float w = tap_w[t * SKI_INTERP_POINTS + i];
        const float4 u = *reinterpret_cast<const float4*>(ski_u + tap_row[t * SKI_INTERP_POINTS + i] + c0);
        const float pu[4] = {__fmul_rn(w, u.x), __fmul_rn(w, u.y), __fmul_rn(w, u.z), __fmul_rn(w, u.w)};
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[q] = t == 0 ? pu[q] : __fadd_rn(acc[q], pu[q]);
      }
      float* o = F + (p0 + i) * r + c0;
      if (vec) {
        *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2], acc[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (c0 + q < r) o[q] = acc[q];
      }
    }
  }
}

// K13a's backward, first pass: block b owns the points [b S span, (b + 1) S
// span) (S = SKI_SCATTER_SLICES); thread (s, col) adds w[i, t] dF[i, col]
// into row idx[i, t] of its slice s for i in sub-range s ([(b S + s) span,
// + span)) in index order and t = 0..3, each add round-to-nearest; then
// the block's partial (g, r) is slice 0 + slice 1 + ... in order.
__global__ void __launch_bounds__(SKI_MAX_R * SKI_SCATTER_SLICES)
    ski_interp_scatter_kernel(const float* __restrict__ x, const float* __restrict__ gmin,
                              const float* __restrict__ step, const float* __restrict__ dF, int n, int g, int r,
                              int span, float* __restrict__ partial) {
  extern __shared__ float slices[];  // (S, g, r)
  const int size = g * r;
  for (int e = threadIdx.x; e < SKI_SCATTER_SLICES * size; e += blockDim.x) slices[e] = 0.0f;
  __syncthreads();
  const int s = threadIdx.x / SKI_MAX_R, col = threadIdx.x % SKI_MAX_R;
  if (col < r) {
    float* mine = slices + s * size;
    const float gm = *gmin, st = *step;
    const long long lo = ((long long)blockIdx.x * SKI_SCATTER_SLICES + s) * span;
    const long long hi = lo + span < n ? lo + span : n;
    for (long long i = lo; i < hi; ++i) {
      int idx[4];
      float w[4];
      ski_taps(x[i], gm, st, g, idx, w);
      const float v = dF[i * r + col];
      for (int t = 0; t < 4; ++t) mine[idx[t] * r + col] = __fadd_rn(mine[idx[t] * r + col], __fmul_rn(w[t], v));
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < size; e += blockDim.x) {
    float acc = slices[e];
    for (int k = 1; k < SKI_SCATTER_SLICES; ++k) acc = __fadd_rn(acc, slices[k * size + e]);
    partial[(long long)blockIdx.x * size + e] = acc;
  }
}

// ---- the tile engine of K13b and K13d ---------------------------------------

// Position of element (j, i) of a depth-major tile of row stride `stride`: i's bits 2-4 XORed with j's bits
// 0-2, so four consecutive i from a multiple of 4 stay one aligned float4, in order.
__device__ __forceinline__ int ski_swz(int j, int i, int stride) { return j * stride + (i ^ ((j & 7) << 2)); }

// Row m < 8 of a thread of row group ty: 4 ty + m, then SKI_ROWS / 2 + 4 ty + m - 4.
__device__ __forceinline__ int ski_row(int ty, int m) { return (m < 4 ? 0 : SKI_ROWS / 2 - 4) + 4 * ty + m; }

// v[0..3] = base[off .. off + 3], v[4..7] = base[off + half .. off + half + 3], as two float4.
__device__ __forceinline__ void ski_frag8(const float* base, int off, int half, float* v) {
  const float4 lo = *reinterpret_cast<const float4*>(base + off);
  const float4 hi = *reinterpret_cast<const float4*>(base + off + half);
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = lo.z;
  v[3] = lo.w;
  v[4] = hi.x;
  v[5] = hi.y;
  v[6] = hi.z;
  v[7] = hi.w;
}

// X's rows [i0, i0 + SKI_ROWS) (n x w, row-major, w <= 64) into the depth-major tile At (ski_swz, stride
// SKI_ROWS) by 4-byte copies; zeros past n and w.  Element e: j takes e's bits 0-2 and 5-7, i its bits 3-4 and
// 8 up, so a warp reads 4 rows x 8 neighbouring floats of X and, through ski_swz, writes 32 banks.
__device__ __forceinline__ void ski_stage_transposed(float* At, const float* X, long long i0, int n, int w) {
  for (int e = threadIdx.x; e < SKI_AT; e += SKI_KR_THREADS) {
    const int j = (e & 7) | ((e >> 2) & 0x38), i = ((e >> 3) & 3) | ((e >> 6) & ~3);
    float* dst = At + ski_swz(j, i, SKI_ROWS);
    if (i0 + i < n && j < w)
      sgp_cp4(dst, X + (i0 + i) * w + j);
    else
      *dst = 0.0f;
  }
}

// X's rows [i0, i0 + SKI_ROWS) (n x w, row-major, w <= 64) into Xs[i][j] (row stride `stride`): 16-byte
// copies when vec (w a multiple of 4, X 16-byte aligned, stride a multiple of 4), else 4-byte ones; zeros
// past n and w.
__device__ __forceinline__ void ski_stage_rows(float* Xs, int stride, const float* X, long long i0, int n, int w,
                                               bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < SKI_ROWS * SKI_MAX_R / 4; e += SKI_KR_THREADS) {
      const int i = e >> 4, j = (e & 15) << 2;
      float* dst = Xs + i * stride + j;
      if (i0 + i < n && j < w)
        sgp_cp16(dst, X + (i0 + i) * w + j);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  } else {
    for (int e = threadIdx.x; e < SKI_ROWS * SKI_MAX_R; e += SKI_KR_THREADS) {
      const int i = e >> 6, j = e & (SKI_MAX_R - 1);
      if (i0 + i < n && j < w)
        sgp_cp4(Xs + i * stride + j, X + (i0 + i) * w + j);
      else
        Xs[i * stride + j] = 0.0f;
    }
  }
}

// One stage of the W ring, as one commit group: block a of base, the (rows x cols) row-major block at base +
// a rows cols, into Ws[x][y] (row stride 64; y swizzled by x through ski_swz when SWZ), by 16-byte copies when
// vec (cols a multiple of 4, base 16-byte aligned), else 4-byte ones.  K13b's stage is W_a (r x k), K13d's
// W_a^T (k x r), swizzled.  (The offset taken here rather than by the caller: K13b measured 3% faster.)
template <bool SWZ>
__device__ __forceinline__ void ski_load_stage(float* Ws, const float* base, int a, int rows, int cols, bool vec) {
  const float* src = base + (long long)a * rows * cols;
  if (vec) {
    for (int e = threadIdx.x; e < SKI_WSTAGE / 4; e += SKI_KR_THREADS) {
      const int x = e >> 4, y = (e & 15) << 2;
      if (x < rows && y < cols)
        sgp_cp16(Ws + (SWZ ? ski_swz(x, y, SKI_MAX_R) : x * SKI_MAX_R + y), src + x * cols + y);
    }
  } else {
    for (int e = threadIdx.x; e < SKI_WSTAGE; e += SKI_KR_THREADS) {
      const int x = e >> 6, y = e & (SKI_MAX_R - 1);
      if (x < rows && y < cols)
        sgp_cp4(Ws + (SWZ ? ski_swz(x, y, SKI_MAX_R) : x * SKI_MAX_R + y), src + x * cols + y);
    }
  }
  sgp_commit();
}

// Zeros every position of both ring stages that no copy writes: position p of a stage is (x, y) = (p / 64,
// p mod 64), y unswizzled when SWZ, and a copy writes it iff x < rows and y < cols.
template <bool SWZ>
__device__ __forceinline__ void ski_zero_ring(float* ring, int rows, int cols) {
  if (rows >= SKI_MAX_R && cols >= SKI_MAX_R) return;
  for (int e = threadIdx.x; e < 2 * SKI_WSTAGE; e += SKI_KR_THREADS) {
    const int x = (e & (SKI_WSTAGE - 1)) >> 6;
    const int y = SWZ ? (e & (SKI_MAX_R - 1)) ^ ((x & 7) << 2) : e & (SKI_MAX_R - 1);
    if (x >= rows || y >= cols) ring[e] = 0.0f;
  }
}

// out (n, k) = sum_a R[:, a] (F W_a), W_a = W[a r : a r + r, :].  A block takes SKI_ROWS rows; thread (ty,
// tx) holds rows ski_row(ty, m) and columns 4 tx + q, 32 + 4 tx + q; T_a = F W_a in one register tile, then
// out += R[:, a] T_a into a second.
__global__ void __launch_bounds__(SKI_KR_THREADS, 1)
    ski_kr_matmul_kernel(const float* __restrict__ R, const float* __restrict__ F, const float* __restrict__ W,
                         int n, int r, int k, bool vec_w, bool vec_out, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* At = smem;         // F^T, swizzled
  float* Rs = At + SKI_AT;  // R's tile
  float* Ws = Rs + SKI_RT;  // the ring: two stages of W_a
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const long long i0 = (long long)blockIdx.x * SKI_ROWS;
  ski_stage_transposed(At, F, i0, n, r);
  ski_stage_rows(Rs, SKI_RS, R, i0, n, r, false);
  sgp_commit();
  ski_zero_ring<false>(Ws, r, k);
  ski_load_stage<false>(Ws, W, 0, r, k, vec_w);
  const int depth = (r + 7) & ~7;
  float acc[8][8];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[m][q] = 0.0f;
  for (int a = 0; a < r; ++a) {
    sgp_wait_all();
    __syncthreads();  // W_a (at a = 0 the tiles too) in place; no thread still reads stage (a + 1) & 1
    if (a + 1 < r)
      ski_load_stage<false>(Ws + ((a + 1) & 1) * SKI_WSTAGE, W, a + 1, r, k, vec_w);
    const float* ws = Ws + (a & 1) * SKI_WSTAGE;
    float ra[8], t[8][8];
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      ra[m] = Rs[ski_row(ty, m) * SKI_RS + a];
#pragma unroll
      for (int q = 0; q < 8; ++q) t[m][q] = 0.0f;
    }
    for (int b0 = 0; b0 < depth; b0 += 8) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int b = b0 + u;
        float f[8], w[8];
        ski_frag8(At + b * SKI_ROWS, (ty << 2) ^ (u << 2), SKI_ROWS / 2, f);
        ski_frag8(ws + b * SKI_MAX_R, tx << 2, SKI_MAX_R / 2, w);
#pragma unroll
        for (int m = 0; m < 8; ++m)
#pragma unroll
          for (int q = 0; q < 8; ++q) t[m][q] = fmaf(f[m], w[q], t[m][q]);
      }
    }
#pragma unroll
    for (int m = 0; m < 8; ++m)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[m][q] = fmaf(ra[m], t[m][q], acc[m][q]);
  }
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const long long i = i0 + ski_row(ty, m);
    if (i >= n) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = (tx << 2) + h * (SKI_MAX_R / 2);
      float* o = out + i * k + c;
      if (vec_out) {
        if (c < k)
          *reinterpret_cast<float4*>(o) =
              make_float4(acc[m][4 * h], acc[m][4 * h + 1], acc[m][4 * h + 2], acc[m][4 * h + 3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (c + q < k) o[q] = acc[m][4 * h + q];
      }
    }
  }
}

// ---- K13c on the same fragments ----------------------------------------------

// Stage s of a K13c chunk as one commit group: rows [i0, i0 + SKI_GRAM_S) of Q (n x k) and F (n x r) into
// the slot's Qs and Fs (row stride 64) and R's columns a0 .. a0 + 3 of those rows into Rs (row stride 4);
// rows at or past c1 are zeroed.  16-byte copies where vec_q, vec_f, vec_r (a width that is a multiple of 4,
// the array 16-byte aligned), else 4-byte ones.  Columns past k or r are left as they are: they reach only
// outputs that are never written.
__device__ __forceinline__ void ski_gram_stage(float* slot, const float* Q, const float* R, const float* F,
                                               long long i0, long long c1, int r, int k, int a0, bool vec_q,
                                               bool vec_f, bool vec_r) {
  float* Qs = slot;
  float* Fs = slot + SKI_GRAM_QS;
  float* Rs = slot + 2 * SKI_GRAM_QS;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int e = threadIdx.x; e < SKI_GRAM_S * SKI_MAX_R / 4; e += SKI_GRAM_THREADS) {
    const int i = e >> 4, j = (e & 15) << 2;
    const long long row = i0 + i;
    float* q = Qs + i * SKI_MAX_R + j;
    float* f = Fs + i * SKI_MAX_R + j;
    if (row >= c1) {
      *reinterpret_cast<float4*>(q) = zero;
      *reinterpret_cast<float4*>(f) = zero;
      continue;
    }
    if (vec_q) {
      if (j < k) sgp_cp16(q, Q + row * k + j);
    } else {
      for (int u = 0; u < 4; ++u)
        if (j + u < k) sgp_cp4(q + u, Q + row * k + j + u);
    }
    if (vec_f) {
      if (j < r) sgp_cp16(f, F + row * r + j);
    } else {
      for (int u = 0; u < 4; ++u)
        if (j + u < r) sgp_cp4(f + u, F + row * r + j + u);
    }
  }
  if (threadIdx.x < SKI_GRAM_S) {
    const int i = threadIdx.x;
    const long long row = i0 + i;
    float* rs = Rs + i * SKI_GRAM_A;
    if (row >= c1)
      *reinterpret_cast<float4*>(rs) = zero;
    else if (vec_r)
      sgp_cp16(rs, R + row * r + a0);
    else
      for (int u = 0; u < SKI_GRAM_A; ++u)
        if (a0 + u < r) sgp_cp4(rs + u, R + row * r + a0 + u);
  }
  sgp_commit();
}

// partial[chunk][p][a r + b] = sum over the chunk's rows i of Q[i, p] R[i, a] F[i, b], for the block's four
// values a = a0 + aa of a (blockIdx.x) over one row chunk (blockIdx.y).  Each a is a (k x r) product whose
// depth is the rows: B_a = (R[:, a] (.) Q)^T F, both operands row-major, i.e. already depth-major.  The rows
// stream in stages of SKI_GRAM_S through a ring of two cp.async slots (Q, F and R's four columns): stage s
// + 1 is copied while the block works on stage s.  Once a stage, G_aa = R[:, a0 + aa] (.) Q is formed in
// shared memory for the four a, one multiply an element (a thread multiplies 32), so the product loop runs
// FFMA alone.  Thread (aa, ty, tx) holds the 8 x 8 outputs p = 4 ty + m, 32 + 4 ty + m and b = 4 tx + q,
// 32 + 4 tx + q of B_{a0 + aa}: each row loads G's and F's fragments as four float4 (broadcast within a warp)
// for 64 FFMAs, K13b's 4 FFMAs a shared word.  Each staged row of Q and F serves four a (the grid's a-groups
// of one chunk run side by side, so a chunk's rows cross L2 r / 4 times and the device memory once).
// Outputs sum over rows in row order, so a second call gives the same bits.
__global__ void __launch_bounds__(SKI_GRAM_THREADS, SKI_GRAM_BLOCKS_PER_SM)
    ski_kr_gram_kernel(const float* __restrict__ Q, const float* __restrict__ R, const float* __restrict__ F, int n,
                       int r, int k, int chunk_rows, bool vec_q, bool vec_f, bool vec_r, bool vec_out,
                       float* __restrict__ partial) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                      // two stage slots: Qs, Fs (SKI_GRAM_S x 64 each), Rs (SKI_GRAM_S x 4)
  float* Gs = smem + 2 * SKI_GRAM_STAGE;   // G_aa[i][p] = R[i, a0 + aa] Q[i, p], (4, SKI_GRAM_S, 64)
  const int tid = threadIdx.x, aa = tid >> 6, ty = (tid >> 3) & 7, tx = tid & 7;
  const int a0 = blockIdx.x * SKI_GRAM_A;
  const long long c0 = (long long)blockIdx.y * chunk_rows;
  const long long c1 = c0 + chunk_rows < (long long)n ? c0 + chunk_rows : (long long)n;
  const int stages = c1 > c0 ? (int)((c1 - c0 + SKI_GRAM_S - 1) / SKI_GRAM_S) : 0;
  if (stages > 0) ski_gram_stage(ring, Q, R, F, c0, c1, r, k, a0, vec_q, vec_f, vec_r);
  float acc[8][8];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[m][q] = 0.0f;
  for (int s = 0; s < stages; ++s) {
    sgp_wait_all();
    __syncthreads();  // stage s in place; no thread still reads G or the slot that stage s + 1 takes
    if (s + 1 < stages)
      ski_gram_stage(ring + ((s + 1) & 1) * SKI_GRAM_STAGE, Q, R, F, c0 + (long long)(s + 1) * SKI_GRAM_S, c1, r,
                     k, a0, vec_q, vec_f, vec_r);
    const float* slot = ring + (s & 1) * SKI_GRAM_STAGE;
    for (int e = tid; e < SKI_GRAM_G / 4; e += SKI_GRAM_THREADS) {  // e: (aa, i, 4 p's)
      const int g = e / (SKI_GRAM_QS / 4), i = (e >> 4) & (SKI_GRAM_S - 1), p = (e & 15) << 2;
      const float ra = slot[2 * SKI_GRAM_QS + i * SKI_GRAM_A + g];
      const float4 qv = *reinterpret_cast<const float4*>(slot + i * SKI_MAX_R + p);
      *reinterpret_cast<float4*>(Gs + 4 * e) = make_float4(ra * qv.x, ra * qv.y, ra * qv.z, ra * qv.w);
    }
    __syncthreads();  // G in place
    const float* ga = Gs + aa * SKI_GRAM_QS;
    const float* fs = slot + SKI_GRAM_QS;
#pragma unroll
    for (int i = 0; i < SKI_GRAM_S; ++i) {  // unrolled whole: faster than by 4 or 8 (PERF.md)
      float gv[8], fv[8];
      ski_frag8(ga + i * SKI_MAX_R, ty << 2, SKI_MAX_R / 2, gv);
      ski_frag8(fs + i * SKI_MAX_R, tx << 2, SKI_MAX_R / 2, fv);
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[m][q] = fmaf(gv[m], fv[q], acc[m][q]);
    }
  }
  const int a = a0 + aa;
  if (a >= r) return;
  const long long rr = (long long)r * r;
  float* dst = partial + (long long)blockIdx.y * k * rr + (long long)a * r;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int p = (m < 4 ? 0 : SKI_MAX_R / 2 - 4) + 4 * ty + m;
    if (p >= k) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = (tx << 2) + h * (SKI_MAX_R / 2);
      float* o = dst + p * rr + b;
      if (vec_out) {
        if (b < r)
          *reinterpret_cast<float4*>(o) =
              make_float4(acc[m][4 * h], acc[m][4 * h + 1], acc[m][4 * h + 2], acc[m][4 * h + 3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (b + q < r) o[q] = acc[m][4 * h + q];
      }
    }
  }
}

__global__ void ski_gram_reduce_kernel(const float* __restrict__ partial, long long size, int chunks,
                                       float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= size) return;
  float s = 0.0f;
  for (int c = 0; c < chunks; ++c) s += partial[(long long)c * size + e];
  out[e] = s;
}

// The 8 lanes l = lane mod 8 of a row group each hold p[m] for the group's rows m < 8; returns the sum of
// the 8 lanes' p[l]: three xor steps (4, 2, 1), each lane keeping the half of its rows that holds row l and
// adding its partner's, so the sums are taken in one fixed order.
__device__ __forceinline__ float ski_reduce_scatter8(const float* p, int l) {
  const bool b2 = l & 4, b1 = l & 2, b0 = l & 1;
  float q[4], h[2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // q[j]: row j + 4 b2
    const float mine = b2 ? p[j + 4] : p[j], theirs = b2 ? p[j] : p[j + 4];
    q[j] = mine + __shfl_xor_sync(0xffffffffu, theirs, 4);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {  // h[j]: row j + 2 b1 + 4 b2
    const float mine = b1 ? q[j + 2] : q[j], theirs = b1 ? q[j] : q[j + 2];
    h[j] = mine + __shfl_xor_sync(0xffffffffu, theirs, 2);
  }
  const float mine = b0 ? h[1] : h[0], theirs = b0 ? h[0] : h[1];
  return mine + __shfl_xor_sync(0xffffffffu, theirs, 1);
}

// dR, dF (n, r) of <G, M W>: T_a = G W_a^T, dF = sum_a R[:, a] T_a, dR[:, a] = rowsum(F T_a).  A block takes
// SKI_ROWS rows; thread (ty, tx) holds rows ski_row(ty, m) and grid columns b = 4 tx + q, 32 + 4 tx + q of
// T_a and of dF.  dR[:, a] overwrites column a of R's tile once the row's 8 lanes have read it.
__global__ void __launch_bounds__(SKI_KR_THREADS, 1)
    ski_kr_adjoint_kernel(const float* __restrict__ R, const float* __restrict__ F, const float* __restrict__ Wt,
                          const float* __restrict__ G, int n, int r, int k, bool vec_f, bool vec_w, bool vec_df,
                          float* __restrict__ dR, float* __restrict__ dF) {
  extern __shared__ __align__(16) float smem[];
  float* At = smem;                        // G^T, swizzled
  float* Fs = At + SKI_AT;                 // F's tile, row stride 64
  float* Rs = Fs + SKI_ROWS * SKI_MAX_R;   // R's tile, then dR's
  float* Ws = Rs + SKI_RT;                 // the ring: two stages of W_a^T
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const long long i0 = (long long)blockIdx.x * SKI_ROWS;
  ski_stage_transposed(At, G, i0, n, k);
  ski_stage_rows(Fs, SKI_MAX_R, F, i0, n, r, vec_f);
  ski_stage_rows(Rs, SKI_RS, R, i0, n, r, false);
  sgp_commit();
  ski_zero_ring<true>(Ws, k, r);
  ski_load_stage<true>(Ws, Wt, 0, k, r, vec_w);
  const int depth = (k + 7) & ~7;
  float acc[8][8];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[m][q] = 0.0f;
  for (int a = 0; a < r; ++a) {
    sgp_wait_all();
    __syncthreads();  // W_a (at a = 0 the tiles too) in place; no thread still reads stage (a + 1) & 1
    if (a + 1 < r)
      ski_load_stage<true>(Ws + ((a + 1) & 1) * SKI_WSTAGE, Wt, a + 1, k, r, vec_w);
    const float* wt = Ws + (a & 1) * SKI_WSTAGE;
    float t[8][8];
#pragma unroll
    for (int m = 0; m < 8; ++m)
#pragma unroll
      for (int q = 0; q < 8; ++q) t[m][q] = 0.0f;
    for (int c0 = 0; c0 < depth; c0 += 8) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int c = c0 + u;
        float g[8], w[8];
        ski_frag8(At + c * SKI_ROWS, (ty << 2) ^ (u << 2), SKI_ROWS / 2, g);
        ski_frag8(wt + c * SKI_MAX_R, (tx << 2) ^ (u << 2), SKI_MAX_R / 2, w);
#pragma unroll
        for (int m = 0; m < 8; ++m)
#pragma unroll
          for (int q = 0; q < 8; ++q) t[m][q] = fmaf(g[m], w[q], t[m][q]);
      }
    }
    float p[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int row = ski_row(ty, m);
      const float ra = Rs[row * SKI_RS + a];
      float f[8];
      ski_frag8(Fs + row * SKI_MAX_R, tx << 2, SKI_MAX_R / 2, f);
      p[m] = 0.0f;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        p[m] = fmaf(f[q], t[m][q], p[m]);
        acc[m][q] = fmaf(ra, t[m][q], acc[m][q]);
      }
    }
    const float dr = ski_reduce_scatter8(p, tx);
    __syncwarp();  // the row group's lanes have read R[:, a]
    Rs[ski_row(ty, tx) * SKI_RS + a] = dr;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < SKI_ROWS * SKI_MAX_R; e += SKI_KR_THREADS) {
    const int i = e >> 6, a = e & (SKI_MAX_R - 1);
    if (i0 + i < n && a < r) dR[(i0 + i) * r + a] = Rs[i * SKI_RS + a];
  }
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const long long i = i0 + ski_row(ty, m);
    if (i >= n) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = (tx << 2) + h * (SKI_MAX_R / 2);
      float* o = dF + i * r + b;
      if (vec_df) {
        if (b < r)
          *reinterpret_cast<float4*>(o) =
              make_float4(acc[m][4 * h], acc[m][4 * h + 1], acc[m][4 * h + 2], acc[m][4 * h + 3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (b + q < r) o[q] = acc[m][4 * h + q];
      }
    }
  }
}

// K13a: lanes a point (kernels/ski.py::interp_split: a power of two, 4 lanes >= r, at most 32) and the
// dynamic shared memory (U's padded rows and a pass's taps, smem bytes) from the wrapper; the grid is the
// passes of SKI_INTERP_POINTS points, or the blocks resident at once if fewer.
extern "C" int sgp_ski_interp(const float* x, const float* gmin, const float* step, const float* U, int n, int g,
                              int r, int lanes, int smem, float* F, void* stream) {
  const int r4 = (r + 3) & ~3;
  if (r < 1 || g < 1 || lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0 || 4 * lanes < r ||
      (size_t)smem != sizeof(float) * ((size_t)g * r4 + 8 * SKI_INTERP_POINTS) || smem > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  static int opted = 0;  // the shared-memory opt-in, set once a size
  if (smem > 48 * 1024 && smem > opted) {
    const cudaError_t err =
        cudaFuncSetAttribute(ski_interp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    opted = smem;
  }
  const bool vec = r % 4 == 0 && (((uintptr_t)U | (uintptr_t)F) & 15) == 0;
  const long long passes = ((long long)n + SKI_INTERP_POINTS - 1) / SKI_INTERP_POINTS;
  const int resident = sgp_coresident_blocks(ski_interp_kernel, SKI_INTERP_THREADS, (size_t)smem);
  const int grid = (int)(passes < resident ? passes : resident);
  ski_interp_kernel<<<grid, SKI_INTERP_THREADS, smem, (cudaStream_t)stream>>>(x, gmin, step, U, n, g, r, lanes, vec,
                                                                              F);
  return (int)cudaGetLastError();
}

// K13a's backward: blocks blocks of SKI_SCATTER_SLICES sub-ranges of span
// points (kernels/ski.py::_scatter_split); partial (blocks, g, r) need not
// be zeroed; dU (g, r) is written (partial itself when blocks == 1).  The
// S (g, r) slices must fit in a block's shared memory.
extern "C" int sgp_ski_interp_scatter(const float* x, const float* gmin, const float* step, const float* dF, int n,
                                      int g, int r, int span, int blocks, float* partial, float* dU, void* stream) {
  const size_t smem = (size_t)SKI_SCATTER_SLICES * g * r * sizeof(float);
  if (r > SKI_MAX_R || smem > 227 * 1024 || span < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  static size_t opted = 0;  // the shared-memory opt-in, set once a size
  if (smem > 48 * 1024 && smem > opted) {
    const cudaError_t err =
        cudaFuncSetAttribute(ski_interp_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted = smem;
  }
  ski_interp_scatter_kernel<<<blocks, SKI_MAX_R * SKI_SCATTER_SLICES, smem, st>>>(x, gmin, step, dF, n, g, r, span,
                                                                                 blocks == 1 ? dU : partial);
  if (blocks > 1) {
    const long long size = (long long)g * r;
    ski_gram_reduce_kernel<<<sgp_blocks(size), SGP_THREADS, 0, st>>>(partial, size, blocks, dU);
  }
  return (int)cudaGetLastError();
}

// Shared memory of a K13b (or K13d) block: the transposed left operand, R's tile, the ring (and F's tile).
static size_t ski_kr_smem(bool adjoint) {
  return sizeof(float) * (SKI_AT + SKI_RT + 2 * SKI_WSTAGE + (adjoint ? SKI_ROWS * SKI_MAX_R : 0));
}

// Shared memory of a K13c block: the ring's two slots and the G tiles (66,560 bytes).
static size_t ski_gram_smem() { return sizeof(float) * (2 * SKI_GRAM_STAGE + SKI_GRAM_G); }

static bool ski_aligned(const void* p) { return ((uintptr_t)p & 15) == 0; }

// The dynamic shared-memory opt-in, done once a device (a bit a device) for K13b (0), K13d (1) and K13c (2).
static unsigned int ski_kr_opted[3];

template <typename Kernel>
static cudaError_t ski_opt_in(Kernel kernel, size_t smem, int which) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (ski_kr_opted[which] >> (dev & 31) & 1u)) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) ski_kr_opted[which] |= 1u << (dev & 31);
  return err;
}

extern "C" int sgp_ski_kr_matmul(const float* R, const float* F, const float* W, int n, int r, int k, float* out,
                                 void* stream) {
  if (r > SKI_MAX_R || k > SKI_MAX_R || r < 0 || k < 0) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  const size_t smem = ski_kr_smem(false);
  const cudaError_t err = ski_opt_in(ski_kr_matmul_kernel, smem, 0);
  if (err != cudaSuccess) return (int)err;
  ski_kr_matmul_kernel<<<(n + SKI_ROWS - 1) / SKI_ROWS, SKI_KR_THREADS, smem, (cudaStream_t)stream>>>(
      R, F, W, n, r, k, k % 4 == 0 && ski_aligned(W), k % 4 == 0 && ski_aligned(out), out);
  return (int)cudaGetLastError();
}

// K13c: the first pass over a grid of ceil(r / 4) a-groups by `chunks` row chunks of chunk_rows rows
// (kernels/ski.py::_gram_split), into partial (chunks, k, r^2), or out itself when chunks == 1; then the
// chunks' partials added in chunk order.
extern "C" int sgp_ski_kr_gram(const float* Q, const float* R, const float* F, int n, int r, int k, int chunks,
                               int chunk_rows, float* partial, float* out, void* stream) {
  if (r > SKI_MAX_R || k > SKI_MAX_R || r < 0 || k < 0 || chunks < 1 || chunk_rows < 1)
    return (int)cudaErrorInvalidValue;
  if (r == 0 || k == 0) return (int)cudaGetLastError();
  const size_t smem = ski_gram_smem();
  const cudaError_t err = ski_opt_in(ski_kr_gram_kernel, smem, 2);
  if (err != cudaSuccess) return (int)err;
  float* first = chunks == 1 ? out : partial;
  ski_kr_gram_kernel<<<dim3((r + SKI_GRAM_A - 1) / SKI_GRAM_A, chunks), SKI_GRAM_THREADS, smem,
                       (cudaStream_t)stream>>>(Q, R, F, n, r, k, chunk_rows, k % 4 == 0 && ski_aligned(Q),
                                               r % 4 == 0 && ski_aligned(F), r % 4 == 0 && ski_aligned(R),
                                               r % 4 == 0 && ski_aligned(first), first);
  if (chunks > 1) {
    const long long size = (long long)k * r * r;
    ski_gram_reduce_kernel<<<sgp_blocks(size), SGP_THREADS, 0, (cudaStream_t)stream>>>(partial, size, chunks, out);
  }
  return (int)cudaGetLastError();
}

// Wt (r, k, r): Wt[a][c][b] = W[a r + b, c], W_a^T for each a (kernels/ski.py lays it out once a call).
extern "C" int sgp_ski_kr_adjoint(const float* R, const float* F, const float* Wt, const float* G, int n, int r,
                                  int k, float* dR, float* dF, void* stream) {
  if (r > SKI_MAX_R || k > SKI_MAX_R || r < 0 || k < 0) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  const size_t smem = ski_kr_smem(true);
  const cudaError_t err = ski_opt_in(ski_kr_adjoint_kernel, smem, 1);
  if (err != cudaSuccess) return (int)err;
  ski_kr_adjoint_kernel<<<(n + SKI_ROWS - 1) / SKI_ROWS, SKI_KR_THREADS, smem, (cudaStream_t)stream>>>(
      R, F, Wt, G, n, r, k, r % 4 == 0 && ski_aligned(F), r % 4 == 0 && ski_aligned(Wt),
      r % 4 == 0 && ski_aligned(dF), dR, dF);
  return (int)cudaGetLastError();
}

// Blocks resident an SM at their shared memory and registers: blocks[0] K13b, blocks[1] K13d, blocks[2] K13c
// (for the record).
extern "C" int sgp_ski_kr_resident(int* blocks) {
  cudaError_t err = ski_opt_in(ski_kr_matmul_kernel, ski_kr_smem(false), 0);
  if (err == cudaSuccess) err = ski_opt_in(ski_kr_adjoint_kernel, ski_kr_smem(true), 1);
  if (err == cudaSuccess) err = ski_opt_in(ski_kr_gram_kernel, ski_gram_smem(), 2);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks[0], ski_kr_matmul_kernel, SKI_KR_THREADS,
                                                        ski_kr_smem(false));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks[1], ski_kr_adjoint_kernel, SKI_KR_THREADS,
                                                        ski_kr_smem(true));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks[2], ski_kr_gram_kernel, SKI_GRAM_THREADS,
                                                        ski_gram_smem());
  return (int)err;
}
