// Work over the live rows of a lattice table, shared by the sort chain
// (K3', chain.cu), the wide apply K9 (apply.cu) and the derivative filter
// K7 (deriv.cu):
//   * the splat in row order (K3'b): row g of the table is the sum of its
//     contiguous run of contributions w * value(point, column), in one fixed
//     order, with no atomics, so it writes every live row and needs no
//     zeroed table;
//   * its work lists (sgp_run_lists_kernel): the mid rows and the pieces of
//     the long rows, from the run ends cnt;
//   * the blur of one lattice axis over the live rows of a join table, or of
//     each component of a mixture's stacked table (sgp_live_blur,
//     sgp_live_blur_rows), on a grid fixed by the card, not by the table;
//   * the d+1 axis blurs of a table in one launch of resident blocks with a
//     grid barrier between axes (sgp_blur_axes: K4 and K11b).
// The kernels here have internal linkage: each source instantiates its own,
// with its own column source.
#pragma once

#include "common.cuh"

// A run of more contributions than this is summed in pieces of this many.
#define CHAIN_PIECE 1024
// A run of at most this many contributions is summed by one thread per
// column (a warp's lanes folded in registers), a longer one by a warp.
#define CHAIN_SHORT 32
#define CHAIN_TILE 16   // columns a warp's pass carries in registers
// Contributions a lane loads ahead in a warp's pass: of one column, and of
// more in a plan of fewer than CHAIN_DEEP contributions, whose few warp
// items each wait on a chain of loads.  A larger plan keeps the card busy
// with items and loads none ahead (fewer registers, more warps resident):
// on an H100, DEPTH 2 against 1 at c = 11 took 0.031 / 0.055 ms at 0.2M
// contributions, 0.048 / 0.051 at 1.6M, 0.119 / 0.120 at 4.2M and 0.520 /
// 0.461 at 15.7M (kernel_times.py --count-splat; PERF.md section 6).
#define CHAIN_DEPTH1 8
#define CHAIN_DEPTH 2
#define CHAIN_DEEP (1 << 22)
// Most blocks of the splat's warp and short regions (8 of 256 threads per
// SM of an H100 is 1,056 blocks).
#define CHAIN_WARP_GRID 4224
#define CHAIN_SHORT_GRID 1056
// Largest number of components of a mixture's stacked table (mixture.cu).
#define SGP_MAX_MIX 16

// A table's contributions in row order and the splat's work lists: the
// fields of kernels/chain.py::ChainPlan and kernels/lattice.py::JoinRows.
//   sp, sw:      (N,) the point and weight of each contribution, in row order
//   cnt:         (Mc,) the end of each row's run
//   long_rows, long_first, n_long: the rows of runs > CHAIN_PIECE and their
//                first pieces; piece_row, piece_start, n_pieces: the pieces;
//   mid_rows, n_mid: the rows of runs of CHAIN_SHORT+1 .. CHAIN_PIECE;
//   nl_max, nm_max, np_max: the lengths of long_rows, mid_rows and piece_row
//                (bounds fixed by the shapes); n_lattice: the live count.
struct SgpRuns {
  const int* sp;
  const float* sw;
  const int* cnt;
  const int* long_rows;
  const int* long_first;
  const int* n_long;
  const int* piece_row;
  const int* piece_start;
  const int* n_pieces;
  const int* mid_rows;
  const int* n_mid;
  int nl_max, nm_max, np_max, N;
  const int* n_lattice;
};

static inline SgpRuns sgp_runs(const int* sp, const float* sw, const int* cnt, const int* long_rows,
                               const int* long_first, const int* n_long, const int* piece_row,
                               const int* piece_start, const int* n_pieces, const int* mid_rows, const int* n_mid,
                               int nl_max, int nm_max, int np_max, int N, const int* n_lattice) {
  return SgpRuns{sp, sw, cnt, long_rows, long_first, n_long, piece_row, piece_start, n_pieces, mid_rows, n_mid,
                 nl_max, nm_max, np_max, N, n_lattice};
}

// The splat's lists over N contributions and Mt rows in the one int buffer
// that the row build writes (join_rows.cu) and K4 reads (once.cu).  Their
// lengths are bounds fixed by the shapes (kernels/chain.py::_long_bounds):
// the runs are disjoint, a long one longer than CHAIN_PIECE, a mid one
// longer than CHAIN_SHORT.  The buffer holds long_rows (nl_max),
// long_first (nl_max + 1), piece_row and piece_start (np_max each),
// mid_rows (nm_max), then n_long, n_pieces and n_mid.
struct RowsLists {
  int nl_max, np_max, nm_max;
  int *long_rows, *long_first, *piece_row, *piece_start, *mid_rows, *n_long, *n_pieces, *n_mid;
};

// The layout of the lists in `lists`; with lists null, only the lengths.
static inline RowsLists rows_lists(int* lists, int N, int Mt) {
  RowsLists l = {};
  l.nl_max = Mt < N / (CHAIN_PIECE + 1) ? Mt : N / (CHAIN_PIECE + 1);
  l.np_max = N / CHAIN_PIECE + l.nl_max;
  l.nm_max = Mt < N / (CHAIN_SHORT + 1) ? Mt : N / (CHAIN_SHORT + 1);
  if (lists == nullptr) return l;
  l.long_rows = lists;
  l.long_first = l.long_rows + l.nl_max;
  l.piece_row = l.long_first + l.nl_max + 1;
  l.piece_start = l.piece_row + l.np_max;
  l.mid_rows = l.piece_start + l.np_max;
  l.n_long = l.mid_rows + l.nm_max;
  l.n_pieces = l.n_long + 1;
  l.n_mid = l.n_pieces + 1;
  return l;
}

// The ints of the lists buffer.
static inline size_t rows_lists_ints(int N, int Mt) {
  const RowsLists l = rows_lists(nullptr, N, Mt);
  return 2 * (size_t)l.nl_max + 1 + 2 * (size_t)l.np_max + l.nm_max + 3;
}

// The splat's column source: column col of point p's value is
// v[p, c0 + col] of a row-major v with row stride ld (a column window read
// in place).  A source names the columns a warp's pass carries (kTile).
struct SgpWindow {
  static constexpr int kTile = CHAIN_TILE;  // columns a warp's pass carries
  const float* v;
  int ld, c0;
  __device__ __forceinline__ float operator()(int p, int col) const { return v[(long long)p * ld + c0 + col]; }
};

// ---- the splat in row order -------------------------------------------------

__device__ __forceinline__ float chain_warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// A short run (len <= CHAIN_SHORT) of one column, by one thread, in the
// warp order: the warp put contribution i on lane i as 0 + w * v (never
// -0, so adding a lane of +0 is exact) and folded the lanes in halves by
// its butterfly (x_i + x_{i+16}, then + x_{i+8}, ...).  A fold step of half
// h only adds zeros when len <= h, so it is skipped.  Every index is a
// constant after unrolling, so x stays in registers.
template <class Src>
__device__ __forceinline__ float chain_short_sum(const int* __restrict__ sp, const float* __restrict__ sw,
                                                 const Src& src, int col, int start, int len) {
  float x[CHAIN_SHORT];
#pragma unroll
  for (int i = 0; i < CHAIN_SHORT; ++i)
    x[i] = i < len ? __fadd_rn(0.0f, __fmul_rn(__ldcs(sw + start + i), src(__ldcs(sp + start + i), col))) : 0.0f;
#pragma unroll
  for (int step = 4; step >= 0; --step) {
    const int h = 1 << step;
    if (len > h) {
#pragma unroll
      for (int i = 0; i < h; ++i) x[i] = __fadd_rn(x[i], x[i + h]);
    }
  }
  return x[0];
}

// acc[k] (all lanes) = the sum of w * value(point, c0 + k) over the run
// [start, end), k < cw <= TILE, lane l adding the contributions start + l,
// start + l + 32, ... in turn, then the butterfly.  DEPTH contributions a
// lane are loaded before any of them is added, so a run of CHAIN_PIECE
// waits on CHAIN_PIECE / (32 DEPTH) round trips to memory, not 32.  The
// plan's points and weights are read once, as a stream (__ldcs), so that
// they do not push the values out of L2.
template <int TILE, int DEPTH, class Src>
__device__ __forceinline__ void chain_warp_run(const int* __restrict__ sp, const float* __restrict__ sw,
                                               const Src& src, int c0, int cw, int start, int end, int lane,
                                               float (&acc)[TILE]) {
#pragma unroll
  for (int k = 0; k < TILE; ++k) acc[k] = 0.0f;
  int q = start + lane;
  for (; q + 32 * (DEPTH - 1) < end; q += 32 * DEPTH) {
    float w[DEPTH], x[DEPTH][TILE];
#pragma unroll
    for (int u = 0; u < DEPTH; ++u) {
      w[u] = __ldcs(sw + q + 32 * u);
      const int p = __ldcs(sp + q + 32 * u);
#pragma unroll
      for (int k = 0; k < TILE; ++k) x[u][k] = k < cw ? src(p, c0 + k) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < DEPTH; ++u)
#pragma unroll
      for (int k = 0; k < TILE; ++k)
        if (k < cw) acc[k] = __fadd_rn(acc[k], __fmul_rn(w[u], x[u][k]));
  }
  for (; q < end; q += 32) {
    const float w = __ldcs(sw + q);
    const int p = __ldcs(sp + q);
#pragma unroll
    for (int k = 0; k < TILE; ++k)
      if (k < cw) acc[k] = __fadd_rn(acc[k], __fmul_rn(w, src(p, c0 + k)));
  }
#pragma unroll
  for (int k = 0; k < TILE; ++k) acc[k] = chain_warp_sum(acc[k]);
}

// A warp per long row li: the sum of its pieces part[long_first[li] ..
// long_first[li + 1]) into its row of the table: lane l adds the pieces
// l, l + 32, ... in turn (DEPTH of them loaded ahead), then the butterfly.
template <int TILE, int DEPTH>
static __global__ void chain_combine_kernel(const int* __restrict__ long_rows, const int* __restrict__ long_first,
                                            const int* __restrict__ n_long, const float* __restrict__ part, int c,
                                            float* __restrict__ table) {
  const int li = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (li >= *n_long) return;
  const int lane = threadIdx.x & 31;
  const int first = long_first[li], last = long_first[li + 1];
  float* dst = table + (long long)long_rows[li] * c;
  for (int c0 = 0; c0 < c; c0 += TILE) {
    const int cw = c - c0 < TILE ? c - c0 : TILE;
    float acc[TILE];
#pragma unroll
    for (int k = 0; k < TILE; ++k) acc[k] = 0.0f;
    int i = first + lane;
    for (; i + 32 * (DEPTH - 1) < last; i += 32 * DEPTH) {
      float x[DEPTH][TILE];
#pragma unroll
      for (int u = 0; u < DEPTH; ++u)
#pragma unroll
        for (int k = 0; k < TILE; ++k) x[u][k] = k < cw ? part[(long long)(i + 32 * u) * c + c0 + k] : 0.0f;
#pragma unroll
      for (int u = 0; u < DEPTH; ++u)
#pragma unroll
        for (int k = 0; k < TILE; ++k)
          if (k < cw) acc[k] = __fadd_rn(acc[k], x[u][k]);
    }
    for (; i < last; i += 32) {
#pragma unroll
      for (int k = 0; k < TILE; ++k)
        if (k < cw) acc[k] = __fadd_rn(acc[k], part[(long long)i * c + c0 + k]);
    }
#pragma unroll
    for (int k = 0; k < TILE; ++k) {
      acc[k] = chain_warp_sum(acc[k]);
      if (k < cw && lane == k) dst[c0 + k] = acc[k];
    }
  }
}

// Blocks [0, n_warp_blocks): one warp per work item, striding over the mid
// rows (into the table) and then the pieces of the long rows (into part,
// (pieces, c)), one item per run and tile of TILE columns (27 a run at K7's
// 418 columns, so no warp walks a run's columns alone); they come first, so
// the runs that take longest start first.  The blocks after them: the short rows, one
// thread per (row, column), striding over the live rows (rows_per rows of c
// columns a block and step).  The live count and the item counts are read
// on the device, so the grid is fixed by the plan's shapes and blocks past
// the work return at once.  The table is (Mc, c).  At most 64 registers a
// thread (4 blocks an SM): K7's stacked-column source took 94 (2 blocks an
// SM) and spills 188 bytes a thread when bounded, yet its splat is faster
// so on an H100 (kernel_times.py --wide-deriv; PERF.md section 6).
// The window source fits in 64 without a spill.
template <int TILE, int DEPTH, class Src>
static __global__ void __launch_bounds__(SGP_THREADS, 4) chain_splat_kernel(const int* __restrict__ sp, const float* __restrict__ sw,
                                          const int* __restrict__ cnt, const int* __restrict__ mid_rows,
                                          const int* __restrict__ n_mid, const int* __restrict__ piece_row,
                                          const int* __restrict__ piece_start, const int* __restrict__ n_pieces,
                                          const int* __restrict__ n_lattice, const Src src, int c, int Mc,
                                          int n_warp_blocks, int rows_per, float* __restrict__ table,
                                          float* __restrict__ part) {
  if ((int)blockIdx.x >= n_warp_blocks) {
    const int n_short_blocks = gridDim.x - n_warp_blocks, b = blockIdx.x - n_warp_blocks;
    const int nl = *n_lattice;
    const int live = nl < Mc ? nl : Mc;
    const int items = rows_per * c;  // <= blockDim.x unless c > blockDim.x (then rows_per = 1)
    for (int g0 = b * rows_per; g0 < live; g0 += n_short_blocks * rows_per) {
      for (int t = threadIdx.x; t < items; t += blockDim.x) {
        const int dg = t / c;
        const int g = g0 + dg;
        if (g >= live) break;
        const int start = g == 0 ? 0 : cnt[g - 1];
        const int len = cnt[g] - start;
        if (len > CHAIN_SHORT) continue;  // a mid or long row: a warp's
        const int col = t - dg * c;
        table[(long long)g * c + col] = chain_short_sum(sp, sw, src, col, start, len);
      }
    }
    return;
  }
  const int lane = threadIdx.x & 31;
  const int warps = n_warp_blocks * (blockDim.x >> 5);
  const int tiles = (c + TILE - 1) / TILE;
  const int nm = *n_mid, total = (nm + *n_pieces) * tiles;
  float acc[TILE];
  // Work item i: tile i % tiles (TILE columns from c0) of run i / tiles; the tiles of one run go to
  // neighbouring warps, which share its points and weights in cache.
  for (int i = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5); i < total; i += warps) {
    const int run = i / tiles, c0 = (i - run * tiles) * TILE;
    const int cw = c - c0 < TILE ? c - c0 : TILE;
    if (run < nm) {  // a mid row into the table; the whole warp: i is the same on every lane
      const int g = mid_rows[run];
      const int start = g == 0 ? 0 : cnt[g - 1], end = cnt[g];
      float* dst = table + (long long)g * c + c0;
      chain_warp_run<TILE, DEPTH>(sp, sw, src, c0, cw, start, end, lane, acc);
#pragma unroll
      for (int k = 0; k < TILE; ++k)
        if (k < cw && lane == k) dst[k] = acc[k];
      continue;
    }
    const int pi = run - nm;  // a piece of a long row into part
    const int start = piece_start[pi], end = min(start + CHAIN_PIECE, cnt[piece_row[pi]]);
    float* dst = part + (long long)pi * c + c0;
    chain_warp_run<TILE, DEPTH>(sp, sw, src, c0, cw, start, end, lane, acc);
#pragma unroll
    for (int k = 0; k < TILE; ++k)
      if (k < cw && lane == 0) dst[k] = acc[k];
  }
}

// The first launch sums the short and mid rows and the pieces, the second
// the long rows from their pieces.
template <int TILE, int DEPTH, class Src>
static inline void chain_splat_launch(int n_warp, int n_short, int rows_per, const SgpRuns& r, const Src& src, int c, int Mc,
                               float* table, float* part, cudaStream_t st) {
  chain_splat_kernel<TILE, DEPTH, Src><<<n_warp + n_short, SGP_THREADS, 0, st>>>(
      r.sp, r.sw, r.cnt, r.mid_rows, r.n_mid, r.piece_row, r.piece_start, r.n_pieces, r.n_lattice, src, c, Mc, n_warp,
      rows_per, table, part);
  if (r.nl_max > 0)
    chain_combine_kernel<TILE, DEPTH><<<(r.nl_max + SGP_THREADS / 32 - 1) / (SGP_THREADS / 32), SGP_THREADS, 0, st>>>(
        r.long_rows, r.long_first, r.n_long, part, c, table);
}

// The splat of c columns of src into the live rows of table (Mc, c); part
// holds np_max * c floats.  Rows past the live count are not written.
template <class Src>
static inline cudaError_t sgp_splat_rows(const SgpRuns& r, const Src& src, int c, int Mc, float* table, float* part,
                                  cudaStream_t st) {
  if (Mc <= 0 || c <= 0) return cudaGetLastError();
  const int rows_per = c < SGP_THREADS ? SGP_THREADS / c : 1;
  const long long short_blocks = ((long long)Mc + rows_per - 1) / rows_per;
  constexpr int TILE = Src::kTile;
  const long long items = ((long long)r.nm_max + r.np_max) * ((c + TILE - 1) / TILE);
  const long long warp_blocks = (items + SGP_THREADS / 32 - 1) / (SGP_THREADS / 32);
  const int n_short = (int)(short_blocks < CHAIN_SHORT_GRID ? short_blocks : CHAIN_SHORT_GRID);
  const int n_warp = (int)(warp_blocks < CHAIN_WARP_GRID ? warp_blocks : CHAIN_WARP_GRID);
  if (c == 1)
    chain_splat_launch<1, CHAIN_DEPTH1>(n_warp, n_short, rows_per, r, src, c, Mc, table, part, st);
  else if (r.N < CHAIN_DEEP)
    chain_splat_launch<TILE, CHAIN_DEPTH>(n_warp, n_short, rows_per, r, src, c, Mc, table, part, st);
  else
    chain_splat_launch<TILE, 1>(n_warp, n_short, rows_per, r, src, c, Mc, table, part, st);
  return cudaGetLastError();
}

// ---- the work lists ---------------------------------------------------------

// long_info and its inclusive scan along the rows, (3, Mc) each: long row
// li = scan - 1 owns pieces [first, end) with end its scanned piece count;
// long_first (zeroed) receives each long row's end at li + 1; mid row mi =
// scan - 1 of the third row is mid_rows[mi].
static __global__ void sgp_run_lists_kernel(const int* __restrict__ long_info, const int* __restrict__ scan,
                                            const int* __restrict__ cnt, int Mc, int* __restrict__ long_rows,
                                            int* __restrict__ long_first, int* __restrict__ piece_row,
                                            int* __restrict__ piece_start, int* __restrict__ n_long,
                                            int* __restrict__ n_pieces, int* __restrict__ mid_rows,
                                            int* __restrict__ n_mid) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g == Mc - 1) {
    *n_long = scan[g];
    *n_pieces = scan[Mc + g];
    *n_mid = scan[2 * Mc + g];
  }
  if (g >= Mc) return;
  if (long_info[2 * Mc + g]) mid_rows[scan[2 * Mc + g] - 1] = g;
  if (!long_info[g]) return;
  const int li = scan[g] - 1, end = scan[Mc + g], pieces = long_info[Mc + g];
  const int start = g == 0 ? 0 : cnt[g - 1];
  long_rows[li] = g;
  long_first[li + 1] = end;
  for (int k = 0; k < pieces; ++k) {
    piece_row[end - pieces + k] = g;
    piece_start[end - pieces + k] = start + k * CHAIN_PIECE;
  }
}

// (3, Mc) long_info of a live row of len contributions: the long flag, its
// number of pieces, the mid flag.
__device__ __forceinline__ void sgp_run_class(int* __restrict__ long_info, int Mc, int g, int len) {
  long_info[g] = len > CHAIN_PIECE;
  long_info[Mc + g] = len > CHAIN_PIECE ? (len + CHAIN_PIECE - 1) / CHAIN_PIECE : 0;
  long_info[2 * Mc + g] = len > CHAIN_SHORT && len <= CHAIN_PIECE;
}

// ---- the blur over the live rows of a join table ----------------------------

__device__ __forceinline__ void sgp_load(const float* p, float (&x)[1]) { x[0] = p[0]; }
__device__ __forceinline__ void sgp_load(const float* p, float (&x)[2]) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  x[0] = t.x;
  x[1] = t.y;
}
__device__ __forceinline__ void sgp_load(const float* p, float (&x)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x;
  x[1] = t.y;
  x[2] = t.z;
  x[3] = t.w;
}
__device__ __forceinline__ void sgp_store(float* p, const float (&x)[1]) { p[0] = x[0]; }
__device__ __forceinline__ void sgp_store(float* p, const float (&x)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
}
__device__ __forceinline__ void sgp_store(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

// The live rows of a table: J components of M rows each, component j's
// live rows j M + [0, live[j]).  J = 1 is a join plan, whose one count may
// pass M (a tripped capacity guard: then no row is live); J > 1 a
// mixture's stacked table (mixture.cu), whose counts never do.  A row's
// neighbour ids are its component's own rows, M missing.
struct SgpLiveRows {
  const int* live;  // (J,), on the device
  int J, M;
};

// out = one axis blur of in, both (J M, c), over the live rows: a team of
// 2^team_log2 lanes per row, each lane VEC columns at a time (one 4-, 8- or
// 16-byte load of each of the 2r+1 rows; c % VEC == 0, so every row starts
// aligned).  The grid strides over the live rows of all components in turn
// (live index i of component j is row j M + i - first[j]), so a launch
// costs what the live rows cost, whatever M.  STACKED is J > 1: a table of
// one component (J = 1) keeps no component state, so its blur takes the
// registers, and the occupancy, of a single join table's.  The taps in
// blur_kernel's order (apply.cu: the centre, then the neighbours -r .. -1,
// 1 .. r, a missing one, M, skipped), each an explicit round-to-nearest
// multiply and add, so the blur is the plain version's bit for bit.
template <int VEC, bool STACKED>
static __global__ void sgp_live_blur_kernel(const float* __restrict__ in, float* __restrict__ out,
                                            const int* __restrict__ nb, const SgpTaps taps, const SgpLiveRows rows,
                                            int c, int order, int team_log2) {
  __shared__ int first[SGP_MAX_MIX + 1];  // component j's live indices are [first[j], first[j + 1])
  const int M = rows.M;
  int total;
  if (STACKED) {
    if (threadIdx.x == 0) {
      first[0] = 0;
      for (int j = 0; j < rows.J; ++j) first[j + 1] = first[j] + rows.live[j];
    }
    __syncthreads();
    total = first[rows.J];
  } else {
    const int live = *rows.live;
    total = live > M ? 0 : live;  // past the capacity no row is live
  }
  const int groups = c / VEC, r2 = 2 * order, team = 1 << team_log2;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long lead = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // Column chunks of team * VEC columns, each over every live row before the next, so the rows that a
  // chunk's neighbours read (live rows x 256 bytes at K7's 418 columns) can stay in L2.
  for (int gi = (int)(lead & (team - 1)); gi - (int)(lead & (team - 1)) < groups; gi += team) {
    if (gi >= groups) continue;  // this lane's part of the last chunk is past the columns
    const long long col = (long long)gi * VEC;
    // The component of live index i, its live indices [lo, hi) and its first row base: i only grows in
    // this loop, so they change only where it crosses into the next component.
    int j = 0;
    long long lo = 0, hi = STACKED ? first[1] : total, base = 0;
    for (long long t = lead; (t >> team_log2) < total; t += stride) {
      const long long i = t >> team_log2;
      if (STACKED) {
        while (i >= hi) {
          ++j;
          lo = hi;
          hi = first[j + 1];
          base += M;
        }
      }
      const long long row = base + (i - lo);
      float x[VEC], acc[VEC];
      sgp_load(in + row * c + col, x);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = __fmul_rn(taps.v[order], x[e]);
      for (int k = 0; k < r2; ++k) {
        const int q = nb[row * r2 + k];
        if (q == M) continue;
        sgp_load(in + (base + q) * c + col, x);
        const float tap = taps.v[k < order ? k : k + 1];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(tap, x[e]));
      }
      sgp_store(out + row * c + col, acc);
    }
  }
}

template <int VEC, bool STACKED>
static inline void sgp_live_blur_launch(const float* in, float* out, const int* nb, const SgpTaps& taps,
                                        const SgpLiveRows& rows, int c, int order, int team_log2, cudaStream_t st) {
  // The grid is the blocks the card holds at once (common.cuh), so no block waits for a second wave.
  const int grid = sgp_coresident_blocks(sgp_live_blur_kernel<VEC, STACKED>, SGP_THREADS, 0);
  sgp_live_blur_kernel<VEC, STACKED><<<grid, SGP_THREADS, 0, st>>>(in, out, nb, taps, rows, c, order, team_log2);
}

// One axis of the blur over the live rows of a table (rows.J rows.M, c);
// nb is that axis's (rows.J rows.M, 2r) neighbour ids.  A team of lanes
// per row spans its columns (up to a warp: 418 columns of K7 take a warp a
// row, a window of 8 of K9 two lanes).
static inline cudaError_t sgp_live_blur_rows(const float* in, float* out, const int* nb, const SgpTaps& taps,
                                             const SgpLiveRows& rows, int c, int order, cudaStream_t st) {
  if (rows.M <= 0 || c <= 0) return cudaGetLastError();
  if (rows.J < 1 || rows.J > SGP_MAX_MIX) return cudaErrorInvalidValue;
  const int vec = c % 4 == 0 ? 4 : (c % 2 == 0 ? 2 : 1);
  int team_log2 = 0;
  while ((1 << team_log2) < c / vec && team_log2 < 5) ++team_log2;
  const bool stacked = rows.J > 1;
  if (vec == 4)
    (stacked ? sgp_live_blur_launch<4, true> : sgp_live_blur_launch<4, false>)(in, out, nb, taps, rows, c, order,
                                                                              team_log2, st);
  else if (vec == 2)
    (stacked ? sgp_live_blur_launch<2, true> : sgp_live_blur_launch<2, false>)(in, out, nb, taps, rows, c, order,
                                                                              team_log2, st);
  else
    (stacked ? sgp_live_blur_launch<1, true> : sgp_live_blur_launch<1, false>)(in, out, nb, taps, rows, c, order,
                                                                              team_log2, st);
  return cudaGetLastError();
}

// One axis of the blur over the live rows [0, *count) of a join table (M, c).
static inline cudaError_t sgp_live_blur(const float* in, float* out, const int* nb, const SgpTaps& taps, int M, int c,
                                        int order, const int* count, cudaStream_t st) {
  return sgp_live_blur_rows(in, out, nb, taps, SgpLiveRows{count, 1, M}, c, order, st);
}

// ---- the d+1 axes in one launch ---------------------------------------------

#define SGP_AXES_THREADS 512

__device__ __forceinline__ void sgp_load_cg(const float* p, float (&x)[1]) { x[0] = __ldcg(p); }
__device__ __forceinline__ void sgp_load_cg(const float* p, float (&x)[2]) {
  const float2 t = __ldcg(reinterpret_cast<const float2*>(p));
  x[0] = t.x;
  x[1] = t.y;
}
__device__ __forceinline__ void sgp_load_cg(const float* p, float (&x)[4]) {
  const float4 t = __ldcg(reinterpret_cast<const float4*>(p));
  x[0] = t.x;
  x[1] = t.y;
  x[2] = t.z;
  x[3] = t.w;
}

// One axis of sgp_blur_axes_kernel: out = the blur of in over its nl rows,
// this thread's rows and columns.  in and out are distinct tables, so the
// loads of one row need not wait for the stores of the last; in was written
// earlier in the launch, so it is read through L2 (__ldcg).
template <int VEC>
__device__ __forceinline__ void sgp_blur_axis_rows(const float* __restrict__ in, float* __restrict__ out,
                                                   const int* __restrict__ nbj, const SgpTaps& taps, int M, int nl,
                                                   int c, int order, int team_log2, long long lead, long long stride) {
  const int groups = c / VEC, r2 = 2 * order, team = 1 << team_log2;
  const int lane = (int)(lead & (team - 1));
  for (long long t = lead; (t >> team_log2) < nl; t += stride) {
    const long long row = t >> team_log2;
    for (int gi = lane; gi < groups; gi += team) {
      const long long col = (long long)gi * VEC;
      float x[VEC], acc[VEC];
      sgp_load_cg(in + row * c + col, x);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = __fmul_rn(taps.v[order], x[e]);
      for (int k = 0; k < r2; ++k) {
        const int q = __ldg(nbj + row * r2 + k);
        if (q == M) continue;
        sgp_load_cg(in + (long long)q * c + col, x);
        const float tap = taps.v[k < order ? k : k + 1];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(tap, x[e]));
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) __stcg(out + row * c + col + e, acc[e]);
    }
  }
}

// The same axis one thread per (row, column) element, element idx of the
// row-major table (a width not a multiple of 2: no lane of a warp idles,
// and the threads of a row read its neighbours' columns side by side).
// I: int while the table has fewer than 2^30 elements.
template <typename I>
__device__ __forceinline__ void sgp_blur_axis_elems(const float* __restrict__ in, float* __restrict__ out,
                                                    const int* __restrict__ nbj, const SgpTaps& taps, int M, int nl,
                                                    int c, int order, I lead, I stride) {
  const int r2 = 2 * order;
  const I work = (I)nl * c;
  for (I idx = lead; idx < work; idx += stride) {
    const I row = idx / c;
    const I col = idx - row * c;
    float acc = __fmul_rn(taps.v[order], __ldcg(in + idx));
    for (int k = 0; k < r2; ++k) {
      const int q = __ldg(nbj + row * r2 + k);
      if (q == M) continue;
      acc = __fadd_rn(acc, __fmul_rn(taps.v[k < order ? k : k + 1], __ldcg(in + (I)q * c + col)));
    }
    __stcg(out + idx, acc);
  }
}

// The d+1 axis blurs of ta (nl, c), all its rows live, in one launch: a
// grid of resident blocks strides over the rows with sgp_live_blur_kernel's
// layout (a team of 2^team_log2 lanes a row, VEC columns a lane at a time;
// VEC = 1: a thread an element, sgp_blur_axis_elems),
// axis 0 (axis d with transpose) from ta into tb, the next back, and so on,
// with a grid barrier between axes (*barrier is 0 at the launch).  Axis j
// reads its neighbour ids at nb + j M 2r, M meaning missing.  Each output
// is sgp_live_blur_kernel's, operation for operation (the plain version's
// bits).  The final table is ta when dp1 is even, else tb.
template <int VEC>
static __global__ void __launch_bounds__(SGP_AXES_THREADS, 4)
    sgp_blur_axes_kernel(float* ta, float* tb, const int* __restrict__ nb, const SgpTaps taps, int M, int nl, int c,
                         int dp1, int order, int transpose, int team_log2, unsigned int* barrier) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long lead = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool narrow = (long long)nl * c < (1LL << 30);
  for (int jj = 0; jj < dp1; ++jj) {
    const int* nbj = nb + (long long)(transpose ? dp1 - 1 - jj : jj) * M * 2 * order;
    float* in = jj % 2 == 0 ? ta : tb;
    float* out = jj % 2 == 0 ? tb : ta;
    if (VEC > 1)
      sgp_blur_axis_rows<VEC>(in, out, nbj, taps, M, nl, c, order, team_log2, lead, stride);
    else if (narrow)
      sgp_blur_axis_elems<int>(in, out, nbj, taps, M, nl, c, order, (int)lead, (int)stride);
    else
      sgp_blur_axis_elems<long long>(in, out, nbj, taps, M, nl, c, order, lead, stride);
    if (jj + 1 < dp1) sgp_grid_barrier(barrier, (unsigned int)(jj + 1) * gridDim.x);
  }
}

template <int VEC>
static inline cudaError_t sgp_blur_axes_as(float* ta, float* tb, const int* nb, const SgpTaps& taps, int M, int nl,
                                           int c, int dp1, int order, int transpose, unsigned int* barrier,
                                           cudaStream_t st) {
  int team_log2 = 0;  // VEC = 1: a thread an element, c of them a row
  while (VEC > 1 && (1 << team_log2) < c / VEC && team_log2 < 5) ++team_log2;
  const long long lanes = VEC > 1 ? (long long)nl << team_log2 : (long long)nl * c;
  const long long need = (lanes + SGP_AXES_THREADS - 1) / SGP_AXES_THREADS;
  const int resident = sgp_coresident_blocks(sgp_blur_axes_kernel<VEC>, SGP_AXES_THREADS, 0);
  const int grid = (int)(need < resident ? need : resident);
  sgp_blur_axes_kernel<VEC>
      <<<grid, SGP_AXES_THREADS, 0, st>>>(ta, tb, nb, taps, M, nl, c, dp1, order, transpose, team_log2, barrier);
  return cudaGetLastError();
}

// The dp1 axis blurs of ta (nl, c) in one launch (sgp_blur_axes_kernel);
// tb is scratch of the same size, barrier one uint of scratch; the result
// is in ta when dp1 is even, else in tb.
static inline cudaError_t sgp_blur_axes(float* ta, float* tb, const int* nb, const SgpTaps& taps, int M, int nl, int c,
                                        int dp1, int order, int transpose, unsigned int* barrier, cudaStream_t st) {
  if (nl <= 0 || c <= 0) return cudaGetLastError();
  cudaError_t err = cudaMemsetAsync(barrier, 0, sizeof(unsigned int), st);
  if (err != cudaSuccess) return err;
  const int vec = c % 4 == 0 ? 4 : (c % 2 == 0 ? 2 : 1);
  return vec == 4   ? sgp_blur_axes_as<4>(ta, tb, nb, taps, M, nl, c, dp1, order, transpose, barrier, st)
         : vec == 2 ? sgp_blur_axes_as<2>(ta, tb, nb, taps, M, nl, c, dp1, order, transpose, barrier, st)
                    : sgp_blur_axes_as<1>(ta, tb, nb, taps, M, nl, c, dp1, order, transpose, barrier, st);
}
