// K3' the sort-chain plan: build (K3'a chain_build) and apply (K3'b
// chain_splat, K3'c chain_axis, K3'd chain_slice).
//
// Replaces simplex_gp_tpu/ops/lattice.py::build_plan_chain (:857, its core
// _chain_core :693) and apply_plan_chain (:943, single-device branches).
// The operator is K2/K3's, S^T B_d ... B_0 S: every lattice axis j splits
// the lattice into 1-D chains {key + t o_j}; sorted by (chain word, packed
// coordinate sum), a chain's points are adjacent rows in chain order, and
// the axis blur is a (2r+1)-tap stencil over neighbouring rows.
//
// Chain words (_chain_words, :648-663): c1 = mult_j h1 - s oh1_j and
// c2 = mult_j h2 - s oh2_j, wrapping mod 2^32 (uint32 here: signed overflow
// is undefined in C++), and the packed word (_pack, :638) keeps the top 11
// bits of c2 over the coordinate sum s + 2^20 clipped into the low 21 bits.
// A sort key is the int64 whose high word is c1 and whose low word is the
// packed word with its sign bit flipped, so int64 order is the signed
// lexicographic order of (c1, packed) that lax.sort gives.  Two rows share
// a chain when their keys agree above bit 21; the low 21 bits are the
// biased coordinate sum.
//
// Build, once per loss evaluation.  The wrapper (kernels/chain.py) runs the
// sorts and prefix sums as torch.sort(stable=True) / torch.cumsum, which
// stand for JAX's lax.sort / jnp.cumsum; everything else is here.
//   [sort]   the contributions stable by h2;
//   keys:    the axis-0 key of every contribution (vertex of a point), in
//            that order;
//   [sort]   stable by the key: lexicographic on (c1, packed, h2), so
//            equal lattice points are contiguous (JAX splits groups on the
//            same triple after an unstable sort, :720-731), and the
//            contributions of one point keep their vertex order.
//   groups:  the composed order, and a flag where a new lattice point
//            starts; [cumsum] numbers them.
//   compact: the first sorted position of each of the first Mc points, and
//            for every sorted position its point id and weight (the splat
//            reads both in table order) and for every contribution its row.
//   rows:    per table row (the table is in axis-0 order): cnt, JAX's
//            cumulative contribution end (:752-756); the row's h1, h2 and s
//            (:758-764); its key along every axis 0..d, INT64_MAX for a row
//            past the live count, so dead rows sort last in every axis order
//            (JAX's pad rows sort among the live ones; with no tap to them,
//            their place does not change the operator); for a row whose
//            run is longer than CHAIN_PIECE, a flag and its number of
//            pieces of CHAIN_PIECE contributions.
//   [sort]   the d axis-j keys, j = 1..d, in one batched stable sort.
//   taps:    tapw[j, k-1, p], the tap linking sorted rows p and p+k of axis
//            j (_axis_tap_weights, :666-690): taps[r + t] when both are live,
//            share a chain and their biased sums differ by t step (step 1
//            for j < d, d for axis d), for some t in [k, r]; else 0.
//   finish:  the inverse of each axis order; the gather of each transition,
//            position q of axis j+1 reads position g_j[q] of axis j (JAX
//            sorts the table by the same fixed keys in every apply, :1023-
//            1027); slice_idx, each contribution's final position (:894);
//            from the [cumsum] of the long rows' flags and piece counts and
//            the mid rows' flags, the list of long rows with their first
//            pieces, each piece's row and first contribution, and the list
//            of mid rows (runs of CHAIN_SHORT+1 .. CHAIN_PIECE).
// No atomics and no host read: two builds give the same bits.
//
// Apply, d + 4 launches from one host call (sgp_chain_apply; d + 3 where
// the plan has too few contributions for a long row), no atomics, no host
// read.  The live count stays on the device: threads of rows at or past
// min(n_lattice, Mc) return at once, so every grid spans Mc rows, and the
// slice writes NaN when n_lattice > Mc (JAX's guard, :1093-1100).  Tables
// are (Mc, c) row-major.
//   splat (K3'b): row g is the sum of its contiguous run of sorted
//     contributions, w * v[point], in one fixed order, the warp order: each
//     of 32 lanes sums every 32nd contribution, then a butterfly of
//     shuffles.  Runs are very uneven (elevators: ~2 contributions a row,
//     one row ~10k; houseelectric: ~790 a row, one row 1.17M of 15.7M), so
//     the work is split by run length, each class in the warp order:
//       short (<= CHAIN_SHORT): one thread per (row, column) holds the
//         run's lane values in registers and folds them in halves, which is
//         the butterfly's order (lanes past the run hold +0 and a fold step
//         over them adds nothing, so it is skipped): no idle lanes, all c
//         columns in one pass, coalesced writes;
//       mid (up to CHAIN_PIECE, listed by the build): one warp per row, all
//         columns in one pass of up to CHAIN_TILE columns in registers, so
//         each contribution's point and weight are read once;
//       long: fixed pieces of CHAIN_PIECE, a warp each into a partial
//         table; then, in a second launch, one warp per long row sums its
//         pieces the same way.
//     No warp sums more than CHAIN_PIECE values.  The short and warp parts
//     share one launch and stride over the live rows and the listed items
//     with a grid fixed by the plan's shapes.  (JAX's cumsum-and-
//     difference, :1008-1009, is TPU mechanics and loses f32 precision over
//     long prefixes.)
//   axis (K3'c): the stencil of axis j at position p (_chain_stencil_1d,
//     :915-922, in its order of operations), written at the position q of
//     axis j+1 with g_j[q] = p; the last axis writes in its own (final)
//     order.  One thread per (position, column).
//   slice (K3'd): the d+1 vertices of a point gathered at slice_idx,
//     weighted, summed in vertex order and scaled by SLICE_NORM.
//
// Bound: memory traffic.  At elevators (n = 10,623, d = 18, c = 11, Mc =
// 201,837) the splat reads 8 bytes of plan and 4c of v per contribution and
// writes the live table, each axis reads and writes a table and reads its
// taps and gather, and the slice reads d+1 rows per point: ~0.4 GB an apply,
// about 0.12 ms at 3.35 TB/s.  The splat's time goes to its gathers of v's
// rows (15.7M random rows at houseelectric, where a CSR product of the same
// matrix takes as long at c = 1: PERF.md section 6); the axis kernels'
// 64-bit divisions by c and the gathers are the suspects if those are slow.
#include "common.cuh"

#include <limits.h>

#define CHAIN_S_MASK 0x1FFFFFu   // _S_MASK, the low 21 bits
#define CHAIN_S_BIAS (1 << 20)   // _S_BIAS
#define CHAIN_TOP_MASK 0xFFE00000u  // _TOP_MASK
#define CHAIN_DEAD LLONG_MAX     // the key of a row past the live count
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

__device__ __forceinline__ long long chain_key(unsigned int c1, unsigned int c2, int s) {
  int sb = s + CHAIN_S_BIAS;
  sb = sb < 0 ? 0 : (sb > (int)CHAIN_S_MASK ? (int)CHAIN_S_MASK : sb);
  const unsigned int packed = (c2 & CHAIN_TOP_MASK) | (unsigned int)sb;
  return (long long)(((unsigned long long)c1 << 32) | (packed ^ 0x80000000u));
}

// ---- build ------------------------------------------------------------------

// Axis 0: the multiplier of every axis j < d is 1 (_axis_dir), so
// c1 = h1 - s oh1_0, c2 = h2 - s oh2_0.
// key[q]: the key of contribution order[q].
__global__ void chain_keys_kernel(const int* __restrict__ h1, const int* __restrict__ h2,
                                  const int* __restrict__ s, const long long* __restrict__ order, int N,
                                  const int* __restrict__ consts, int dp1, long long* __restrict__ key) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= N) return;
  const long long e = order[q];
  const unsigned int se = (unsigned int)s[e];
  const unsigned int oh1 = (unsigned int)consts[0], oh2 = (unsigned int)consts[dp1];
  key[q] = chain_key((unsigned int)h1[e] - se * oh1, (unsigned int)h2[e] - se * oh2, s[e]);
}

// perm = p1[p2], the contributions in key order; flag where a group starts.
__global__ void chain_groups_kernel(const long long* __restrict__ p1, const long long* __restrict__ p2,
                                    const long long* __restrict__ key, const int* __restrict__ h2, int N,
                                    long long* __restrict__ perm, int* __restrict__ flag) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= N) return;
  const long long e = p1[p2[q]];
  perm[q] = e;
  flag[q] = q == 0 || key[q] != key[q - 1] || h2[e] != h2[p1[p2[q - 1]]];
}

__global__ void chain_compact_kernel(const long long* __restrict__ perm, const float* __restrict__ w,
                                     const int* __restrict__ seg, const int* __restrict__ flag, int N,
                                     int Mc, int dp1, int* __restrict__ u_pos, int* __restrict__ sp,
                                     float* __restrict__ sw, int* __restrict__ row_of,
                                     int* __restrict__ n_lattice) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= N) return;
  if (q == N - 1) *n_lattice = seg[q];
  const int g = seg[q] - 1;
  const long long e = perm[q];
  if (flag[q] && g < Mc) u_pos[g] = q;
  sp[q] = (int)(e / dp1);
  sw[q] = w[e];
  row_of[e] = g < Mc ? g : Mc - 1;  // past the capacity the slice writes NaN
}

// consts: (3, d+1) int32, the rows oh1, oh2 and mult of every axis.
__global__ void chain_rows_kernel(const int* __restrict__ u_pos, const long long* __restrict__ key,
                                  const int* __restrict__ h2, const long long* __restrict__ perm,
                                  const int* __restrict__ n_lattice, int N, int Mc, int d,
                                  const int* __restrict__ consts, int* __restrict__ cnt,
                                  long long* __restrict__ keys, int* __restrict__ long_info) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= Mc) return;
  const int dp1 = d + 1;
  const int nl = *n_lattice;
  const int live = nl < Mc ? nl : Mc;
  cnt[g] = g + 1 < live ? u_pos[g + 1] : N;
  if (g >= live) {
    for (int j = 0; j < dp1; ++j) keys[(long long)j * Mc + g] = CHAIN_DEAD;
    long_info[g] = long_info[Mc + g] = long_info[2 * Mc + g] = 0;
    return;
  }
  const int q = u_pos[g];
  const int len = (g + 1 < live ? u_pos[g + 1] : N) - q;
  // (3, Mc): the long flag, the number of pieces, the mid flag
  long_info[g] = len > CHAIN_PIECE;
  long_info[Mc + g] = len > CHAIN_PIECE ? (len + CHAIN_PIECE - 1) / CHAIN_PIECE : 0;
  long_info[2 * Mc + g] = len > CHAIN_SHORT && len <= CHAIN_PIECE;
  const long long k0 = key[q];
  const unsigned int c1 = (unsigned int)(k0 >> 32);
  const int us = (int)(((unsigned int)k0) & CHAIN_S_MASK) - CHAIN_S_BIAS;
  const unsigned int uh1 = c1 + (unsigned int)us * (unsigned int)consts[0];
  const unsigned int uh2 = (unsigned int)h2[perm[q]];
  for (int j = 0; j < dp1; ++j) {
    const unsigned int m = (unsigned int)consts[2 * dp1 + j];
    keys[(long long)j * Mc + g] = chain_key(m * uh1 - (unsigned int)us * (unsigned int)consts[j],
                                            m * uh2 - (unsigned int)us * (unsigned int)consts[dp1 + j], us);
  }
}

// One thread per (axis j, position p): key0 is axis 0's keys (the table's
// own order), sorted the d sorted key rows of axes 1..d.
__global__ void chain_taps_kernel(const long long* __restrict__ key0, const long long* __restrict__ sorted,
                                  const int* __restrict__ n_lattice, int Mc, int d, int order, SgpTaps taps,
                                  float* __restrict__ tapw) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)(d + 1) * Mc) return;
  const int j = (int)(idx / Mc);
  const int p = (int)(idx - (long long)j * Mc);
  const int nl = *n_lattice;
  const int live = nl < Mc ? nl : Mc;
  const long long* k = j == 0 ? key0 : sorted + (long long)(j - 1) * Mc;
  const int step = j < d ? 1 : d;
  for (int kk = 1; kk <= order; ++kk) {
    float w = 0.0f;
    if (p + kk < live) {
      const long long a = k[p], b = k[p + kk];
      if ((a >> 21) == (b >> 21)) {
        const int ds = (int)(b & CHAIN_S_MASK) - (int)(a & CHAIN_S_MASK);
        for (int t = kk; t <= order; ++t)
          if (ds == t * step) w = taps.v[order + t];
      }
    }
    tapw[((long long)j * order + kk - 1) * Mc + p] = w;
  }
}

__global__ void chain_invert_kernel(const long long* __restrict__ perm, long long total, int Mc,
                                    int* __restrict__ pos) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long j = idx / Mc;
  pos[j * Mc + perm[idx]] = (int)(idx - j * Mc);
}

// gather[0] = perm of axis 1; gather[j] = pos_j[perm_{j+1}] for j = 1..d-1.
__global__ void chain_gather_kernel(const long long* __restrict__ perm, const int* __restrict__ pos,
                                    long long total, int Mc, int* __restrict__ gather) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long j = idx / Mc;
  const long long row = perm[idx];
  gather[idx] = j == 0 ? (int)row : pos[(j - 1) * Mc + row];
}

__global__ void chain_slice_idx_kernel(const int* __restrict__ row_of, const int* __restrict__ pos_d,
                                       int N, int* __restrict__ slice_idx) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < N) slice_idx[e] = pos_d[row_of[e]];
}

// long_info and its inclusive scan along the rows, (3, Mc) each: long row
// li = scan - 1 owns pieces [first, end) with end its scanned piece count;
// long_first (zeroed) receives each long row's end at li + 1; mid row mi =
// scan - 1 of the third row is mid_rows[mi].
__global__ void chain_long_kernel(const int* __restrict__ long_info, const int* __restrict__ scan,
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

// consts: (3, d+1) int32, the rows oh1, oh2 and mult of every axis.
extern "C" int sgp_chain_keys(const int* h1, const int* h2, const int* s, const long long* order, int N,
                              const int* consts, int dp1, long long* key, void* stream) {
  if (N > 0)
    chain_keys_kernel<<<sgp_blocks(N), SGP_THREADS, 0, (cudaStream_t)stream>>>(h1, h2, s, order, N, consts,
                                                                              dp1, key);
  return (int)cudaGetLastError();
}

extern "C" int sgp_chain_groups(const long long* p1, const long long* p2, const long long* key, const int* h2,
                                int N, long long* perm, int* flag, void* stream) {
  if (N > 0)
    chain_groups_kernel<<<sgp_blocks(N), SGP_THREADS, 0, (cudaStream_t)stream>>>(p1, p2, key, h2, N, perm,
                                                                                flag);
  return (int)cudaGetLastError();
}

extern "C" int sgp_chain_compact(const long long* perm, const float* w, const int* seg, const int* flag,
                                 int N, int Mc, int dp1, int* u_pos, int* sp, float* sw, int* row_of,
                                 int* n_lattice, void* stream) {
  if (N > 0)
    chain_compact_kernel<<<sgp_blocks(N), SGP_THREADS, 0, (cudaStream_t)stream>>>(
        perm, w, seg, flag, N, Mc, dp1, u_pos, sp, sw, row_of, n_lattice);
  return (int)cudaGetLastError();
}

extern "C" int sgp_chain_rows(const int* u_pos, const long long* key, const int* h2, const long long* perm,
                              const int* n_lattice, int N, int Mc, int d, const int* consts, int* cnt,
                              long long* keys, int* long_info, void* stream) {
  if (Mc > 0)
    chain_rows_kernel<<<sgp_blocks(Mc), SGP_THREADS, 0, (cudaStream_t)stream>>>(
        u_pos, key, h2, perm, n_lattice, N, Mc, d, consts, cnt, keys, long_info);
  return (int)cudaGetLastError();
}

static SgpTaps chain_taps_of(const float* taps_host, int order) {
  SgpTaps taps = {};
  for (int t = 0; t < 2 * order + 1; ++t) taps.v[t] = taps_host[t];
  return taps;
}

extern "C" int sgp_chain_taps(const long long* key0, const long long* sorted, const int* n_lattice, int Mc,
                              int d, int order, const float* taps_host, float* tapw, void* stream) {
  if (2 * order + 1 > SGP_MAX_TAPS) return (int)cudaErrorInvalidValue;
  const long long work = (long long)(d + 1) * Mc;
  if (work > 0 && order > 0)
    chain_taps_kernel<<<sgp_blocks(work), SGP_THREADS, 0, (cudaStream_t)stream>>>(
        key0, sorted, n_lattice, Mc, d, order, chain_taps_of(taps_host, order), tapw);
  return (int)cudaGetLastError();
}

// perm: (d, Mc) int64, the sorted order of axes 1..d; pos: (d, Mc) scratch.
extern "C" int sgp_chain_finish(const long long* perm, const int* row_of, const int* long_info,
                                const int* long_scan, const int* cnt, int N, int Mc, int d, int* pos,
                                int* gather, int* slice_idx, int* long_rows, int* long_first, int* piece_row,
                                int* piece_start, int* n_long, int* n_pieces, int* mid_rows, int* n_mid,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long total = (long long)d * Mc;
  if (total > 0) {
    chain_invert_kernel<<<sgp_blocks(total), SGP_THREADS, 0, st>>>(perm, total, Mc, pos);
    chain_gather_kernel<<<sgp_blocks(total), SGP_THREADS, 0, st>>>(perm, pos, total, Mc, gather);
  }
  if (N > 0)
    chain_slice_idx_kernel<<<sgp_blocks(N), SGP_THREADS, 0, st>>>(row_of, pos + (long long)(d - 1) * Mc, N,
                                                                  slice_idx);
  if (Mc > 0)
    chain_long_kernel<<<sgp_blocks(Mc), SGP_THREADS, 0, st>>>(long_info, long_scan, cnt, Mc, long_rows,
                                                              long_first, piece_row, piece_start, n_long,
                                                              n_pieces, mid_rows, n_mid);
  return (int)cudaGetLastError();
}

// ---- apply ------------------------------------------------------------------

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
__device__ __forceinline__ float chain_short_sum(const int* __restrict__ sp, const float* __restrict__ sw,
                                                 const float* __restrict__ v, int c, int col, int start,
                                                 int len) {
  float x[CHAIN_SHORT];
#pragma unroll
  for (int i = 0; i < CHAIN_SHORT; ++i)
    x[i] = i < len ? __fadd_rn(0.0f, __fmul_rn(__ldcs(sw + start + i), v[(long long)__ldcs(sp + start + i) * c + col]))
                   : 0.0f;
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

// acc[k] (all lanes) = the sum of w * v[point, c0 + k] over the run
// [start, end), k < cw <= TILE, lane l adding the contributions start + l,
// start + l + 32, ... in turn, then the butterfly.  DEPTH contributions a
// lane are loaded before any of them is added, so a run of CHAIN_PIECE
// waits on CHAIN_PIECE / (32 DEPTH) round trips to memory, not 32.  The
// plan's points and weights are read once, as a stream (__ldcs), so that
// they do not push the rows of v out of L2.
template <int TILE, int DEPTH>
__device__ __forceinline__ void chain_warp_run(const int* __restrict__ sp, const float* __restrict__ sw,
                                               const float* __restrict__ v, int c, int c0, int cw, int start,
                                               int end, int lane, float (&acc)[TILE]) {
#pragma unroll
  for (int k = 0; k < TILE; ++k) acc[k] = 0.0f;
  int q = start + lane;
  for (; q + 32 * (DEPTH - 1) < end; q += 32 * DEPTH) {
    float w[DEPTH], x[DEPTH][TILE];
#pragma unroll
    for (int u = 0; u < DEPTH; ++u) {
      w[u] = __ldcs(sw + q + 32 * u);
      const float* vp = v + (long long)__ldcs(sp + q + 32 * u) * c + c0;
#pragma unroll
      for (int k = 0; k < TILE; ++k) x[u][k] = k < cw ? vp[k] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < DEPTH; ++u)
#pragma unroll
      for (int k = 0; k < TILE; ++k)
        if (k < cw) acc[k] = __fadd_rn(acc[k], __fmul_rn(w[u], x[u][k]));
  }
  for (; q < end; q += 32) {
    const float w = __ldcs(sw + q);
    const float* vp = v + (long long)__ldcs(sp + q) * c + c0;
#pragma unroll
    for (int k = 0; k < TILE; ++k)
      if (k < cw) acc[k] = __fadd_rn(acc[k], __fmul_rn(w, vp[k]));
  }
#pragma unroll
  for (int k = 0; k < TILE; ++k) acc[k] = chain_warp_sum(acc[k]);
}

// A warp per long row li: the sum of its pieces part[long_first[li] ..
// long_first[li + 1]) into its row of the table: lane l adds the pieces
// l, l + 32, ... in turn (DEPTH of them loaded ahead), then the butterfly.
template <int TILE, int DEPTH>
__global__ void chain_combine_kernel(const int* __restrict__ long_rows, const int* __restrict__ long_first,
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
// (pieces, c)), one pass per TILE columns; they come first, so the runs
// that take longest start first.  The blocks after them: the short rows, one
// thread per (row, column), striding over the live rows (rows_per rows of c
// columns a block and step).  The live count and the item counts are read
// on the device, so the grid is fixed by the plan's shapes and blocks past
// the work return at once.
template <int TILE, int DEPTH>
__global__ void chain_splat_kernel(const int* __restrict__ sp, const float* __restrict__ sw,
                                   const int* __restrict__ cnt, const int* __restrict__ mid_rows,
                                   const int* __restrict__ n_mid, const int* __restrict__ piece_row,
                                   const int* __restrict__ piece_start, const int* __restrict__ n_pieces,
                                   const int* __restrict__ n_lattice, const float* __restrict__ v, int c, int Mc,
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
        table[(long long)g * c + col] = chain_short_sum(sp, sw, v, c, col, start, len);
      }
    }
    return;
  }
  const int lane = threadIdx.x & 31;
  const int warps = n_warp_blocks * (blockDim.x >> 5);
  const int nm = *n_mid, total = nm + *n_pieces;
  float acc[TILE];
  for (int i = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5); i < total; i += warps) {
    if (i < nm) {  // a mid row into the table; the whole warp: i is the same on every lane
      const int g = mid_rows[i];
      const int start = g == 0 ? 0 : cnt[g - 1], end = cnt[g];
      float* dst = table + (long long)g * c;
      for (int c0 = 0; c0 < c; c0 += TILE) {
        const int cw = c - c0 < TILE ? c - c0 : TILE;
        chain_warp_run<TILE, DEPTH>(sp, sw, v, c, c0, cw, start, end, lane, acc);
#pragma unroll
        for (int k = 0; k < TILE; ++k)
          if (k < cw && lane == k) dst[c0 + k] = acc[k];
      }
      continue;
    }
    const int pi = i - nm;  // a piece of a long row into part
    const int start = piece_start[pi], end = min(start + CHAIN_PIECE, cnt[piece_row[pi]]);
    float* dst = part + (long long)pi * c;
    for (int c0 = 0; c0 < c; c0 += TILE) {
      const int cw = c - c0 < TILE ? c - c0 : TILE;
      chain_warp_run<TILE, DEPTH>(sp, sw, v, c, c0, cw, start, end, lane, acc);
#pragma unroll
      for (int k = 0; k < TILE; ++k)
        if (k < cw && lane == 0) dst[c0 + k] = acc[k];
    }
  }
}

// tapw: this axis's (r, Mc) taps; gather: (Mc,) or null for the last axis.
__global__ void chain_axis_kernel(const float* __restrict__ in, float* __restrict__ out,
                                  const float* __restrict__ tapw, const int* __restrict__ gather,
                                  const int* __restrict__ n_lattice, int Mc, int c, int order, float center) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int nl = *n_lattice;
  const int live = nl < Mc ? nl : Mc;
  if (idx >= (long long)live * c) return;
  const int q = (int)(idx / c);
  const int col = (int)(idx - (long long)q * c);
  const int p = gather == nullptr ? q : gather[q];
  const float* t = in + col;
  float acc = __fmul_rn(center, t[(long long)p * c]);
  for (int k = 1; k <= order; ++k) {
    const float* wk = tapw + (long long)(k - 1) * Mc;
    if (p + k < live) acc = __fadd_rn(acc, __fmul_rn(wk[p], t[(long long)(p + k) * c]));
    if (p - k >= 0) acc = __fadd_rn(acc, __fmul_rn(wk[p - k], t[(long long)(p - k) * c]));
  }
  out[idx] = acc;
}

__global__ void chain_slice_kernel(const float* __restrict__ table, const int* __restrict__ slice_idx,
                                   const float* __restrict__ w, const int* __restrict__ n_lattice, int n,
                                   int dp1, int c, int Mc, float norm, float* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n * c) return;
  if (*n_lattice > Mc) {
    out[idx] = __int_as_float(0x7fc00000);  // quiet NaN: the capacity overflowed
    return;
  }
  const long long p = idx / c;
  const int col = (int)(idx - p * c);
  float acc = 0.0f;
  for (int v = 0; v < dp1; ++v) {
    const long long e = p * dp1 + v;
    acc = __fadd_rn(acc, __fmul_rn(table[(long long)slice_idx[e] * c + col], w[e]));
  }
  out[idx] = __fmul_rn(acc, norm);
}

// The splat.  nl_max, nm_max, np_max: the lengths of long_rows, mid_rows
// and piece_row (bounds fixed by the plan's shapes); N the contributions;
// part holds np_max * c floats.  The first launch sums the short and mid
// rows and the pieces, the second the long rows from their pieces.
template <int TILE, int DEPTH>
static void chain_splat_launch(int n_warp, int n_short, int rows_per, const int* sp, const float* sw,
                               const int* cnt, const int* long_rows, const int* long_first, const int* n_long,
                               const int* piece_row, const int* piece_start, const int* n_pieces,
                               const int* mid_rows, const int* n_mid, int nl_max, const int* n_lattice,
                               const float* v, int c, int Mc, float* table, float* part, cudaStream_t st) {
  chain_splat_kernel<TILE, DEPTH><<<n_warp + n_short, SGP_THREADS, 0, st>>>(
      sp, sw, cnt, mid_rows, n_mid, piece_row, piece_start, n_pieces, n_lattice, v, c, Mc, n_warp, rows_per, table,
      part);
  if (nl_max > 0)
    chain_combine_kernel<TILE, DEPTH><<<(nl_max + SGP_THREADS / 32 - 1) / (SGP_THREADS / 32), SGP_THREADS, 0, st>>>(
        long_rows, long_first, n_long, part, c, table);
}

static cudaError_t chain_launch_splat(const int* sp, const float* sw, const int* cnt, const int* long_rows,
                                      const int* long_first, const int* n_long, const int* piece_row,
                                      const int* piece_start, const int* n_pieces, const int* mid_rows,
                                      const int* n_mid, int nl_max, int nm_max, int np_max, int N,
                                      const int* n_lattice, const float* v, int c, int Mc, float* table, float* part,
                                      cudaStream_t st) {
  if (Mc <= 0 || c <= 0) return cudaGetLastError();
  const int rows_per = c < SGP_THREADS ? SGP_THREADS / c : 1;
  const long long short_blocks = ((long long)Mc + rows_per - 1) / rows_per;
  const long long warp_blocks = ((long long)nm_max + np_max + SGP_THREADS / 32 - 1) / (SGP_THREADS / 32);
  const int n_short = (int)(short_blocks < CHAIN_SHORT_GRID ? short_blocks : CHAIN_SHORT_GRID);
  const int n_warp = (int)(warp_blocks < CHAIN_WARP_GRID ? warp_blocks : CHAIN_WARP_GRID);
  if (c == 1)
    chain_splat_launch<1, CHAIN_DEPTH1>(n_warp, n_short, rows_per, sp, sw, cnt, long_rows, long_first, n_long,
                                        piece_row, piece_start, n_pieces, mid_rows, n_mid, nl_max, n_lattice, v, c,
                                        Mc, table, part, st);
  else if (N < CHAIN_DEEP)
    chain_splat_launch<CHAIN_TILE, CHAIN_DEPTH>(n_warp, n_short, rows_per, sp, sw, cnt, long_rows, long_first,
                                                n_long, piece_row, piece_start, n_pieces, mid_rows, n_mid, nl_max,
                                                n_lattice, v, c, Mc, table, part, st);
  else
    chain_splat_launch<CHAIN_TILE, 1>(n_warp, n_short, rows_per, sp, sw, cnt, long_rows, long_first, n_long,
                                      piece_row, piece_start, n_pieces, mid_rows, n_mid, nl_max, n_lattice, v, c, Mc,
                                      table, part, st);
  return cudaGetLastError();
}

extern "C" int sgp_chain_splat(const int* sp, const float* sw, const int* cnt, const int* long_rows,
                               const int* long_first, const int* n_long, const int* piece_row,
                               const int* piece_start, const int* n_pieces, const int* mid_rows, const int* n_mid,
                               int nl_max, int nm_max, int np_max, int N, const int* n_lattice, const float* v,
                               int c, int Mc, float* table, float* part, void* stream) {
  return (int)chain_launch_splat(sp, sw, cnt, long_rows, long_first, n_long, piece_row, piece_start, n_pieces,
                                 mid_rows, n_mid, nl_max, nm_max, np_max, N, n_lattice, v, c, Mc, table, part,
                                 (cudaStream_t)stream);
}

extern "C" int sgp_chain_axis(const float* in, float* out, const float* tapw, const int* gather,
                              const int* n_lattice, int Mc, int c, int order, float center, void* stream) {
  const long long work = (long long)Mc * c;
  if (work > 0)
    chain_axis_kernel<<<sgp_blocks(work), SGP_THREADS, 0, (cudaStream_t)stream>>>(
        in, out, tapw, gather, n_lattice, Mc, c, order, center);
  return (int)cudaGetLastError();
}

extern "C" int sgp_chain_slice(const float* table, const int* slice_idx, const float* w, const int* n_lattice,
                               int n, int dp1, int c, int Mc, float norm, float* out, void* stream) {
  const long long work = (long long)n * c;
  if (work > 0)
    chain_slice_kernel<<<sgp_blocks(work), SGP_THREADS, 0, (cudaStream_t)stream>>>(
        table, slice_idx, w, n_lattice, n, dp1, c, Mc, norm, out);
  return (int)cudaGetLastError();
}

// The whole apply from one host call: the splat into ta, the d + 1 axes
// between ta and tb (gather: (d, Mc); tapw: (d + 1, r, Mc)), the slice of
// the final table into out (n, c).  ta and tb hold Mc * c floats.
extern "C" int sgp_chain_apply(const int* sp, const float* sw, const int* cnt, const int* long_rows,
                               const int* long_first, const int* n_long, const int* piece_row,
                               const int* piece_start, const int* n_pieces, const int* mid_rows, const int* n_mid,
                               int nl_max, int nm_max, int np_max, int N, const int* n_lattice, const float* v,
                               int n, int c, int Mc, int d,
                               const int* gather, const float* tapw, int order, const float* taps_host,
                               const int* slice_idx, const float* w, float norm, float* ta, float* tb,
                               float* part, float* out, void* stream) {
  if (2 * order + 1 > SGP_MAX_TAPS) return (int)cudaErrorInvalidValue;
  if (n <= 0 || c <= 0 || Mc <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = chain_launch_splat(sp, sw, cnt, long_rows, long_first, n_long, piece_row, piece_start,
                                       n_pieces, mid_rows, n_mid, nl_max, nm_max, np_max, N, n_lattice, v, c, Mc,
                                       ta, part, st);
  if (err != cudaSuccess) return (int)err;
  const long long work = (long long)Mc * c;
  float *a = ta, *b = tb;
  for (int j = 0; j <= d; ++j) {
    chain_axis_kernel<<<sgp_blocks(work), SGP_THREADS, 0, st>>>(
        a, b, tapw + (long long)j * order * Mc, j < d ? gather + (long long)j * Mc : nullptr, n_lattice, Mc, c,
        order, taps_host[order]);
    float* t = a;
    a = b;
    b = t;
  }
  chain_slice_kernel<<<sgp_blocks((long long)n * c), SGP_THREADS, 0, st>>>(a, slice_idx, w, n_lattice, n, d + 1,
                                                                          c, Mc, norm, out);
  return (int)cudaGetLastError();
}
