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
// Build, once per loss evaluation or posterior cache.  JAX sorts all N =
// n(d+1) contributions (its scatters are slow on the TPU); here the
// duplicates go through a hash table and only the n_lattice distinct points
// are sorted.  The wrapper (kernels/chain.py) runs the sorts as
// torch.sort, which stands for lax.sort; everything else is here:
//   dedup:   each contribution's lattice point, the 96-bit (axis-0 key, h2)
//            that JAX's group split compares (:720-731), into a table of
//            >= 2N slots, so every distinct point fits and n_lattice is the
//            true count; a claim appends the point to a unique list.
//   [read]   n_lattice to the host (the one host read of a build); then
//   [sort]   the unique list by key; runs of equal keys (chain-word
//            collisions, rarely two points) are put in h2 order by the
//            rank stage: the rows in (key, h2) order, as JAX's sorted groups.
//   rank:    each unique point's rank, then each contribution's.
//   [sort]   the ranks, stable: each row's contributions keep their index
//            (point, then vertex) order, as after JAX's two stable sorts;
//            int16 keys when n_lattice < 2^15 (half the radix passes).  A
//            hand-written stable radix pass a byte (shared-memory counts,
//            then a move of 16 rounds of 256 a block) measured 1.65 ms at
//            houseelectric against this sort's 0.47 and the place kernel's
//            0.39 (PERF.md section 6), so the library sort stays.
//   place:   for every sorted position its point id and weight (the splat
//            reads both in row order).
//   rows:    per table row, cnt, JAX's cumulative contribution end (:752-
//            756), by a binary search of the sorted ranks; its run class;
//            its key along every axis 0..d (:758-764).
//            Past the capacity (n_lattice > Mc) the table keeps the Mc first
//            points in (key, h2) order, the last live row's run ends at N
//            and every contribution of a dropped point reads the last row
//            (the slice writes NaN there): JAX's build, bit for bit.
//   [sort]   the live rows' d axis-j keys, j = 1..d, in one batched stable
//            sort (the dead rows would sort last in row order: no tap
//            reaches them, and their positions are the identity).
//   finish:  tapw[j, k-1, p], the tap linking sorted rows p and p+k of axis
//            j (_axis_tap_weights, :666-690): taps[r + t] when both are live,
//            share a chain and their biased sums differ by t step (step 1
//            for j < d, d for axis d), for some t in [k, r]; else 0; the
//            inverse of each axis order; the gather of each transition,
//            position q of axis j+1 reads position g_j[q] of axis j (JAX
//            sorts the table by the same fixed keys in every apply, :1023-
//            1027); slice_idx, each contribution's final position (:894).
//   lists:   from the [cumsum] of the long rows' flags and piece counts and
//            the mid rows' flags, the list of long rows with their first
//            pieces, each piece's row and first contribution, and the list
//            of mid rows (runs of CHAIN_SHORT+1 .. CHAIN_PIECE).
// The table's claims and the unique list's order depend on the race; the
// plan is read only through sorts of distinct keys and stable sorts, so two
// builds give the same bits.  Bound: bytes.  h1, h2, s, w in, splat points,
// weights and slice_idx out (28N); the sort of the N ranks moves ~10N a
// radix pass.  At houseelectric (N = 15.7M contributions, ~20k points) two
// stable sorts of all N contributions, with their N-sized gathers, prefix
// sum and compaction, took ~6 of a 7.3 ms build (PERF.md section 6).
//
// Apply, four launches and a memset from one host call (sgp_chain_apply;
// three where the plan has too few contributions for a long row), no
// atomics in the arithmetic, no host read.  The live count stays on the
// device: threads of rows at or past min(n_lattice, Mc) return at once (the
// fused axes stride over the live rows only), and the
// slice writes NaN when n_lattice > Mc (JAX's guard, :1093-1100).  Tables
// are (Mc, c) row-major.
//   splat (K3'b, rows.cuh, shared with K9 and K7): row g is the sum of its
//     contiguous run of sorted contributions, w * v[point], in one fixed
//     order, the warp order: each of 32 lanes sums every 32nd contribution,
//     then a butterfly of shuffles.  Runs are very uneven (elevators: ~2
//     contributions a row, one row ~10k; houseelectric: ~790 a row, one row
//     1.17M of 15.7M), so the work is split by run length, each class in
//     the warp order:
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
//     order.  chain_axis_kernel: one axis, one thread per (position,
//     column), one launch an axis (the tests' and the A/B's).  The apply
//     runs all d + 1 axes in one launch, chain_axes_kernel: a grid of
//     resident blocks strides over the live (position, column) elements,
//     with a grid barrier between axes, so the table ping-pongs between two
//     buffers that stay in L2 (4.4 MB at elevators c = 11) and the d + 1
//     launches' host work and tails are gone.  The same operations per
//     element, so the fused and per-axis applies are bit-equal.
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
#include "rows.cuh"

#define CHAIN_S_MASK 0x1FFFFFu   // _S_MASK, the low 21 bits
#define CHAIN_S_BIAS (1 << 20)   // _S_BIAS
#define CHAIN_TOP_MASK 0xFFE00000u  // _TOP_MASK
__device__ __forceinline__ long long chain_key(unsigned int c1, unsigned int c2, int s) {
  int sb = s + CHAIN_S_BIAS;
  sb = sb < 0 ? 0 : (sb > (int)CHAIN_S_MASK ? (int)CHAIN_S_MASK : sb);
  const unsigned int packed = (c2 & CHAIN_TOP_MASK) | (unsigned int)sb;
  return (long long)(((unsigned long long)c1 << 32) | (packed ^ 0x80000000u));
}

// ---- build ------------------------------------------------------------------

#define CHAIN_EMPTY (-1)  // an empty slot of the dedup table

// Axis-0 key of contribution e: the multiplier of every axis j < d is 1
// (_axis_dir), so c1 = h1 - s oh1_0, c2 = h2 - s oh2_0.
__device__ __forceinline__ long long chain_key0(const int* __restrict__ h1, const int* __restrict__ h2,
                                                const int* __restrict__ s, int e, unsigned int oh1,
                                                unsigned int oh2) {
  const int se = __ldg(s + e);
  return chain_key((unsigned int)__ldg(h1 + e) - (unsigned int)se * oh1,
                   (unsigned int)__ldg(h2 + e) - (unsigned int)se * oh2, se);
}

// One thread per contribution, in index order: the contribution's lattice
// point (key, h2) into an open-addressing table of mask+1 >= 2N int32 slots
// holding the index of the point's first-claiming contribution, the
// representative, whose identity is read back from h1, h2 and s.  A plain
// load of the slot first, a CAS only on an empty one (K8's insert,
// once.cu).  Each claim appends the point to the unique list (key, h2, its
// representative), one counter add a warp; the counter ends as n_lattice.
// The list's order depends on the race; nothing downstream reads it but
// through a sort of its distinct keys.
__global__ void chain_dedup_kernel(const int* __restrict__ h1, const int* __restrict__ h2,
                                   const int* __restrict__ s, int N, const int* __restrict__ consts, int dp1,
                                   int* table, unsigned int mask, int* __restrict__ rep_of,
                                   long long* __restrict__ uniq_key, int* __restrict__ uniq_h2,
                                   int* __restrict__ uniq_rep, int* __restrict__ count) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned int oh1 = (unsigned int)__ldg(consts), oh2 = (unsigned int)__ldg(consts + dp1);
  bool claimed = false;
  long long key = 0;
  int hh = 0;
  if (e < N) {
    key = chain_key0(h1, h2, s, e, oh1, oh2);
    hh = __ldg(h2 + e);
    unsigned int slot = (unsigned int)sgp_mix((unsigned long long)key ^
                                              ((unsigned long long)(unsigned int)hh * 0x9E3779B97F4A7C15ULL)) &
                        mask;
    for (;;) {
      int cur = table[slot];
      if (cur == CHAIN_EMPTY) {
        cur = atomicCAS(table + slot, CHAIN_EMPTY, e);
        if (cur == CHAIN_EMPTY) {
          claimed = true;
          rep_of[e] = e;
          break;
        }
      }
      if (__ldg(h2 + cur) == hh && chain_key0(h1, h2, s, cur, oh1, oh2) == key) {
        rep_of[e] = cur;
        break;
      }
      slot = (slot + 1) & mask;
    }
  }
  const unsigned int ballot = __ballot_sync(0xffffffffu, claimed);
  if (ballot == 0) return;
  const int lane = threadIdx.x & 31, leader = __ffs(ballot) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(count, __popc(ballot));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (claimed) {
    const int u = base + __popc(ballot & ((1u << lane) - 1u));
    uniq_key[u] = key;
    uniq_h2[u] = hh;
    uniq_rep[u] = e;
  }
}

// The unique list sorted by key alone (sk the sorted keys, p the order) is
// in (key, h2) order but within runs of equal keys (distinct points whose
// chain words collide: runs of one, rarely two).  The thread at a run's
// start places each of its m points by its h2 (distinct within the run):
// rank r = start + the number of the run's points of smaller h2.  Each
// point's rank by representative, and for a row of the table (r < Mc) its
// key and h2.
__global__ void chain_unique_rank_kernel(const long long* __restrict__ sk, const long long* __restrict__ p,
                                         const int* __restrict__ uniq_h2, const int* __restrict__ uniq_rep, int nl,
                                         int Mc, int* __restrict__ rank_by_rep, long long* __restrict__ row_key,
                                         int* __restrict__ row_h2) {
  const int start = blockIdx.x * blockDim.x + threadIdx.x;
  if (start >= nl || (start > 0 && sk[start - 1] == sk[start])) return;
  const long long key = sk[start];
  int m = 1;
  while (start + m < nl && sk[start + m] == key) ++m;
  for (int a = 0; a < m; ++a) {
    const long long u = p[start + a];
    const int h = uniq_h2[u];
    int r = start;
    for (int b = 0; b < m; ++b) r += uniq_h2[p[start + b]] < h;
    rank_by_rep[uniq_rep[u]] = r;
    if (r < Mc) {
      row_key[r] = key;
      row_h2[r] = h;
    }
  }
}

// Each contribution's rank (its point's place in (key, h2) order, not
// clamped to the capacity), and the same as the int16 sort key when key16
// is set (n_lattice < 2^15).
__global__ void chain_contrib_rank_kernel(const int* __restrict__ rep_of, const int* __restrict__ rank_by_rep,
                                          int N, int* __restrict__ rank, short* __restrict__ key16) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= N) return;
  const int r = rank_by_rep[rep_of[e]];
  rank[e] = r;
  if (key16 != nullptr) key16[e] = (short)r;
}

// q-th contribution in row order (the stable sort of the ranks): its point
// and weight.
__global__ void chain_place_kernel(const long long* __restrict__ perm, const float* __restrict__ w, int N, int dp1,
                                   int* __restrict__ sp, float* __restrict__ sw) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= N) return;
  const int e = (int)perm[q];
  sp[q] = e / dp1;
  sw[q] = w[e];
}

// The end of the run of rank g in the sorted ranks: the first position
// past its last contribution.
template <typename Key>
__device__ __forceinline__ int chain_run_end(const Key* __restrict__ sorted, int N, int g) {
  int lo = 0, hi = N;
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    if ((int)sorted[mid] <= g) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Per table row g (the table is in axis-0 order): cnt, JAX's cumulative
// contribution end, N for the last live row and every dead one (past the
// capacity the last live row's run takes in the points dropped); the run
// class of a live row; its key along every axis 0..d, (d+1, live).
// consts: (3, d+1) int32, the rows oh1, oh2 and mult of every axis.
template <typename Key>
__global__ void chain_rows_kernel(const long long* __restrict__ row_key, const int* __restrict__ row_h2,
                                  const Key* __restrict__ sorted, int live, int N, int Mc, int d,
                                  const int* __restrict__ consts, int* __restrict__ cnt,
                                  long long* __restrict__ keys, int* __restrict__ long_info) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= Mc) return;
  const int dp1 = d + 1;
  const int end = g + 1 < live ? chain_run_end(sorted, N, g) : N;
  cnt[g] = end;
  if (g >= live) {
    long_info[g] = long_info[Mc + g] = long_info[2 * Mc + g] = 0;
    return;
  }
  sgp_run_class(long_info, Mc, g, end - (g == 0 ? 0 : chain_run_end(sorted, N, g - 1)));
  const long long k0 = row_key[g];
  const unsigned int c1 = (unsigned int)(k0 >> 32);
  const int us = (int)(((unsigned int)k0) & CHAIN_S_MASK) - CHAIN_S_BIAS;
  const unsigned int uh1 = c1 + (unsigned int)us * (unsigned int)consts[0];
  const unsigned int uh2 = (unsigned int)row_h2[g];
  for (int j = 0; j < dp1; ++j) {
    const unsigned int m = (unsigned int)consts[2 * dp1 + j];
    keys[(long long)j * live + g] = chain_key(m * uh1 - (unsigned int)us * (unsigned int)consts[j],
                                              m * uh2 - (unsigned int)us * (unsigned int)consts[dp1 + j], us);
  }
}

// One thread per (axis j, position p): the taps of axis j at p (keys: the
// live rows' axis-0 keys, the table's own order; sorted: axes 1..d sorted,
// (d, live)), and for j >= 1 the inverse of axis j's order (order_j, (d,
// live)), the identity past the live rows (dead rows sort last, in row
// order, as INT64_MAX keys would).
__global__ void chain_taps_kernel(const long long* __restrict__ keys, const long long* __restrict__ sorted,
                                  const long long* __restrict__ order_j, int live, int Mc, int d, int order,
                                  SgpTaps taps, float* __restrict__ tapw, int* __restrict__ pos) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)(d + 1) * Mc) return;
  const int j = (int)(idx / Mc);
  const int p = (int)(idx - (long long)j * Mc);
  const long long* k = j == 0 ? keys : sorted + (long long)(j - 1) * live;
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
  if (j == 0) return;
  const long long row = p < live ? order_j[(long long)(j - 1) * live + p] : p;
  pos[(long long)(j - 1) * Mc + row] = p;
}

// gather[0] = the order of axis 1; gather[j] = pos_j[order of axis j+1]
// for j = 1..d-1; then slice_idx, the final (axis-d) position of each
// contribution's row (its rank clamped to the last row).
__global__ void chain_gather_kernel(const long long* __restrict__ order_j, const int* __restrict__ pos,
                                    const int* __restrict__ rank, int live, int Mc, int d, int N,
                                    int* __restrict__ gather, int* __restrict__ slice_idx) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)d * Mc;
  if (idx < total) {
    const int j = (int)(idx / Mc);
    const int q = (int)(idx - (long long)j * Mc);
    const long long row = q < live ? order_j[(long long)j * live + q] : q;
    gather[idx] = j == 0 ? (int)row : pos[(long long)(j - 1) * Mc + row];
    return;
  }
  const long long e = idx - total;
  if (e >= N) return;
  const int r = rank[e];
  slice_idx[e] = pos[(long long)(d - 1) * Mc + (r < Mc ? r : Mc - 1)];
}

// The build's stages, in the order the wrapper (kernels/chain.py) calls
// them around its torch.sort calls.  consts: (3, d+1) int32.
// Stage 1, the dedup: table (mask+1 int32 slots) and count are cleared here.
extern "C" int sgp_chain_dedup(const int* h1, const int* h2, const int* s, int N, const int* consts, int dp1,
                               int* table, int mask, int* rep_of, long long* uniq_key, int* uniq_h2, int* uniq_rep,
                               int* count, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(table, 0xFF, ((size_t)(unsigned int)mask + 1) * sizeof(int), st);
  cudaMemsetAsync(count, 0, sizeof(int), st);
  if (N > 0)
    chain_dedup_kernel<<<sgp_blocks(N), SGP_THREADS, 0, st>>>(h1, h2, s, N, consts, dp1, table, (unsigned int)mask,
                                                             rep_of, uniq_key, uniq_h2, uniq_rep, count);
  return (int)cudaGetLastError();
}

// Stage 2, the ranks, from the unique list's keys sorted (sk) and its order
// by them (p), nl points.
extern "C" int sgp_chain_rank(const long long* sk, const long long* p, const int* uniq_h2, const int* uniq_rep,
                              int nl, int Mc, const int* rep_of, int N, int* rank_by_rep, long long* row_key,
                              int* row_h2, int* rank, short* key16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nl > 0)
    chain_unique_rank_kernel<<<sgp_blocks(nl), SGP_THREADS, 0, st>>>(sk, p, uniq_h2, uniq_rep, nl, Mc, rank_by_rep,
                                                                    row_key, row_h2);
  if (N > 0)
    chain_contrib_rank_kernel<<<sgp_blocks(N), SGP_THREADS, 0, st>>>(rep_of, rank_by_rep, N, rank, key16);
  return (int)cudaGetLastError();
}

// Stage 3, the placement, from the stable sort of the ranks (perm int64).
extern "C" int sgp_chain_place(const long long* perm, const float* w, int N, int dp1, int* sp, float* sw,
                               void* stream) {
  if (N > 0)
    chain_place_kernel<<<sgp_blocks(N), SGP_THREADS, 0, (cudaStream_t)stream>>>(perm, w, N, dp1, sp, sw);
  return (int)cudaGetLastError();
}

// Stage 4, the rows: cnt (each run's end found in the sorted ranks, int16
// when key16, else int32), run classes and the live rows' axis keys.
extern "C" int sgp_chain_rows(const long long* row_key, const int* row_h2, const void* sorted, int key16, int live,
                              int N, int Mc, int d, const int* consts, int* cnt, long long* keys, int* long_info,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (Mc > 0) {
    if (key16)
      chain_rows_kernel<short><<<sgp_blocks(Mc), SGP_THREADS, 0, st>>>(
          row_key, row_h2, (const short*)sorted, live, N, Mc, d, consts, cnt, keys, long_info);
    else
      chain_rows_kernel<int><<<sgp_blocks(Mc), SGP_THREADS, 0, st>>>(
          row_key, row_h2, (const int*)sorted, live, N, Mc, d, consts, cnt, keys, long_info);
  }
  return (int)cudaGetLastError();
}

// Stage 5, after the sort of the axis keys: the taps and the axes'
// inverses, then the transitions and slice_idx.  pos: (d, Mc) scratch.
extern "C" int sgp_chain_finish(const long long* keys, const long long* sorted, const long long* order_j,
                                const int* rank, int live, int Mc, int d, int order, const float* taps_host, int N,
                                float* tapw, int* pos, int* gather, int* slice_idx, void* stream) {
  if (2 * order + 1 > SGP_MAX_TAPS) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long work = (long long)(d + 1) * Mc;
  if (work > 0)
    chain_taps_kernel<<<sgp_blocks(work), SGP_THREADS, 0, st>>>(keys, sorted, order_j, live, Mc, d, order,
                                                                sgp_taps(taps_host, order), tapw, pos);
  const long long total = (long long)d * Mc + N;
  if (total > 0)
    chain_gather_kernel<<<sgp_blocks(total), SGP_THREADS, 0, st>>>(order_j, pos, rank, live, Mc, d, N, gather,
                                                                   slice_idx);
  return (int)cudaGetLastError();
}

// The splat's lists from the rows' classes long_info and their scan along
// the rows, (3, Mc) each (rows.cuh); the chain's build and a join plan's
// row lists (join_rows.cu) both end with it.
extern "C" int sgp_run_lists(const int* long_info, const int* scan, const int* cnt, int Mc, int* long_rows,
                             int* long_first, int* piece_row, int* piece_start, int* n_long, int* n_pieces,
                             int* mid_rows, int* n_mid, void* stream) {
  if (Mc > 0)
    sgp_run_lists_kernel<<<sgp_blocks(Mc), SGP_THREADS, 0, (cudaStream_t)stream>>>(
        long_info, scan, cnt, Mc, long_rows, long_first, piece_row, piece_start, n_long, n_pieces, mid_rows,
        n_mid);
  return (int)cudaGetLastError();
}

// ---- apply ------------------------------------------------------------------

// One output of axis j's stencil: the element (q, col) of the next axis's
// order reads position p = gather[q] of this axis's table `in` (the last
// axis: p = q).  tapw: this axis's (r, Mc) taps.  kL2 loads the table
// through L2 (it was written by other blocks of the same launch, K3'c
// fused); kOrder > 0 fixes r at compile time (the loop over the taps
// unrolls), 0 reads it from `order`.  The arithmetic is the same for all.
template <bool kL2, int kOrder>
__device__ __forceinline__ float chain_axis_at(const float* in, const float* __restrict__ tapw, int p, int live,
                                               int Mc, int c, int col, int order, float center) {
  const float* t = in + col;
  auto at = [&](int row) { return kL2 ? __ldcg(t + (long long)row * c) : t[(long long)row * c]; };
  float acc = __fmul_rn(center, at(p));
  auto tap = [&](int k) {
    const float* wk = tapw + (long long)(k - 1) * Mc;
    if (p + k < live) acc = __fadd_rn(acc, __fmul_rn(__ldg(wk + p), at(p + k)));
    if (p - k >= 0) acc = __fadd_rn(acc, __fmul_rn(__ldg(wk + p - k), at(p - k)));
  };
  if constexpr (kOrder > 0) {
#pragma unroll
    for (int k = 1; k <= kOrder; ++k) tap(k);
  } else {
    for (int k = 1; k <= order; ++k) tap(k);
  }
  return acc;
}

__global__ void chain_axis_kernel(const float* __restrict__ in, float* __restrict__ out,
                                  const float* __restrict__ tapw, const int* __restrict__ gather,
                                  const int* __restrict__ n_lattice, int Mc, int c, int order, float center) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int nl = *n_lattice;
  const int live = nl < Mc ? nl : Mc;
  if (idx >= (long long)live * c) return;
  const int q = (int)(idx / c);
  const int col = (int)(idx - (long long)q * c);
  const int p = gather == nullptr ? q : __ldg(gather + q);
  out[idx] = chain_axis_at<false, 0>(in, tapw, p, live, Mc, c, col, order, center);
}

// K3'c fused: all d + 1 axes of an apply in one launch.  A grid of resident
// blocks strides over the live (position, column) elements of each axis,
// axis 0 from ta into tb, axis 1 back into ta, and so on, with a grid
// barrier between axes (sgp_grid_barrier; *barrier is 0 at the launch).
// The final table is ta when d + 1 is even, else tb.  Each element is
// chain_axis_kernel's, operation for operation.  A thread holds
// CHAIN_AXES_HELD elements a pass, their rows and columns found once, and
// reads the next axis's gather for them before the barrier, so after it
// only the table loads (all taps at once) stand between a block and its
// stores.  Element indices are I: int for a table of fewer than 2^30
// elements (every CG's), long long above.
#define CHAIN_AXES_THREADS 512
#define CHAIN_AXES_HELD 8

template <int kOrder, typename I>
__global__ void __launch_bounds__(CHAIN_AXES_THREADS, 2)
    chain_axes_kernel(float* ta, float* tb, const float* __restrict__ tapw, const int* __restrict__ gather,
                      const int* __restrict__ n_lattice, int Mc, int c, int d, int order, float center,
                      unsigned int* barrier) {
  const int nl = *n_lattice;
  const int live = nl < Mc ? nl : Mc;
  const I work = (I)live * c;
  const I stride = (I)gridDim.x * blockDim.x;
  const I first = (I)blockIdx.x * blockDim.x + threadIdx.x;
  int q0[CHAIN_AXES_HELD], col0[CHAIN_AXES_HELD], next[CHAIN_AXES_HELD];
#pragma unroll
  for (int u = 0; u < CHAIN_AXES_HELD; ++u) {
    const I idx = first + u * stride;
    q0[u] = idx < work ? (int)(idx / c) : 0;
    col0[u] = (int)(idx - (I)q0[u] * c);
    next[u] = idx < work ? __ldg(gather + q0[u]) : 0;  // axis 0's gather (d >= 1)
  }
  float* a = ta;
  float* b = tb;
  for (int j = 0; j <= d; ++j) {
    const float* w = tapw + (long long)j * order * Mc;
    const int* g = gather + (long long)j * Mc;
    for (I base = first; base < work; base += CHAIN_AXES_HELD * stride) {
      const bool held = base == first;
      float v[CHAIN_AXES_HELD];
#pragma unroll
      for (int u = 0; u < CHAIN_AXES_HELD; ++u) {
        const I idx = base + u * stride;
        if (idx < work) {
          const int q = held ? q0[u] : (int)(idx / c);
          const int col = held ? col0[u] : (int)(idx - (I)q * c);
          const int p = held ? next[u] : (j < d ? __ldg(g + q) : q);
          v[u] = chain_axis_at<true, kOrder>(a, w, p, live, Mc, c, col, order, center);
        }
      }
#pragma unroll
      for (int u = 0; u < CHAIN_AXES_HELD; ++u) {
        const I idx = base + u * stride;
        if (idx < work) __stcg(b + idx, v[u]);
      }
    }
    if (j < d) {
      const int* gn = gather + (long long)(j + 1) * Mc;
#pragma unroll
      for (int u = 0; u < CHAIN_AXES_HELD; ++u)
        next[u] = first + u * stride < work ? (j + 1 < d ? __ldg(gn + q0[u]) : q0[u]) : 0;
      sgp_grid_barrier(barrier, (unsigned int)(j + 1) * gridDim.x);
    }
    float* t = a;
    a = b;
    b = t;
  }
}

// The fused axes' launch.  The grid gives a thread to each element of the
// capacity's table (Mc * c, the host's bound on the live ones), or is the
// resident blocks if fewer.  (A grid of CHAIN_AXES_HELD elements a thread,
// so the barrier spans fewer blocks, was no faster on an H100 at 700 W:
// 0.092 against 0.086-0.092 ms at elevators c = 1, 50 blocks against 264;
// and slower at houseelectric c = 1, 0.066 against 0.033 ms, 8 blocks
// against 64.)  Order 1, the path's, gets its own kernel; other orders read
// it from `order`.  Element indices are int below 2^30 elements.
template <int kOrder, typename I>
static inline cudaError_t chain_axes_launch_as(float* ta, float* tb, const float* tapw, const int* gather,
                                               const int* n_lattice, int Mc, int c, int d, int order, float center,
                                               unsigned int* barrier, cudaStream_t st) {
  const long long need = ((long long)Mc * c + CHAIN_AXES_THREADS - 1) / CHAIN_AXES_THREADS;
  const int resident = sgp_coresident_blocks(chain_axes_kernel<kOrder, I>, CHAIN_AXES_THREADS, 0);
  const int grid = (int)(need < resident ? (need > 0 ? need : 1) : resident);
  chain_axes_kernel<kOrder, I>
      <<<grid, CHAIN_AXES_THREADS, 0, st>>>(ta, tb, tapw, gather, n_lattice, Mc, c, d, order, center, barrier);
  return cudaGetLastError();
}

template <int kOrder>
static inline cudaError_t chain_axes_launch_order(float* ta, float* tb, const float* tapw, const int* gather,
                                                  const int* n_lattice, int Mc, int c, int d, int order,
                                                  float center, unsigned int* barrier, cudaStream_t st) {
  if ((long long)Mc * c < (1LL << 30))
    return chain_axes_launch_as<kOrder, int>(ta, tb, tapw, gather, n_lattice, Mc, c, d, order, center, barrier, st);
  return chain_axes_launch_as<kOrder, long long>(ta, tb, tapw, gather, n_lattice, Mc, c, d, order, center, barrier,
                                                 st);
}

static inline cudaError_t chain_axes_launch(float* ta, float* tb, const float* tapw, const int* gather,
                                            const int* n_lattice, int Mc, int c, int d, int order, float center,
                                            unsigned int* barrier, cudaStream_t st) {
  if (d < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(barrier, 0, sizeof(unsigned int), st);
  if (err != cudaSuccess) return err;
  if (order == 1)
    return chain_axes_launch_order<1>(ta, tb, tapw, gather, n_lattice, Mc, c, d, order, center, barrier, st);
  return chain_axes_launch_order<0>(ta, tb, tapw, gather, n_lattice, Mc, c, d, order, center, barrier, st);
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

extern "C" int sgp_chain_splat(const int* sp, const float* sw, const int* cnt, const int* long_rows,
                               const int* long_first, const int* n_long, const int* piece_row,
                               const int* piece_start, const int* n_pieces, const int* mid_rows, const int* n_mid,
                               int nl_max, int nm_max, int np_max, int N, const int* n_lattice, const float* v,
                               int c, int Mc, float* table, float* part, void* stream) {
  const SgpRuns r = sgp_runs(sp, sw, cnt, long_rows, long_first, n_long, piece_row, piece_start, n_pieces,
                               mid_rows, n_mid, nl_max, nm_max, np_max, N, n_lattice);
  return (int)sgp_splat_rows(r, SgpWindow{v, c, 0}, c, Mc, table, part, (cudaStream_t)stream);
}

extern "C" int sgp_chain_axis(const float* in, float* out, const float* tapw, const int* gather,
                              const int* n_lattice, int Mc, int c, int order, float center, void* stream) {
  const long long work = (long long)Mc * c;
  if (work > 0)
    chain_axis_kernel<<<sgp_blocks(work), SGP_THREADS, 0, (cudaStream_t)stream>>>(
        in, out, tapw, gather, n_lattice, Mc, c, order, center);
  return (int)cudaGetLastError();
}

// K3'c fused alone: the d + 1 axes of a table in ta (Mc, c); tb is scratch
// of the same size; the result lands in ta when d + 1 is even, else in tb.
extern "C" int sgp_chain_axes(float* ta, float* tb, const float* tapw, const int* gather, const int* n_lattice,
                              int Mc, int c, int d, int order, float center, unsigned int* barrier, void* stream) {
  if ((long long)Mc * c <= 0) return (int)cudaGetLastError();
  return (int)chain_axes_launch(ta, tb, tapw, gather, n_lattice, Mc, c, d, order, center, barrier,
                                (cudaStream_t)stream);
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
// between ta and tb in one fused launch (gather: (d, Mc); tapw: (d + 1, r,
// Mc)), the slice of the final table into out (n, c).  ta and tb hold Mc * c
// floats; barrier is one uint of scratch for the fused launch.
extern "C" int sgp_chain_apply(const int* sp, const float* sw, const int* cnt, const int* long_rows,
                               const int* long_first, const int* n_long, const int* piece_row,
                               const int* piece_start, const int* n_pieces, const int* mid_rows, const int* n_mid,
                               int nl_max, int nm_max, int np_max, int N, const int* n_lattice, const float* v,
                               int n, int c, int Mc, int d,
                               const int* gather, const float* tapw, int order, const float* taps_host,
                               const int* slice_idx, const float* w, float norm, float* ta, float* tb,
                               float* part, unsigned int* barrier, float* out, void* stream) {
  if (2 * order + 1 > SGP_MAX_TAPS) return (int)cudaErrorInvalidValue;
  if (n <= 0 || c <= 0 || Mc <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const SgpRuns r = sgp_runs(sp, sw, cnt, long_rows, long_first, n_long, piece_row, piece_start, n_pieces,
                               mid_rows, n_mid, nl_max, nm_max, np_max, N, n_lattice);
  cudaError_t err = sgp_splat_rows(r, SgpWindow{v, c, 0}, c, Mc, ta, part, st);
  if (err != cudaSuccess) return (int)err;
  err = chain_axes_launch(ta, tb, tapw, gather, n_lattice, Mc, c, d, order, taps_host[order], barrier, st);
  if (err != cudaSuccess) return (int)err;
  const float* final_table = (d + 1) % 2 == 0 ? ta : tb;
  chain_slice_kernel<<<sgp_blocks((long long)n * c), SGP_THREADS, 0, st>>>(final_table, slice_idx, w, n_lattice, n,
                                                                          d + 1, c, Mc, norm, out);
  return (int)cudaGetLastError();
}
