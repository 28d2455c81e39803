// K4 lattice_filter_once: the one-shot filter out = SLICE_NORM * S^T B S v,
// built and applied in one call, with a bounded lattice table; and K8
// lattice_count: the number of occupied lattice points (its own kernel,
// at the end of this file).
//
// Replaces simplex_gp_tpu/ops/lattice.py::filter_fused (:1166), reached
// through filter_once (:529) and ops/filter.py::_filter_plain (:120) for
// values of at most 16 columns, and count_lattice_points (:839).
//
// Design: the reference's own GPU filter (a hash table of lattice points,
// neighbours found by hashing), not JAX's sort chain, with the main path's
// redesigned parts.  Two host calls around one host read:
//   1. sgp_once_insert: K1's team geometry (geometry.cu) of the n(d+1)
//      vertices, then K2's fill and insert (dedup.cu, sgp_dedup_insert: a
//      plain load of the slot before any CAS; a thread whose CAS claims an
//      empty slot takes the next row id from a counter and records the
//      row's hash pair; bounded, one lap ends a probe sequence and a thread
//      stops at a collision once the counter has passed the capacity);
//   2. the wrapper's read of the count: past the capacity the output is all
//      NaN (JAX's guard, lattice.py:1295) and nothing else runs;
//   3. sgp_once_apply, on one workspace: the seg ids and the (d+1, nl, 2r)
//      neighbour ids of the live rows (dedup.cu's passes: each row's
//      neighbours looked up in the hash table, (h1 + oh1, h2 + oh2) by hash
//      linearity); the row lists of the nl live rows (join_rows.cu's
//      sgp_rows_build: a stable cub radix sort of the seg ids on the bits
//      below nl, K9's runs, three scans, the sort chain's lists: each row's
//      contributions in contribution order); K3'b's row-order splat of v
//      into the live rows, the d+1 axis blurs in one launch of resident
//      blocks with a grid barrier between axes (rows.cuh, sgp_blur_axes),
//      K3's slice.
// The row ids come from a counter and vary from run to run, but nothing
// downstream depends on them: a row's sum runs over its contributions in
// contribution order, a blur reads a row and its neighbours in tap order,
// and the slice adds a point's vertices in vertex order.  So two runs, and
// the plain version under any row numbering, give the same bits.
//
// On an H100 at elevators (c = 11) the blur with its neighbours read from
// the array took 1.13 ms for the whole filter against 1.33-1.37 with the
// neighbours looked up in the hash table inside the fused blur, and 0.56
// against 0.55-0.62 at c = 1 (kernel_times.py --once-sharded; PERF.md
// section 6), so the array, written once by K2's neighbour pass, stays.
//
// Bound: the splat's gathers of v and the blur's 2r + 1 row reads per live
// row and axis (4.4 MB tables at elevators c = 11, in L2), plus random
// 8-byte probes into the hash table (4 MB at elevators, in L2) in the
// insert and the neighbour pass: latency-bound at c <= 16.  Indices into
// the value tables are 64-bit.
#include "rows.cuh"

// Buffers of K4 before the host read, laid out in one int32 allocation
// `pre` of 5N + slots + 2 capacity ints: the vertices' hash pairs and
// weights (N each), each vertex's slot and row (N each), each slot's row,
// each row's hash pair.
struct OncePre {
  int *h1, *h2;
  float* w;
  int *slot_of, *seg, *row_of_slot, *row_h1, *row_h2;
};

static inline OncePre once_pre(int* pre, int N, int slots, int capacity) {
  OncePre p;
  p.h1 = pre;
  p.h2 = pre + N;
  p.w = reinterpret_cast<float*>(pre + 2LL * N);
  p.slot_of = pre + 3LL * N;
  p.seg = pre + 4LL * N;
  p.row_of_slot = pre + 5LL * N;
  p.row_h1 = p.row_of_slot + slots;
  p.row_h2 = p.row_h1 + capacity;
  return p;
}

// K1's team kernel (geometry.cu).
extern "C" int sgp_lattice_geometry(const float* x, const float* E, const int* a, int n, int d, int* h1, int* h2,
                                    float* w, int* s, int per_thread, void* stream);

// K2's fill and insert (dedup.cu).
extern "C" int sgp_dedup_insert(const int* h1, const int* h2, int N, unsigned long long* table, int mask, int capacity,
                                int* slot_of, int* row_of_slot, int* count, int* row_h1, int* row_h2, void* stream);

// K4 up to the host read: K1's team geometry of the n points x (n, d), then
// the table emptied, the count zeroed and the insert of their n(d+1) keys.
// table: mask+1 >= 2 capacity int64 slots; pre: the OncePre buffers; count:
// one int32.
extern "C" int sgp_once_insert(const float* x, const float* E, const int* a, int n, int d, int capacity, int mask,
                               unsigned long long* table, int* pre, int* count, void* stream) {
  if (d + 1 > SGP_MAX_DP1) return (int)cudaErrorInvalidValue;
  const int N = n * (d + 1), slots = mask + 1;
  const OncePre p = once_pre(pre, N, slots, capacity);
  if (N > 0) {
    const int err = sgp_lattice_geometry(x, E, a, n, d, p.h1, p.h2, p.w, nullptr, 0, stream);
    if (err != (int)cudaSuccess) return err;
  }
  return sgp_dedup_insert(p.h1, p.h2, N, table, mask, capacity, p.slot_of, p.row_of_slot, count, p.row_h1, p.row_h2,
                          stream);
}

// K2's passes (dedup.cu), the row build (join_rows.cu) and K3's slice
// (apply.cu).
extern "C" int sgp_dedup_finish(const int* slot_of, const int* row_of_slot, int N, const unsigned long long* table,
                                int mask, int capacity, const int* count, const int* row_h1, const int* row_h2,
                                const int* oh1, const int* oh2, int* seg_ids, int dp1, int r2, int* neighbors,
                                void* stream);
extern "C" int sgp_rows_sizes(int N, int Mt, long long* lists_ints, long long* work_bytes);
extern "C" int sgp_rows_build(const int* seg, const float* w, const int* live, int J, int N, int M, int dp1,
                              int n_pts, int sparse, int* sp, float* sw, int* cnt, int* lists, void* work,
                              long long work_bytes, void* stream);
extern "C" int sgp_lattice_slice(const float* table, const int* seg, const float* w, int n,
                                 int dp1, int c, float norm, float* out, const int* count,
                                 int capacity, void* stream);

// K4's buffers after the host read, carved from one workspace (base null:
// only the size), each 256-byte aligned: the live rows' neighbour ids, the
// row lists (K9's JoinRows fields), the two tables, the long rows' pieces,
// the barrier and the row build's scratch (join_rows.cu).
struct OnceWork {
  int* nb;
  int* sp;
  float* sw;
  int *cnt, *lists;
  float *ta, *tb, *part;
  unsigned int* barrier;
  void* rows_work;
  long long rows_bytes;
};

static inline size_t once_carve(char* base, int N, int nl, int c, int dp1, int r2, OnceWork& b) {
  size_t off = 0;
  auto take = [&](size_t bytes) -> char* {
    off = (off + 255) & ~(size_t)255;
    char* at = base == nullptr ? nullptr : base + off;
    off += bytes;
    return at;
  };
  long long lists_ints = 0;
  sgp_rows_sizes(N, nl, &lists_ints, &b.rows_bytes);
  const size_t rows = (size_t)nl;
  b.nb = (int*)take(sizeof(int) * (size_t)dp1 * rows * r2);
  b.sp = (int*)take(sizeof(int) * (size_t)N);
  b.sw = (float*)take(sizeof(float) * (size_t)N);
  b.cnt = (int*)take(sizeof(int) * rows);
  b.lists = (int*)take(sizeof(int) * (size_t)lists_ints);
  b.ta = (float*)take(sizeof(float) * rows * c);
  b.tb = (float*)take(sizeof(float) * rows * c);
  b.part = (float*)take(sizeof(float) * (size_t)rows_lists(nullptr, N, nl).np_max * c);
  b.barrier = (unsigned int*)take(sizeof(unsigned int));
  b.rows_work = take((size_t)b.rows_bytes);
  return off;
}

// The workspace bytes sgp_once_apply takes for N vertices over nl live rows.
extern "C" int sgp_once_workspace(int N, int nl, int c, int dp1, int r2, long long* bytes) {
  OnceWork b;
  *bytes = (long long)once_carve(nullptr, N, nl, c, dp1, r2, b);
  return (int)cudaGetLastError();
}

// K4 after the host read of a count nl that did not pass the capacity: the
// seg ids and the live rows' neighbour ids (K2's passes), the row lists
// (sgp_rows_build: a stable radix sort of the seg ids on their low
// bit_length(nl - 1) bits, K9's runs, three scans, the sort chain's lists),
// then K3'b's row-order splat of v (n, c), the d+1 blurs in one launch and
// K3's slice into out.  pre, table and count are sgp_once_insert's; work
// holds work_bytes (sgp_once_workspace) and need not be zeroed.
extern "C" int sgp_once_apply(int* pre, const unsigned long long* table, int mask, int capacity, const int* count,
                              int n, int dp1, int nl, const int* oh1, const int* oh2, int r2, const float* v, int c,
                              const float* taps_host, float norm, void* work, long long work_bytes, float* out,
                              void* stream) {
  const int order = r2 / 2;
  if (2 * order + 1 > SGP_MAX_TAPS) return (int)cudaErrorInvalidValue;
  if (n <= 0 || c <= 0 || nl <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const int N = n * dp1;
  const OncePre p = once_pre(pre, N, mask + 1, capacity);
  OnceWork b;
  if ((long long)once_carve(nullptr, N, nl, c, dp1, r2, b) > work_bytes) return (int)cudaErrorInvalidValue;
  once_carve((char*)work, N, nl, c, dp1, r2, b);
  cudaError_t err = (cudaError_t)sgp_dedup_finish(p.slot_of, p.row_of_slot, N, table, mask, nl, count, p.row_h1,
                                                  p.row_h2, oh1, oh2, p.seg, dp1, r2, b.nb, stream);
  if (err != cudaSuccess) return (int)err;
  if ((err = (cudaError_t)sgp_rows_build(p.seg, p.w, count, 1, N, nl, dp1, n, 0, b.sp, b.sw, b.cnt, b.lists,
                                         b.rows_work, b.rows_bytes, stream)) != cudaSuccess)
    return (int)err;
  const RowsLists l = rows_lists(b.lists, N, nl);
  const SgpRuns r = sgp_runs(b.sp, b.sw, b.cnt, l.long_rows, l.long_first, l.n_long, l.piece_row, l.piece_start,
                             l.n_pieces, l.mid_rows, l.n_mid, l.nl_max, l.nm_max, l.np_max, N, count);
  if ((err = sgp_splat_rows(r, SgpWindow{v, c, 0}, c, nl, b.ta, b.part, st)) != cudaSuccess) return (int)err;
  if ((err = sgp_blur_axes(b.ta, b.tb, b.nb, sgp_taps(taps_host, order), nl, nl, c, dp1, order, 0, b.barrier, st)) !=
      cudaSuccess)
    return (int)err;
  return sgp_lattice_slice(dp1 % 2 == 0 ? b.ta : b.tb, p.seg, p.w, n, dp1, c, norm, out, nullptr, 0, stream);
}

// ---- K8: occupancy only ----------------------------------------------------
//
// At houseelectric 24.6M vertex keys land on ~20k lattice points, so a key
// repeats >1,000 times.  K4's first insert took an atomicCAS for every key,
// even one already in its slot, and read the counter before every insert and
// at every collision with an uncached load: the hot slots' CAS runs
// serialised in L2 (12.7 ms at houseelectric; PERF.md section 6).  Here the
// insert reads the slot with a plain load first and stops on a hit; only an
// empty slot takes an atomicCAS (K2's insert, dedup.cu, reads its slot the same way).  A slot only ever goes
// from empty to one key, so a stale read can only be an empty slot, which
// the CAS then settles; the hot slots stay in L1 and L2.  Each thread adds
// up its claims, and each block adds its total to the count with one
// atomicAdd.  The table has >= 2 n(d+1) slots, so it never fills and the
// count is exact.  A per-block dedup of the keys in shared memory first
// (so only a key's first occurrence in the block reaches the global table)
// was measured slower on an H100 (PERF.md section 6): the plain loads of the
// hot slots already hit.
//
// Bound: reading x once (4nd bytes, 0.027 ms at houseelectric) is far
// below the per-point geometry, the same float work as K1's kernel, which
// with the wrapper's fill of the global table is what K8 can approach.

// 1 if this call put key into the table, 0 if it was there.
__device__ __forceinline__ int count_claim(unsigned long long* table, unsigned int mask,
                                           unsigned long long key) {
  unsigned int s = (unsigned int)sgp_mix(key) & mask;
  for (;;) {
    const unsigned long long cur = table[s];
    if (cur == key) return 0;
    if (cur == SGP_EMPTY) {
      const unsigned long long prev = atomicCAS(&table[s], SGP_EMPTY, key);
      if (prev == SGP_EMPTY) return 1;
      if (prev == key) return 0;
    }
    s = (s + 1) & mask;
  }
}

// One thread per point: K1's geometry (sgp_point_geometry, so the hashes
// are the plan's), then its d+1 keys into the table.
__global__ void count_kernel(const float* __restrict__ x, const float* __restrict__ E,
                             const int* __restrict__ a, int n, int d, float scale,
                             unsigned long long* table, unsigned int mask, int* count) {
  __shared__ int claimed;
  if (threadIdx.x == 0) claimed = 0;
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  int mine = 0;
  if (p < n) {
    unsigned int h1[SGP_MAX_DP1], h2[SGP_MAX_DP1];
    float wv[SGP_MAX_DP1];
    sgp_point_geometry(x + (long long)p * d, E, a, d, scale, h1, h2, wv);
    for (int v = 0; v <= d; ++v) mine += count_claim(table, mask, sgp_pack(h1[v], h2[v]));
  }
  for (int off = 16; off > 0; off >>= 1) mine += __shfl_xor_sync(0xffffffffu, mine, off);
  if ((threadIdx.x & 31) == 0 && mine) atomicAdd(&claimed, mine);
  __syncthreads();
  if (threadIdx.x == 0 && claimed) atomicAdd(count, claimed);
}

// K8.  table (mask+1) int64 filled with SGP_EMPTY, mask+1 >= 2 n(d+1);
// count () int32 zeroed.
extern "C" int sgp_lattice_count(const float* x, const float* E, const int* a, int n, int d,
                                 int mask, unsigned long long* table, int* count, void* stream) {
  if (d + 1 > SGP_MAX_DP1) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const float scale = (float)(1.0 / (double)(d + 1));
    count_kernel<<<sgp_blocks(n), SGP_THREADS, 0, (cudaStream_t)stream>>>(x, E, a, n, d, scale, table,
                                                                         (unsigned int)mask, count);
  }
  return (int)cudaGetLastError();
}
