// K2 lattice_dedup_neighbors: dedup the n(d+1) vertex hash pairs into
// lattice rows and find every row's 2r blur neighbours along each axis.
//
// Replaces simplex_gp_tpu/ops/lattice.py::_plan_tables (:387), i.e. the sort
// dedup plus the sort-join _pair_join (:253) of build_plan_join (:441).
//
// Bound: random 8-byte probes into a table of >= 2N slots (N = n(d+1)): at
// elevators scale N = 264,917 and the table is 8 MiB, resident in the 50 MB
// L2, so probes are L2-latency-bound.  Design: the reference's own GPU hash
// table (permutohedral_cuda_kernel.cu:173-201) instead of the TPU's sorts.
// The table's insert and lookup are common.cuh's sgp_insert and sgp_find;
// K4 and K8 (once.cu) keep tables of the same layout, and K4 runs this
// file's seg and neighbour passes on its own.
//   1. insert: open addressing with linear probing, atomicCAS of the packed
//      64-bit key; the thread whose CAS claims an empty slot takes the next
//      dense row id from an atomic counter and records the row's hash pair.
//   2. seg: every contribution reads the row id of the slot it landed in.
//   3. neighbors: one thread per (axis, row, tap) probes
//      (h1 + oh1[axis, tap], h2 + oh2[axis, tap]) -- hash linearity makes
//      that the neighbour key's hash -- and writes the row id, or M if the
//      neighbour is not occupied.  Rows past the live count write M.
// Row numbering follows the order in which threads win their CAS, so it
// varies from run to run; the count n_lattice and the operator do not.
//
// Bounded (a capacity below N, the training plan of a trimmed run; JAX's
// build_plan(capacity), lattice.py:857-892 and _chain_core :733): the hash
// table has >= 2 capacity slots and M = capacity rows, and the insert is
// sgp_insert<true> -- a thread stops at its next collision once the counter
// has passed the capacity, and one lap ends any probe sequence.  On that
// overflow every seg id is 0 (a valid row), the neighbour pass writes M
// everywhere, and the count is left past the capacity, which K3's guard
// (apply.cu) reads.  The untrimmed K2 keeps sgp_insert<false>: the counter
// read on each collision cost it 7-18% on the H100.
//
// K11a, the ordered dedup of the sharded plan (build_plan_sharded_join,
// simplex_gp_tpu/parallel/shard_filter.py:118-143): every rank builds the
// global plan from the same all-gathered hashes, and the partial lattice
// tables of the ranks are summed row by row (apply.cu, K11b), so a row must
// be the same lattice point on every rank.  The CAS order above differs from
// rank to rank; K11a numbers rows by their first contributing vertex in
// global vertex order instead, which any two runs on the same hashes agree on
// (JAX numbers them in sorted hash order, _plan_tables :404-408; any fixed
// order gives the same operator).
//   1. insert as K2 (sgp_insert<false>);
//   2. first: atomicMin of the vertex index into its slot, then a flag on
//      each vertex that is its slot's first;
//   3. the wrapper's inclusive scan of the flags (torch.cumsum) gives each
//      first vertex its row, scan - 1;
//   4. remap: each first vertex writes its row into row_of_slot and its hash
//      pair into row_h1/row_h2, replacing the CAS-order ids;
//   5. seg and neighbours as K2 (sgp_dedup_finish), on the new ids.
// The extra passes are three coalesced sweeps over the N vertices and one
// scattered atomic per vertex into the L2-resident slot array.
#include "common.cuh"

template <bool kBounded>
__global__ void insert_kernel(const int* __restrict__ h1, const int* __restrict__ h2, int N,
                              unsigned long long* table, unsigned int mask, int capacity,
                              int* __restrict__ slot_of, int* row_of_slot, int* count,
                              int* row_h1, int* row_h2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  slot_of[i] = kBounded && *(volatile int*)count > capacity
                   ? -1
                   : sgp_insert<kBounded>((unsigned int)h1[i], (unsigned int)h2[i], table, mask,
                                          capacity, row_of_slot, row_h1, row_h2, count);
}

__global__ void seg_kernel(const int* __restrict__ slot_of, const int* __restrict__ row_of_slot,
                           int N, const int* __restrict__ count, int capacity,
                           int* __restrict__ seg_ids) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  // Past the capacity (bounded K2 and K4) every row id is replaced by 0, a
  // valid row, so no later phase reads out of bounds; the guard writes NaN.
  seg_ids[i] = *count > capacity ? 0 : row_of_slot[slot_of[i]];
}

__global__ void neighbors_kernel(const unsigned long long* __restrict__ table, unsigned int mask,
                                 const int* __restrict__ row_of_slot,
                                 const int* __restrict__ count, const int* __restrict__ row_h1,
                                 const int* __restrict__ row_h2, const int* __restrict__ oh1,
                                 const int* __restrict__ oh2, int M, int dp1, int r2,
                                 int* __restrict__ neighbors) {
  // neighbors is (dp1, M, r2): index = (axis * M + row) * r2 + tap.
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)dp1 * M * r2) return;
  const int tap = (int)(idx % r2);
  const int row = (int)((idx / r2) % M);
  const int axis = (int)(idx / ((long long)r2 * M));
  int found = -1;
  const int live = *count;
  if (live <= M && row < live) {  // nothing to find once a bounded table overflowed
    const unsigned int q1 = (unsigned int)row_h1[row] + (unsigned int)oh1[axis * r2 + tap];
    const unsigned int q2 = (unsigned int)row_h2[row] + (unsigned int)oh2[axis * r2 + tap];
    found = sgp_find(table, mask, row_of_slot, sgp_pack(q1, q2));
  }
  neighbors[idx] = found < 0 ? M : found;
}

__global__ void first_kernel(const int* __restrict__ slot_of, int N, int* first_of_slot) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < N) atomicMin(&first_of_slot[slot_of[i]], i);
}

__global__ void flag_kernel(const int* __restrict__ slot_of, const int* __restrict__ first_of_slot,
                            int N, int* __restrict__ flag) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < N) flag[i] = first_of_slot[slot_of[i]] == i ? 1 : 0;
}

__global__ void remap_kernel(const int* __restrict__ h1, const int* __restrict__ h2,
                             const int* __restrict__ slot_of, const int* __restrict__ flag,
                             const int* __restrict__ scan, int N, int* __restrict__ row_of_slot,
                             int* __restrict__ row_h1, int* __restrict__ row_h2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N || !flag[i]) return;
  const int id = scan[i] - 1;
  row_of_slot[slot_of[i]] = id;
  row_h1[id] = h1[i];
  row_h2[id] = h2[i];
}

// K11a step 2.  first_of_slot (one int per slot) must hold INT_MAX.
extern "C" int sgp_dedup_first(const int* slot_of, int N, int* first_of_slot, int* flag,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (N > 0) {
    first_kernel<<<sgp_blocks(N), SGP_THREADS, 0, st>>>(slot_of, N, first_of_slot);
    flag_kernel<<<sgp_blocks(N), SGP_THREADS, 0, st>>>(slot_of, first_of_slot, N, flag);
  }
  return (int)cudaGetLastError();
}

// K11a step 4.  scan is the inclusive prefix sum of flag.
extern "C" int sgp_dedup_remap(const int* h1, const int* h2, const int* slot_of, const int* flag,
                               const int* scan, int N, int* row_of_slot, int* row_h1, int* row_h2,
                               void* stream) {
  if (N > 0)
    remap_kernel<<<sgp_blocks(N), SGP_THREADS, 0, (cudaStream_t)stream>>>(
        h1, h2, slot_of, flag, scan, N, row_of_slot, row_h1, row_h2);
  return (int)cudaGetLastError();
}

// Row id of every contribution (sgp_dedup_finish's first pass).  Past the
// capacity every id is 0.
extern "C" int sgp_dedup_seg(const int* slot_of, const int* row_of_slot, int N, const int* count,
                             int capacity, int* seg_ids, void* stream) {
  if (N > 0)
    seg_kernel<<<sgp_blocks(N), SGP_THREADS, 0, (cudaStream_t)stream>>>(slot_of, row_of_slot, N,
                                                                        count, capacity, seg_ids);
  return (int)cudaGetLastError();
}

// capacity (1..N): the table's rows.  Below N the insert is the bounded
// one (sgp_insert<true>); at N it cannot overflow and skips the check.
extern "C" int sgp_dedup_insert(const int* h1, const int* h2, int N, unsigned long long* table,
                                int mask, int capacity, int* slot_of, int* row_of_slot,
                                int* count, int* row_h1, int* row_h2, void* stream) {
  if (N > 0) {
    if (capacity < N)
      insert_kernel<true><<<sgp_blocks(N), SGP_THREADS, 0, (cudaStream_t)stream>>>(
          h1, h2, N, table, (unsigned int)mask, capacity, slot_of, row_of_slot, count, row_h1,
          row_h2);
    else
      insert_kernel<false><<<sgp_blocks(N), SGP_THREADS, 0, (cudaStream_t)stream>>>(
          h1, h2, N, table, (unsigned int)mask, N, slot_of, row_of_slot, count, row_h1, row_h2);
  }
  return (int)cudaGetLastError();
}

// neighbors is (dp1, capacity, r2); capacity as for sgp_dedup_insert.
extern "C" int sgp_dedup_finish(const int* slot_of, const int* row_of_slot, int N,
                                const unsigned long long* table, int mask, int capacity,
                                const int* count, const int* row_h1, const int* row_h2,
                                const int* oh1, const int* oh2, int* seg_ids, int dp1, int r2,
                                int* neighbors, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (N > 0) {
    const int err = sgp_dedup_seg(slot_of, row_of_slot, N, count, capacity, seg_ids, stream);
    if (err != (int)cudaSuccess) return err;
    neighbors_kernel<<<sgp_blocks((long long)dp1 * capacity * r2), SGP_THREADS, 0, st>>>(
        table, (unsigned int)mask, row_of_slot, count, row_h1, row_h2, oh1, oh2, capacity, dp1,
        r2, neighbors);
  }
  return (int)cudaGetLastError();
}
