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
// The table's insert and lookup are common.cuh's sgp_insert and sgp_find,
// shared with K4 and K8 (once.cu).
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
#include "common.cuh"

__global__ void insert_kernel(const int* __restrict__ h1, const int* __restrict__ h2, int N,
                              unsigned long long* table, unsigned int mask,
                              int* __restrict__ slot_of, int* row_of_slot, int* count,
                              int* row_h1, int* row_h2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < N)
    slot_of[i] = sgp_insert<false>((unsigned int)h1[i], (unsigned int)h2[i], table, mask, N,
                                   row_of_slot, row_h1, row_h2, count);
}

__global__ void seg_kernel(const int* __restrict__ slot_of, const int* __restrict__ row_of_slot,
                           int N, const int* __restrict__ count, int capacity,
                           int* __restrict__ seg_ids) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  // Past the capacity (K4 only) every row id is replaced by 0, a valid row,
  // so no later phase reads out of bounds; K4's guard then writes NaN.
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
  if (row < *count) {
    const unsigned int q1 = (unsigned int)row_h1[row] + (unsigned int)oh1[axis * r2 + tap];
    const unsigned int q2 = (unsigned int)row_h2[row] + (unsigned int)oh2[axis * r2 + tap];
    found = sgp_find(table, mask, row_of_slot, sgp_pack(q1, q2));
  }
  neighbors[idx] = found < 0 ? M : found;
}

// Row id of every contribution; shared with K4 (once.cu), whose capacity
// may be short.  K2 passes capacity = N.
extern "C" int sgp_dedup_seg(const int* slot_of, const int* row_of_slot, int N, const int* count,
                             int capacity, int* seg_ids, void* stream) {
  if (N > 0)
    seg_kernel<<<sgp_blocks(N), SGP_THREADS, 0, (cudaStream_t)stream>>>(slot_of, row_of_slot, N,
                                                                        count, capacity, seg_ids);
  return (int)cudaGetLastError();
}

extern "C" int sgp_dedup_insert(const int* h1, const int* h2, int N, unsigned long long* table,
                                int mask, int* slot_of, int* row_of_slot, int* count,
                                int* row_h1, int* row_h2, void* stream) {
  if (N > 0) {
    insert_kernel<<<sgp_blocks(N), SGP_THREADS, 0, (cudaStream_t)stream>>>(
        h1, h2, N, table, (unsigned int)mask, slot_of, row_of_slot, count, row_h1, row_h2);
  }
  return (int)cudaGetLastError();
}

extern "C" int sgp_dedup_finish(const int* slot_of, const int* row_of_slot, int N,
                                const unsigned long long* table, int mask, const int* count,
                                const int* row_h1, const int* row_h2, const int* oh1,
                                const int* oh2, int* seg_ids, int dp1, int r2, int* neighbors,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (N > 0) {
    const int err = sgp_dedup_seg(slot_of, row_of_slot, N, count, N, seg_ids, stream);
    if (err != (int)cudaSuccess) return err;
    neighbors_kernel<<<sgp_blocks((long long)dp1 * N * r2), SGP_THREADS, 0, st>>>(
        table, (unsigned int)mask, row_of_slot, count, row_h1, row_h2, oh1, oh2, N, dp1, r2,
        neighbors);
  }
  return (int)cudaGetLastError();
}
