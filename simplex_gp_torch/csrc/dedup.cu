// K2 lattice_dedup_neighbors: dedup the n(d+1) vertex hash pairs into
// lattice rows and find every row's 2r blur neighbours along each axis.
//
// Replaces simplex_gp_tpu/ops/lattice.py::_plan_tables (:387), i.e. the sort
// dedup plus the sort-join _pair_join (:253) of build_plan_join (:441).
//
// Bound: the N hash pairs read and the N seg ids written (12N bytes; 0.057
// ms at houseelectric's N = 15.7M on an H100), beside random 8-byte probes
// into a table of >= 2M slots (M = N untrimmed, the capacity bounded),
// which at these sizes sits in the 50 MB L2.  Design: the reference's own
// GPU hash table (permutohedral_cuda_kernel.cu:173-201) instead of the
// TPU's sorts, with the insert K8 (once.cu) proved on the card.  From one
// host call (sgp_dedup), on one workspace:
//   1. fill: the table emptied and the counter zeroed;
//   2. insert (insert_kernel, also K4's and K11a's): each contribution
//      loads its key's slot with a plain load first and stops on a hit;
//      only an empty slot takes an atomicCAS, which also accepts prev ==
//      key (a plain load may see EMPTY while another thread's CAS lands).
//      The thread whose CAS claims the slot takes the next dense row id
//      from an atomic counter and records the row's hash pair.  A slot
//      only ever goes from empty to one key, so a stale load can only be
//      an empty slot, which the CAS settles.  At houseelectric 15.7M
//      contributions land on ~20k points, ~790 a point: the first design
//      CASed every key, so the hot slots' CAS ran serialised in L2, and
//      read the counter with an uncached load in every thread;
//   3. seg: every contribution reads the row id of the slot it landed in;
//   4. neighbors: one thread per (axis, row, tap) over the M rows probes
//      (h1 + oh1[axis, tap], h2 + oh2[axis, tap]) -- hash linearity makes
//      that the neighbour key's hash -- and writes the row id, or M if the
//      neighbour is not occupied.  Rows past the live count write M, so
//      the grid needs no host read of the count.
// Row numbering follows the order in which threads win their CAS, so it
// varies from run to run; the count n_lattice and the operator do not, and
// nothing downstream reads the numbering: the row lists' splat sums each
// row in contribution order, the blur reads in tap order and the slice in
// vertex order (join_rows.cu).
//
// Bounded (a capacity below N, the training plan of a trimmed run; JAX's
// build_plan(capacity), lattice.py:857-892 and _chain_core :733): the hash
// table has >= 2 capacity slots and M = capacity rows; a thread stops at
// its next collision once the counter has passed the capacity (one
// uncached read of the counter per collision, none per hit), and one lap
// ends any probe sequence.  On that overflow every seg id is 0 (a valid
// row), the neighbour pass writes M everywhere, and the count is left past
// the capacity, which the applies' guard reads.
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
//   1. fill and insert as K2 (sgp_dedup_insert);
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

// The insert of K2, K4 and K11a: the N keys (h1, h2) into the table;
// slot_of[e] gets the key's slot, or -1 past the capacity.  kBounded:
// capacity < N (a table that may overflow).
template <bool kBounded>
__global__ void insert_kernel(const int* __restrict__ h1, const int* __restrict__ h2, int N,
                              unsigned long long* table, unsigned int mask, int capacity,
                              int* __restrict__ slot_of, int* row_of_slot, int* row_h1, int* row_h2,
                              int* count) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= N) return;
  const unsigned int k1 = (unsigned int)h1[e], k2 = (unsigned int)h2[e];
  const unsigned long long key = sgp_pack(k1, k2);
  unsigned int s = (unsigned int)sgp_mix(key) & mask;
  int found = -1;
  for (unsigned int probe = 0; probe <= mask; ++probe) {
    const unsigned long long cur = table[s];
    if (cur == key) {
      found = (int)s;
      break;
    }
    if (cur == SGP_EMPTY) {
      const unsigned long long prev = atomicCAS(&table[s], SGP_EMPTY, key);
      if (prev == SGP_EMPTY) {
        const int id = atomicAdd(count, 1);
        row_of_slot[s] = id < capacity ? id : -1;
        if (id < capacity) {
          row_h1[id] = (int)k1;
          row_h2[id] = (int)k2;
        }
        found = (int)s;
        break;
      }
      if (prev == key) {
        found = (int)s;
        break;
      }
    }
    // A collision.  One full lap means every slot is taken, so the count is
    // past the capacity (the table has at least 2 capacity slots).
    if (kBounded && *(volatile int*)count > capacity) break;
    s = (s + 1) & mask;
  }
  slot_of[e] = found;
}

__global__ void fill_kernel(unsigned long long* __restrict__ table, int slots) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s < slots) table[s] = SGP_EMPTY;
}

__global__ void fill_int_kernel(int* __restrict__ p, int n, int value) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) p[i] = value;
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

// K11a step 2.  first_of_slot: one int per slot, set to INT_MAX here.
extern "C" int sgp_dedup_first(const int* slot_of, int N, int* first_of_slot, int slots, int* flag,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  fill_int_kernel<<<sgp_blocks(slots), SGP_THREADS, 0, st>>>(first_of_slot, slots, 0x7fffffff);
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
static int dedup_seg(const int* slot_of, const int* row_of_slot, int N, const int* count, int capacity,
                     int* seg_ids, cudaStream_t st) {
  if (N > 0) seg_kernel<<<sgp_blocks(N), SGP_THREADS, 0, st>>>(slot_of, row_of_slot, N, count, capacity, seg_ids);
  return (int)cudaGetLastError();
}

// The table (mask+1 slots) emptied, the count zeroed, and the insert of the
// N keys.  capacity (1..N): the table's rows; below N the insert is the
// bounded one, at N it cannot overflow and skips the check.  row_of_slot
// holds mask+1 ints, row_h1 and row_h2 capacity each.
extern "C" int sgp_dedup_insert(const int* h1, const int* h2, int N, unsigned long long* table,
                                int mask, int capacity, int* slot_of, int* row_of_slot,
                                int* count, int* row_h1, int* row_h2, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int slots = mask + 1;
  fill_kernel<<<sgp_blocks(slots), SGP_THREADS, 0, st>>>(table, slots);
  const cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  if (N > 0) {
    if (capacity < N)
      insert_kernel<true><<<sgp_blocks(N), SGP_THREADS, 0, st>>>(
          h1, h2, N, table, (unsigned int)mask, capacity, slot_of, row_of_slot, row_h1, row_h2, count);
    else
      insert_kernel<false><<<sgp_blocks(N), SGP_THREADS, 0, st>>>(
          h1, h2, N, table, (unsigned int)mask, N, slot_of, row_of_slot, row_h1, row_h2, count);
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
    const int err = dedup_seg(slot_of, row_of_slot, N, count, capacity, seg_ids, st);
    if (err != (int)cudaSuccess) return err;
    neighbors_kernel<<<sgp_blocks((long long)dp1 * capacity * r2), SGP_THREADS, 0, st>>>(
        table, (unsigned int)mask, row_of_slot, count, row_h1, row_h2, oh1, oh2, capacity, dp1,
        r2, neighbors);
  }
  return (int)cudaGetLastError();
}

// K2's scratch, carved from one workspace (base null: only the size), each
// part 256-byte aligned: the table, each contribution's slot, each slot's
// row, each row's hash pair.
struct DedupWork {
  unsigned long long* table;
  int *slot_of, *row_of_slot, *row_h1, *row_h2;
};

static size_t dedup_carve(char* base, int N, int M, int slots, DedupWork& w) {
  size_t off = 0;
  auto take = [&](size_t bytes) -> char* {
    off = (off + 255) & ~(size_t)255;
    char* at = base == nullptr ? nullptr : base + off;
    off += bytes;
    return at;
  };
  w.table = (unsigned long long*)take(sizeof(unsigned long long) * (size_t)slots);
  w.slot_of = (int*)take(sizeof(int) * (size_t)N);
  w.row_of_slot = (int*)take(sizeof(int) * (size_t)slots);
  w.row_h1 = (int*)take(sizeof(int) * (size_t)M);
  w.row_h2 = (int*)take(sizeof(int) * (size_t)M);
  return off;
}

// The workspace bytes sgp_dedup takes: N contributions, M rows, a table of
// slots (a power of two >= 2M).
extern "C" int sgp_dedup_workspace(int N, int M, int slots, long long* bytes) {
  DedupWork w;
  *bytes = (long long)dedup_carve(nullptr, N, M, slots, w);
  return (int)cudaSuccess;
}

// K2 from one host call: fill, insert, seg ids and neighbours of the N
// hash pairs (h1, h2) over M rows (1..N; below N, bounded) with a table of
// mask+1 slots.  seg (N,), neighbors (dp1, M, r2) and count (one int) are
// the plan's; work holds work_bytes (sgp_dedup_workspace) and need not be
// zeroed.
extern "C" int sgp_dedup(const int* h1, const int* h2, int N, const int* oh1, const int* oh2, int dp1, int r2,
                         int M, int mask, int* seg, int* neighbors, int* count, void* work, long long work_bytes,
                         void* stream) {
  DedupWork w;
  if ((long long)dedup_carve(nullptr, N, M, mask + 1, w) > work_bytes) return (int)cudaErrorInvalidValue;
  dedup_carve((char*)work, N, M, mask + 1, w);
  const int err = sgp_dedup_insert(h1, h2, N, w.table, mask, M, w.slot_of, w.row_of_slot, count, w.row_h1,
                                   w.row_h2, stream);
  if (err != (int)cudaSuccess) return err;
  return sgp_dedup_finish(w.slot_of, w.row_of_slot, N, w.table, mask, M, count, w.row_h1, w.row_h2, oh1, oh2,
                          seg, dp1, r2, neighbors, stream);
}
