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
// neighbours found by hashing), not JAX's sort chain.  It builds no
// neighbour array, which a one-shot filter would write once and read once
// (19 x 201,837 x 2 x 4 B = 31 MB at elevators).
//   1. insert: one thread per point elevates and ranks it and hashes its
//      d+1 vertices (sgp_point_geometry, common.cuh: K1's device code, so
//      the hashes are the plan's bit for bit), then inserts each packed key
//      into K2's open-addressing table (sgp_insert, common.cuh, with the
//      capacity bound).  The thread whose CAS claims an empty slot takes the
//      next dense row id from an atomic counter and records the row's hash
//      pair.
//   2. seg: K2's (dedup.cu), every contribution reads the row id of its slot.
//   3. splat: K3's (apply.cu), atomicAdd of w * v into the (capacity, c)
//      value table; it does nothing once the count is past the capacity.
//   4. blur: one launch per lattice axis, one thread per live row: it finds
//      its +-1..r neighbours by looking up (h1 + oh1, h2 + oh2) (sgp_find,
//      as K2's neighbour pass) -- hash
//      linearity makes that the neighbour key's hash -- and runs the
//      (2r+1)-tap stencil over its c columns; a missing neighbour counts as
//      zero.  Ping-pong between two value tables.
//   5. slice: K3's, with its capacity guard.
// The blur uses explicit round-to-nearest operations in the order of K3's,
// so given the same table it matches the plain version bit for bit; the
// splat's atomic order varies from run to run.
//
// Capacity.  The value table has `capacity` rows and the hash table is a
// power of two >= 2 * capacity slots.  When more than `capacity` points are
// occupied the counter passes the capacity: rows past it are not recorded,
// every thread stops probing at its next collision, a full table ends a
// probe sequence after one lap, every contribution is sent to row 0, the
// splat and the blur do nothing, and the slice writes NaN everywhere (JAX's guard,
// lattice.py:1295).  The counter then reports at least capacity + 1,
// not the true occupancy.  No loop runs longer than one lap of the table.
//
// Bound: random 8-byte probes into the hash table (4 MB at elevators, in
// the 50 MB L2; 512 MB at houseelectric, untrimmed, in device memory), d+1
// per point in the insert and 2r per live row and axis in the blur, plus
// the splat's atomics: latency-bound at c <= 16.  Indices into the value
// tables are 64-bit.
#include "common.cuh"

__global__ void once_insert_kernel(const float* __restrict__ x, const float* __restrict__ E,
                                   const int* __restrict__ a, int n, int d, float scale,
                                   unsigned long long* table, unsigned int mask, int capacity,
                                   int* row_of_slot, int* row_h1, int* row_h2, int* count,
                                   int* __restrict__ slot_of, float* __restrict__ w) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int dp1 = d + 1;
  unsigned int h1[SGP_MAX_DP1], h2[SGP_MAX_DP1];
  float wv[SGP_MAX_DP1];
  sgp_point_geometry(x + (long long)p * d, E, a, d, scale, h1, h2, wv);
  const long long base = (long long)p * dp1;
  for (int v = 0; v < dp1; ++v) {
    const int s = *(volatile int*)count > capacity
                      ? -1
                      : sgp_insert<true>(h1[v], h2[v], table, mask, capacity, row_of_slot,
                                         row_h1, row_h2, count);
    if (slot_of != nullptr) {
      slot_of[base + v] = s;
      w[base + v] = wv[v];
    }
  }
}

__global__ void once_blur_kernel(const float* __restrict__ in, float* __restrict__ out,
                                 const unsigned long long* __restrict__ table, unsigned int mask,
                                 const int* __restrict__ row_of_slot,
                                 const int* __restrict__ row_h1, const int* __restrict__ row_h2,
                                 const int* __restrict__ oh1, const int* __restrict__ oh2,
                                 const SgpTaps taps, int c, int order,
                                 const int* __restrict__ count, int capacity) {
  // oh1/oh2 point at this axis's 2r offset hashes.
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const int live = *count;
  if (live > capacity || row >= live) return;
  const int r2 = 2 * order;
  int nb[SGP_MAX_TAPS - 1];
  for (int t = 0; t < r2; ++t) {
    const unsigned int q1 = (unsigned int)row_h1[row] + (unsigned int)oh1[t];
    const unsigned int q2 = (unsigned int)row_h2[row] + (unsigned int)oh2[t];
    nb[t] = sgp_find(table, mask, row_of_slot, sgp_pack(q1, q2));
  }
  const long long base = (long long)row * c;
  for (int col = 0; col < c; ++col) {
    float acc = __fmul_rn(taps.v[order], in[base + col]);
    for (int t = 0; t < r2; ++t) {
      if (nb[t] >= 0)
        acc = __fadd_rn(acc, __fmul_rn(taps.v[t < order ? t : t + 1], in[(long long)nb[t] * c + col]));
    }
    out[base + col] = acc;
  }
}

// K2's seg pass (dedup.cu) and K3's splat and slice (apply.cu).
extern "C" int sgp_dedup_seg(const int* slot_of, const int* row_of_slot, int N, const int* count,
                             int capacity, int* seg_ids, void* stream);
extern "C" int sgp_lattice_splat(const int* seg, const float* w, const float* v, int n, int dp1,
                                 int c, float* table, const int* count, int capacity,
                                 void* stream);
extern "C" int sgp_lattice_slice(const float* table, const int* seg, const float* w, int n,
                                 int dp1, int c, float norm, float* out, const int* count,
                                 int capacity, void* stream);

// K4.  Buffers, all allocated by the caller:
//   table (mask+1) int64 filled with SGP_EMPTY; row_of_slot (mask+1) int32;
//   row_h1, row_h2 (capacity) int32; slot_of, seg (n(d+1)) int32;
//   w (n(d+1)) f32; count () int32 zeroed; ta (capacity, c) f32 zeroed;
//   tb (capacity, c) f32; out (n, c) f32.
// oh1/oh2 are the (d+1, 2r) offset hashes, taps_host 2r+1 host floats.
extern "C" int sgp_filter_once(const float* x, const float* E, const int* a, int n, int d,
                               const int* oh1, const int* oh2, const float* taps_host, int order,
                               const float* v, int c, float norm, int capacity, int mask,
                               unsigned long long* table, int* row_of_slot, int* row_h1,
                               int* row_h2, int* slot_of, int* seg, float* w, int* count,
                               float* ta, float* tb, float* out, void* stream) {
  if (d + 1 > SGP_MAX_DP1 || 2 * order + 1 > SGP_MAX_TAPS) return (int)cudaErrorInvalidValue;
  if (n <= 0 || c <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const int dp1 = d + 1;
  const int N = n * dp1;
  const float scale = (float)(1.0 / (double)dp1);
  SgpTaps taps = {};
  for (int t = 0; t < 2 * order + 1; ++t) taps.v[t] = taps_host[t];
  cudaError_t err;
#define SGP_CHECK() \
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err
  once_insert_kernel<<<sgp_blocks(n), SGP_THREADS, 0, st>>>(x, E, a, n, d, scale, table,
                                                            (unsigned int)mask, capacity,
                                                            row_of_slot, row_h1, row_h2, count,
                                                            slot_of, w);
  SGP_CHECK();
  if ((err = (cudaError_t)sgp_dedup_seg(slot_of, row_of_slot, N, count, capacity, seg, stream)) !=
      cudaSuccess)
    return (int)err;
  if ((err = (cudaError_t)sgp_lattice_splat(seg, w, v, n, dp1, c, ta, count, capacity, stream)) != cudaSuccess)
    return (int)err;
  const int r2 = 2 * order;
  for (int j = 0; j < dp1; ++j) {
    once_blur_kernel<<<sgp_blocks(capacity), SGP_THREADS, 0, st>>>(
        ta, tb, table, (unsigned int)mask, row_of_slot, row_h1, row_h2, oh1 + j * r2,
        oh2 + j * r2, taps, c, order, count, capacity);
    SGP_CHECK();
    float* t = ta;
    ta = tb;
    tb = t;
  }
  err = (cudaError_t)sgp_lattice_slice(ta, seg, w, n, dp1, c, norm, out, count, capacity, stream);
#undef SGP_CHECK
  return (int)err;
}

// ---- K8: occupancy only ----------------------------------------------------
//
// At houseelectric 24.6M vertex keys land on ~20k lattice points, so a key
// repeats >1,000 times.  K4's insert takes an atomicCAS for every key, even
// one already in its slot, and reads the counter before every insert and at
// every collision with an uncached load: the hot slots' CAS runs serialise
// in L2.  Here the insert reads the slot with a plain load first and stops
// on a hit; only an empty slot takes an atomicCAS.  A slot only ever goes
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
