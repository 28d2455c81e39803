// Shared helpers of the simplex_gp_torch kernels (plain C interface, ctypes).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define SGP_THREADS 256
// Largest lattice dimension d+1 the per-thread geometry arrays hold.
#define SGP_MAX_DP1 64

static inline unsigned int sgp_blocks(long long work) {
  return (unsigned int)((work + SGP_THREADS - 1) / SGP_THREADS);
}

// The 2r+1 filter taps, passed to a kernel by value (no device buffer, no
// copy); order r <= 7.
#define SGP_MAX_TAPS 15
struct SgpTaps {
  float v[SGP_MAX_TAPS];
};

// taps_host: 2*order+1 floats in host memory, copied into a launch's argument.
static inline SgpTaps sgp_taps(const float* taps_host, int order) {
  SgpTaps taps = {};
  for (int t = 0; t < 2 * order + 1; ++t) taps.v[t] = taps_host[t];
  return taps;
}

// Key of a lattice point: its hash pair (h1, h2) packed into 64 bits.
__device__ __forceinline__ unsigned long long sgp_pack(unsigned int h1, unsigned int h2) {
  return ((unsigned long long)h1 << 32) | (unsigned long long)h2;
}

__device__ __forceinline__ unsigned long long sgp_mix(unsigned long long z) {
  // splitmix64 finalizer: spreads the linear hash over the slot bits of the
  // open-addressing table (dedup.cu's insert, sgp_find below).
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

// Empty slot of the dedup hash table.  Every hash multiplier is odd
// (_hash_vectors ORs in 1), so h = sum a_i k_i has the parity of sum k_i in
// BOTH words: a live key or query always has h1 and h2 of equal parity.
// This sentinel has h1 odd and h2 even, so no live key can equal it.
#define SGP_EMPTY 0xFFFFFFFFFFFFFFFEULL

// The open-addressing table of lattice points: mask+1 slots (a power of
// two) of packed keys, linear probing from sgp_mix(key).  K2, K4 and K11a
// fill it with dedup.cu's insert (sgp_dedup_insert): the thread whose
// atomicCAS claims an empty slot takes the next dense row id from a
// counter, row_of_slot maps a slot to its row (-1 past the capacity) and
// row_h1/row_h2 hold each row's hash pair.  K8 (once.cu) counts the keys
// of a table of the same layout with its own insert (count_claim).

// Row id of the key q in a table that dedup.cu's insert filled, or -1 if q is
// absent.  Read-only; at most one lap.
__device__ __forceinline__ int sgp_find(const unsigned long long* __restrict__ table,
                                        unsigned int mask, const int* __restrict__ row_of_slot,
                                        unsigned long long q) {
  unsigned int s = (unsigned int)sgp_mix(q) & mask;
  for (unsigned int probe = 0; probe <= mask; ++probe) {
    const unsigned long long k = table[s];
    if (k == q) return row_of_slot[s];
    if (k == SGP_EMPTY) return -1;
    s = (s + 1) & mask;
  }
  return -1;
}

// Enclosing simplex of one point, shared by K1 (geometry.cu) and K5
// (grad.cu) so that both find the same ranks bit for bit.  Elevates the d
// coordinates at xp through E ((d+1) x d, row-major) with a sequential,
// unfused sum; rounds to the nearest remainder-0 lattice point (strict <
// picks "down" on a tie); ranks the differentials (ties to the lower
// index); and applies the off-hyperplane repair.  Writes elev, gdiv (the
// rounded coordinate / (d+1)) and rank, each d+1 long.  Every float
// operation is an explicit round-to-nearest intrinsic in the order of the
// plain PyTorch version (simplex_gp_torch/kernels/lattice.py).  K5 runs the
// same per-coordinate steps, one coordinate a lane.
__device__ __forceinline__ float sgp_elevate(const float* __restrict__ xp, const float* __restrict__ E, int d,
                                             int i) {
  float acc = __fmul_rn(xp[0], E[i * d]);
  for (int k = 1; k < d; ++k) acc = __fadd_rn(acc, __fmul_rn(xp[k], E[i * d + k]));
  return acc;
}

__device__ __forceinline__ int sgp_round_div(float elev, float scale, float fdp1) {
  const float v = __fmul_rn(elev, scale);
  const float up = ceilf(v), down = floorf(v);
  const bool pick_up = __fsub_rn(__fmul_rn(up, fdp1), elev) < __fsub_rn(elev, __fmul_rn(down, fdp1));
  return (int)(pick_up ? up : down);
}

// Whether coordinate j's differential ranks before coordinate i's.
__device__ __forceinline__ int sgp_ranks_before(float dj, int j, float di, int i) {
  return (dj > di) || (dj == di && j < i);
}

// The repaired rank of a coordinate of raw rank r; *fix (may be null) gets
// the change of its rounded coordinate / (d+1).
__device__ __forceinline__ int sgp_repair_rank(int r, int csum, int d, int* fix) {
  const int r2 = r + csum;
  const int hi = r2 > d, lo = r2 < 0;
  if (fix != nullptr) *fix = lo - hi;
  return r2 - (d + 1) * hi + (d + 1) * lo;
}

__device__ __forceinline__ void sgp_simplex_rank(const float* __restrict__ xp,
                                                 const float* __restrict__ E, int d, float scale,
                                                 float* elev, int* gdiv, int* rank) {
  const int dp1 = d + 1;
  const float fdp1 = (float)dp1;
  for (int i = 0; i < dp1; ++i) elev[i] = sgp_elevate(xp, E, d, i);
  int csum = 0;
  for (int i = 0; i < dp1; ++i) {
    gdiv[i] = sgp_round_div(elev[i], scale, fdp1);
    csum += gdiv[i];
  }
  float diff[SGP_MAX_DP1];
  for (int i = 0; i < dp1; ++i) diff[i] = __fsub_rn(elev[i], __fmul_rn((float)gdiv[i], fdp1));
  for (int i = 0; i < dp1; ++i) {
    int r = 0;
    for (int j = 0; j < dp1; ++j) r += sgp_ranks_before(diff[j], j, diff[i], i);
    int fix;
    rank[i] = sgp_repair_rank(r, csum, d, &fix);
    gdiv[i] += fix;
  }
}

// Vertex hash pairs and barycentric weights of one point's enclosing
// simplex: K1's per-point work, shared with K8 (once.cu) so that its
// hashes are the plan's bit for bit.  a is the (2, d) multiplier table;
// h1, h2 and w receive d+1 entries each, and ssum, when not null, the sum
// of each vertex key's d stored coordinates (the chain plan's s, K3').
// Vertex v has key_k = greedy_k + canonical[v][rank_k], hashed linearly
// (wrapping mod 2^32).
__device__ __forceinline__ void sgp_point_geometry(const float* __restrict__ xp,
                                                   const float* __restrict__ E,
                                                   const int* __restrict__ a, int d, float scale,
                                                   unsigned int* h1, unsigned int* h2, float* w,
                                                   int* ssum = nullptr) {
  const int dp1 = d + 1;
  int gdiv[SGP_MAX_DP1], rank[SGP_MAX_DP1];
  float elev[SGP_MAX_DP1];
  sgp_simplex_rank(xp, E, d, scale, elev, gdiv, rank);

  // Barycentric coordinates by rank.
  float t_by_rank[SGP_MAX_DP1];
  for (int i = 0; i < dp1; ++i) t_by_rank[i] = 0.0f;
  for (int i = 0; i < dp1; ++i) {
    const float t = __fmul_rn(__fsub_rn(elev[i], (float)(gdiv[i] * dp1)), scale);
    if (rank[i] >= 0 && rank[i] <= d) t_by_rank[rank[i]] = t;
  }

  const unsigned int* a1 = reinterpret_cast<const unsigned int*>(a);
  const unsigned int* a2 = a1 + d;
  for (int v = 0; v < dp1; ++v) {
    unsigned int s1 = 0u, s2 = 0u;
    int ks = 0;
    for (int k = 0; k < d; ++k) {
      const int can = rank[k] < dp1 - v ? v : v - dp1;
      const int key = gdiv[k] * dp1 + can;
      ks += key;
      s1 += (unsigned int)key * a1[k];
      s2 += (unsigned int)key * a2[k];
    }
    h1[v] = s1;
    h2[v] = s2;
    if (ssum != nullptr) ssum[v] = ks;
    w[v] = v == 0 ? __fadd_rn(t_by_rank[d], __fadd_rn(1.0f, -t_by_rank[0]))
                  : __fsub_rn(t_by_rank[d - v], t_by_rank[d + 1 - v]);
  }
}

// Resident blocks of `threads` threads (and `smem` bytes of dynamic shared
// memory) of `kernel` on the current card: the grid of a kernel that waits
// at sgp_grid_barrier, whose blocks must all be resident at once.  Cached
// for the last kernel and shape asked; the occupancy query is a host call, no stream work.
template <typename Kernel>
static inline int sgp_coresident_blocks(Kernel kernel, int threads, size_t smem) {
  static const void* cached_fn = nullptr;
  static int cached = 0, cached_threads = 0;
  static size_t cached_smem = 0;
  if (cached_fn != (const void*)kernel || cached_threads != threads || cached_smem != smem) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    cached = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
    cached_fn = (const void*)kernel;
    cached_threads = threads;
    cached_smem = smem;
  }
  return cached;
}

// Release and acquire at the scope of the whole card: a release add (all
// this thread's earlier writes, and by cumulativity those it has seen, such
// as its block's after a bar.sync, are visible before the add) and an
// acquire load (later reads see what the releasing threads saw).
__device__ __forceinline__ void sgp_red_release(unsigned int* p, unsigned int v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned int sgp_ld_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// A barrier across the whole grid of a kernel launched with at most
// sgp_coresident_blocks blocks (so every block is resident and none waits
// for a block that cannot start).  *count starts at 0 for the launch; the
// b-th barrier (b = 1, 2, ...) waits for count = b * gridDim.x.  No
// cooperative launch, so a CUDA graph captures it like any launch: bar.sync,
// thread 0's release add (cumulative: it publishes the whole block's
// writes), its acquire spin on the counter in L2, bar.sync (the pattern of
// CUTLASS's GenericBarrier).  Data written before the barrier by other
// blocks must be read through L2 (__ldcg), never through the non-coherent
// read-only path (__ldg, or a const __restrict__ pointer the compiler may
// turn into one).  Two such kernels must not run at once on two streams:
// each could hold SMs the other's waiting blocks need.
__device__ __forceinline__ void sgp_grid_barrier(unsigned int* count, unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    sgp_red_release(count, 1u);
    while (sgp_ld_acquire(count) < target) {
    }
  }
  __syncthreads();
}
