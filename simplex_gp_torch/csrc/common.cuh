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

// Key of a lattice point: its hash pair (h1, h2) packed into 64 bits.
__device__ __forceinline__ unsigned long long sgp_pack(unsigned int h1, unsigned int h2) {
  return ((unsigned long long)h1 << 32) | (unsigned long long)h2;
}

// Empty slot of the dedup hash table.  Every hash multiplier is odd
// (_hash_vectors ORs in 1), so h = sum a_i k_i has the parity of sum k_i in
// BOTH words: a live key or query always has h1 and h2 of equal parity.
// This sentinel has h1 odd and h2 even, so no live key can equal it.
#define SGP_EMPTY 0xFFFFFFFFFFFFFFFEULL

// Enclosing simplex of one point, shared by K1 (geometry.cu) and K5
// (grad.cu) so that both find the same ranks bit for bit.  Elevates the d
// coordinates at xp through E ((d+1) x d, row-major) with a sequential,
// unfused sum; rounds to the nearest remainder-0 lattice point (strict <
// picks "down" on a tie); ranks the differentials (ties to the lower
// index); and applies the off-hyperplane repair.  Writes elev, gdiv (the
// rounded coordinate / (d+1)) and rank, each d+1 long.  Every float
// operation is an explicit round-to-nearest intrinsic in the order of the
// plain PyTorch version (simplex_gp_torch/kernels/lattice.py).
__device__ __forceinline__ void sgp_simplex_rank(const float* __restrict__ xp,
                                                 const float* __restrict__ E, int d, float scale,
                                                 float* elev, int* gdiv, int* rank) {
  const int dp1 = d + 1;
  const float fdp1 = (float)dp1;
  for (int i = 0; i < dp1; ++i) {
    float acc = __fmul_rn(xp[0], E[i * d]);
    for (int k = 1; k < d; ++k) acc = __fadd_rn(acc, __fmul_rn(xp[k], E[i * d + k]));
    elev[i] = acc;
  }
  int csum = 0;
  for (int i = 0; i < dp1; ++i) {
    const float v = __fmul_rn(elev[i], scale);
    const float up = ceilf(v), down = floorf(v);
    const bool pick_up =
        __fsub_rn(__fmul_rn(up, fdp1), elev[i]) < __fsub_rn(elev[i], __fmul_rn(down, fdp1));
    gdiv[i] = (int)(pick_up ? up : down);
    csum += gdiv[i];
  }
  float diff[SGP_MAX_DP1];
  for (int i = 0; i < dp1; ++i) diff[i] = __fsub_rn(elev[i], __fmul_rn((float)gdiv[i], fdp1));
  for (int i = 0; i < dp1; ++i) {
    int r = 0;
    for (int j = 0; j < dp1; ++j) r += (diff[j] > diff[i]) || (diff[j] == diff[i] && j < i);
    const int r2 = r + csum;
    const int hi = r2 > d, lo = r2 < 0;
    gdiv[i] += lo - hi;
    rank[i] = r2 - dp1 * hi + dp1 * lo;
  }
}
