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
