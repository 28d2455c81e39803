// K1 lattice_geometry: enclosing-simplex geometry of every point, reduced to
// the linear hash pair of each vertex key plus barycentric weights.
//
// Replaces simplex_gp_tpu/ops/lattice.py::lattice_simplex (:141) with
// _hash_pair (:207), i.e. _point_hashes (:330).
//
// Bound: per point O(d^2) integer/float work (the rank of d+1 differentials)
// and O(d^2) hash multiply-adds, against 4d bytes read and 12(d+1) written.
// At d=18 it is compute- and latency-bound, not memory-bound.  Design: one
// thread per point with the elevated, rank and barycentric arrays in local
// memory (d+1 <= SGP_MAX_DP1), so no point waits on another.  The
// elevation, rounding and ranks are sgp_simplex_rank (common.cuh), which
// K5's kernel (grad.cu) calls too.
//
// Every float operation is an explicit round-to-nearest intrinsic, in the
// order of the plain PyTorch twin (no FMA contraction): the elevation
// x @ E^T is summed sequentially over the input dimensions, exactly as the
// twin does, so kernel and twin agree bit for bit.  Against XLA's dot, whose
// summation order differs, a point lying within an ulp of a rounding or rank
// boundary can land in another simplex.  Hashes wrap mod 2^32 in uint32.
#include "common.cuh"

__global__ void geometry_kernel(const float* __restrict__ x, const float* __restrict__ E,
                                const int* __restrict__ a, int n, int d, float scale,
                                int* __restrict__ h1, int* __restrict__ h2,
                                float* __restrict__ w) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int dp1 = d + 1;
  int gdiv[SGP_MAX_DP1], rank[SGP_MAX_DP1];
  float elev[SGP_MAX_DP1];
  sgp_simplex_rank(x + (long long)p * d, E, d, scale, elev, gdiv, rank);

  // Barycentric coordinates by rank.
  float t_by_rank[SGP_MAX_DP1];
  for (int i = 0; i < dp1; ++i) t_by_rank[i] = 0.0f;
  for (int i = 0; i < dp1; ++i) {
    const float t = __fmul_rn(__fsub_rn(elev[i], (float)(gdiv[i] * dp1)), scale);
    if (rank[i] >= 0 && rank[i] <= d) t_by_rank[rank[i]] = t;
  }

  const unsigned int* a1 = reinterpret_cast<const unsigned int*>(a);
  const unsigned int* a2 = a1 + d;
  const long long base = (long long)p * dp1;
  for (int v = 0; v < dp1; ++v) {
    // Vertex v: key_k = greedy_k + canonical[v][rank_k], hashed linearly.
    unsigned int s1 = 0u, s2 = 0u;
    for (int k = 0; k < d; ++k) {
      const int can = rank[k] < dp1 - v ? v : v - dp1;
      const unsigned int key = (unsigned int)(gdiv[k] * dp1 + can);
      s1 += key * a1[k];
      s2 += key * a2[k];
    }
    h1[base + v] = (int)s1;
    h2[base + v] = (int)s2;
    w[base + v] = v == 0
        ? __fadd_rn(t_by_rank[d], __fadd_rn(1.0f, -t_by_rank[0]))
        : __fsub_rn(t_by_rank[d - v], t_by_rank[d + 1 - v]);
  }
}

extern "C" int sgp_lattice_geometry(const float* x, const float* E, const int* a, int n, int d,
                                    int* h1, int* h2, float* w, void* stream) {
  if (n > 0) {
    const float scale = (float)(1.0 / (double)(d + 1));
    geometry_kernel<<<sgp_blocks(n), SGP_THREADS, 0, (cudaStream_t)stream>>>(
        x, E, a, n, d, scale, h1, h2, w);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* sgp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
