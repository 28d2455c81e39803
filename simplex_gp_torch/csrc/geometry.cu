// K1 lattice_geometry: enclosing-simplex geometry of every point, reduced to
// the linear hash pair of each vertex key plus barycentric weights.
//
// Replaces simplex_gp_tpu/ops/lattice.py::lattice_simplex (:141) with
// _hash_pair (:207), i.e. _point_hashes (:330), and, when asked for the
// coordinate sums, _geometry_hs (:353).
//
// Bound: per point O(d^2) integer/float work (the rank of d+1 differentials)
// and O(d^2) hash multiply-adds, against 4d bytes read and 12(d+1) written.
// At d=18 it is compute- and latency-bound, not memory-bound.  Design: one
// thread per point with the elevated, rank and barycentric arrays in local
// memory (d+1 <= SGP_MAX_DP1), so no point waits on another.  The
// per-point work is sgp_point_geometry (common.cuh), which K4/K8 (once.cu)
// call too; its elevation, rounding and ranks are sgp_simplex_rank, which
// K5's kernel (grad.cu) calls.
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
                                float* __restrict__ w, int* __restrict__ s) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int dp1 = d + 1;
  unsigned int s1[SGP_MAX_DP1], s2[SGP_MAX_DP1];
  float wv[SGP_MAX_DP1];
  int ks[SGP_MAX_DP1];
  sgp_point_geometry(x + (long long)p * d, E, a, d, scale, s1, s2, wv, s == nullptr ? nullptr : ks);
  const long long base = (long long)p * dp1;
  for (int v = 0; v < dp1; ++v) {
    h1[base + v] = (int)s1[v];
    h2[base + v] = (int)s2[v];
    w[base + v] = wv[v];
    if (s != nullptr) s[base + v] = ks[v];
  }
}

// s (nullable): the coordinate sum of each vertex key, for the chain plan
// (JAX's _geometry_hs, lattice.py:353-384).
extern "C" int sgp_lattice_geometry(const float* x, const float* E, const int* a, int n, int d,
                                    int* h1, int* h2, float* w, int* s, void* stream) {
  if (n > 0) {
    const float scale = (float)(1.0 / (double)(d + 1));
    geometry_kernel<<<sgp_blocks(n), SGP_THREADS, 0, (cudaStream_t)stream>>>(
        x, E, a, n, d, scale, h1, h2, w, s);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* sgp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
