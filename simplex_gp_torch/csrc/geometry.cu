// K1 lattice_geometry: enclosing-simplex geometry of every point, reduced to
// the linear hash pair of each vertex key plus barycentric weights.
//
// Replaces simplex_gp_tpu/ops/lattice.py::lattice_simplex (:141) with
// _hash_pair (:207), i.e. _point_hashes (:330), and, when asked for the
// coordinate sums, _geometry_hs (:353).
//
// Bound: per point O(d^2) integer/float work (the rank of d+1 differentials)
// and O(d^2) hash multiply-adds, against 4d bytes read and 12(d+1) written.
// At d=18 it is compute- and latency-bound, not memory-bound.  Design: a
// team of T lanes a point, several teams a warp (T = 4 up to d+1 = 32, else
// 8), as K5's kernel (grad.cu) runs its points.  A team's per-point arrays
// (differentials, repaired rounded coordinates, ranks, barycentric
// coordinates by rank) are d+1 words of shared memory, and E, the hash
// multipliers and the block's rows of x are in shared memory for the block.
// Coordinate i is lane i mod T's: it elevates it (sgp_elevate's sequential
// sum over the d inputs), rounds it, ranks it against every differential and
// repairs the rank.  Vertex v is lane v mod T's: it forms the key sums and
// the two hashes over k in order (each k's rank and rounded coordinate read
// once for all its vertices) and the weight.  The block's outputs are staged
// in shared memory and stored together, so the stores of h1, h2, w and s
// are coalesced, not d+1 words apart across a warp.  The first kernel
// (geometry_kernel below, kept as the team kernel's yardstick) ran a thread
// a point through sgp_point_geometry (common.cuh), with its d+1-long arrays
// in local memory; K4 and K8 (once.cu) still call that per-point code.
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

// A team of T lanes a point, THREADS / T points a block; MAXDP bounds d+1.
template <int T, int MAXDP, int THREADS>
__global__ void __launch_bounds__(THREADS)
    geometry_team_kernel(const float* __restrict__ x, const float* __restrict__ E, const int* __restrict__ a, int n,
                         int d, float scale, int* __restrict__ h1, int* __restrict__ h2, float* __restrict__ w,
                         int* __restrict__ s) {
  constexpr int TEAMS = THREADS / T;
  constexpr int PER = (MAXDP + T - 1) / T;  // coordinates (and vertices) a lane holds
  constexpr int W = MAXDP + 1;              // a team's row of words: odd, so the teams of a warp use other banks
  __shared__ float sh_E[MAXDP * (MAXDP - 1)];
  __shared__ unsigned int sh_a[2 * (MAXDP - 1)];
  __shared__ float sh_x[TEAMS * MAXDP];
  __shared__ float sh_diff[TEAMS * W], sh_t[TEAMS * W];
  __shared__ int sh_g[TEAMS * W], sh_rank[TEAMS * W];
  __shared__ int sh_h1[TEAMS * MAXDP], sh_h2[TEAMS * MAXDP], sh_s[TEAMS * MAXDP];
  __shared__ float sh_w[TEAMS * MAXDP];
  const unsigned int full = 0xffffffffu;
  const int dp1 = d + 1, xs = d | 1;  // xs: a point's row of x in sh_x, odd for the same reason
  const float fdp1 = (float)dp1;
  const long long p0 = (long long)blockIdx.x * TEAMS;
  const int npts = (int)min((long long)TEAMS, n - p0);
  for (int e = threadIdx.x; e < dp1 * d; e += THREADS) sh_E[e] = E[e];
  for (int e = threadIdx.x; e < 2 * d; e += THREADS) sh_a[e] = (unsigned int)a[e];
  for (int e = threadIdx.x; e < npts * d; e += THREADS) {
    const int q = e / d;
    sh_x[q * xs + e - q * d] = x[p0 * d + e];
  }
  __syncthreads();
  const int lane = threadIdx.x % T, team = threadIdx.x / T;
  // A team past the block's last point runs the last point's shuffles and writes nothing.
  const bool valid = team < npts;
  const float* xp = sh_x + (valid ? team : npts - 1) * xs;
  float* diff = sh_diff + team * W;
  float* bary = sh_t + team * W;  // barycentric coordinates by rank
  int* gd = sh_g + team * W;
  int* rank = sh_rank + team * W;

  // The point's simplex: coordinate i on lane i mod T (sgp_simplex_rank's steps, common.cuh).
  float elev[PER];
  int g0[PER];
  int csum = 0;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int i = lane + q * T;
    if (i < dp1) {
      elev[q] = sgp_elevate(xp, sh_E, d, i);
      g0[q] = sgp_round_div(elev[q], scale, fdp1);
      csum += g0[q];
      diff[i] = __fsub_rn(elev[q], __fmul_rn((float)g0[q], fdp1));
      bary[i] = 0.0f;
    }
  }
#pragma unroll
  for (int off = T / 2; off > 0; off >>= 1) csum += __shfl_xor_sync(full, csum, off, T);
  __syncwarp();
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int i = lane + q * T;
    if (i < dp1) {
      const float di = diff[i];
      int r = 0;
      for (int j = 0; j < dp1; ++j) r += sgp_ranks_before(diff[j], j, di, i);
      int fix;
      const int rk = sgp_repair_rank(r, csum, d, &fix);
      const int g = g0[q] + fix;
      rank[i] = rk;
      gd[i] = g;
      // sgp_point_geometry's t_by_rank.
      if (rk >= 0 && rk <= d) bary[rk] = __fmul_rn(__fsub_rn(elev[q], (float)(g * dp1)), scale);
    }
  }
  __syncwarp();

  // Vertex v on lane v mod T: key_k = gd[k] (d+1) + canonical[v][rank_k], hashed over k in order.
  unsigned int s1[PER], s2[PER];
  int ks[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    s1[q] = 0u;
    s2[q] = 0u;
    ks[q] = 0;
  }
  for (int k = 0; k < d; ++k) {
    const int rk = rank[k], base = gd[k] * dp1;
    const unsigned int a1 = sh_a[k], a2 = sh_a[d + k];
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int v = lane + q * T;
      const int key = base + (rk < dp1 - v ? v : v - dp1);
      ks[q] += key;
      s1[q] += (unsigned int)key * a1;
      s2[q] += (unsigned int)key * a2;
    }
  }
  if (valid) {
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int v = lane + q * T;
      if (v < dp1) {
        const int o = team * dp1 + v;
        sh_h1[o] = (int)s1[q];
        sh_h2[o] = (int)s2[q];
        sh_s[o] = ks[q];
        sh_w[o] = v == 0 ? __fadd_rn(bary[d], __fadd_rn(1.0f, -bary[0])) : __fsub_rn(bary[d - v], bary[d + 1 - v]);
      }
    }
  }
  __syncthreads();
  const long long base = p0 * dp1;
  for (int e = threadIdx.x; e < npts * dp1; e += THREADS) {
    h1[base + e] = sh_h1[e];
    h2[base + e] = sh_h2[e];
    w[base + e] = sh_w[e];
    if (s != nullptr) s[base + e] = sh_s[e];
  }
}

template <int T, int MAXDP, int THREADS>
static void launch_team(const float* x, const float* E, const int* a, int n, int d, float scale, int* h1, int* h2,
                        float* w, int* s, cudaStream_t st) {
  constexpr int TEAMS = THREADS / T;
  const unsigned int blocks = (unsigned int)((n + TEAMS - 1) / TEAMS);
  geometry_team_kernel<T, MAXDP, THREADS><<<blocks, THREADS, 0, st>>>(x, E, a, n, d, scale, h1, h2, w, s);
}

// s (nullable): the coordinate sum of each vertex key, for the chain plan
// (JAX's _geometry_hs, lattice.py:353-384).  per_thread: the first kernel, a
// thread a point (the team kernel's yardstick).
extern "C" int sgp_lattice_geometry(const float* x, const float* E, const int* a, int n, int d,
                                    int* h1, int* h2, float* w, int* s, int per_thread, void* stream) {
  if (d < 1 || d + 1 > SGP_MAX_DP1) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const float scale = (float)(1.0 / (double)(d + 1));
    cudaStream_t st = (cudaStream_t)stream;
    if (per_thread)
      geometry_kernel<<<sgp_blocks(n), SGP_THREADS, 0, st>>>(x, E, a, n, d, scale, h1, h2, w, s);
    else if (d + 1 <= 16)
      launch_team<4, 16, 128>(x, E, a, n, d, scale, h1, h2, w, s, st);
    else if (d + 1 <= 32)
      launch_team<4, 32, 128>(x, E, a, n, d, scale, h1, h2, w, s, st);
    else
      launch_team<8, SGP_MAX_DP1, 64>(x, E, a, n, d, scale, h1, h2, w, s, st);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* sgp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
