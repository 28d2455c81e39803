// K5 lattice_filter_grad: the position gradient of the lattice filter,
// grad_ref = d<g, SN * S^T B S v> / d ref, for positions ref (n, d).
//
// Replaces the reverse-mode autodiff that JAX runs through the filter in
// simplex_gp_tpu/ops/filter.py::lattice_filter_exact_grad (:143) -- the
// backward of K3/K4 with respect to the positions.  Its other half, the
// gradient in the values (SN * S^T B^T S g), is the transposed apply; it
// also gives this kernel table_b = B^T S g.
//
// Per point i, with seg_ik its d+1 lattice rows and table_f = B S v the
// forward's blurred table:
//   gw[k]  = SN * (g_i . table_f[seg_ik] + v_i . table_b[seg_ik])   (weights)
//   w[k]   = t_(d-k) - t_(d+1-k) for k >= 1, w[0] = 1 + t_d - t_0, with t_r
//            the scaled differential of rank r, so
//   dt_r   = gw[d-r] - gw[(d+1-r) mod (d+1)]
//   de_j   = scale * dt_(rank_j)                       (elevated coordinate j)
//   grad_i = sum_j de_j E[j, :]                        (elevation x @ E^T)
// Ranks come from the per-coordinate steps of sgp_simplex_rank (common.cuh),
// the device code K1 runs, so they agree with the plan bit for bit;
// rounding, ranks and keys are piecewise constant and carry no gradient, as
// in JAX.
//
// Bound: bytes.  Per point its d+1 seg ids, its rows of ref, v and g and of
// the output once (houseelectric: 1,311,539 points, d = 11, c = 11: ~225
// bytes a point, ~0.09 ms).  The 2(d+1) table rows a point reads are few
// (a trimmed table of ~20k live rows, 1.4 MB a table) but are read from L2
// point by point: 24 rows of 44 bytes, ~2 GB of L2 reads at houseelectric.
// The first kernel ran a thread per point, its rows' loads strided by c
// and its arrays in local memory: 1.98 ms there.
// Design: a team of T lanes a point, 8 teams a warp (T = 4 for c <= 16,
// each lane's columns of v and g in registers; else 8).  A team's per-point
// arrays (differentials, then gw; ranks, then de) are d+1 words of shared
// memory, and E is in shared memory for the block.  Coordinate i is lane
// i mod T's: it elevates and rounds it, and ranks it against every
// differential.  For each vertex k the team reads the row's c columns of
// both tables together, lane l columns l, l+T, ... in order, and a fixed xor
// butterfly over the team adds the lanes: no atomics.  Four vertices go at a
// time, their loads in flight together.  Then lane j mod T finds de_j from
// gw[d-r] and gw[d+1-r], and output coordinate k (lane k mod T) sums de_j
// E[j, k] over j in order.  The plain twin
// (kernels/lattice.py::lattice_filter_grad_plain) adds in the same order,
// so the two agree bit for bit.  Teams of 16 and 32 lanes (c-lane teams)
// measured slower, 1.05 and 2.2 ms at houseelectric c = 11: every lane
// walks the d+1 vertices, so the work a point grows with its lanes.
#include "common.cuh"

#define GRAD_THREADS 128

// A team of T lanes a point; MAXDP bounds d+1 (the shared arrays' size);
// CPL > 0: each lane holds its (at most CPL) columns of v and g in
// registers, c <= CPL T; CPL = 0: any c, the columns read in a loop.
template <int T, int MAXDP, int CPL>
__global__ void __launch_bounds__(GRAD_THREADS)
    filter_grad_kernel(const float* __restrict__ ref, const float* __restrict__ E, const int* __restrict__ seg,
                       const float* __restrict__ v, const float* __restrict__ g, const float* __restrict__ table_f,
                       const float* __restrict__ table_b, int n, int d, int c, float scale, float norm,
                       float* __restrict__ grad_ref) {
  constexpr int TEAMS = GRAD_THREADS / T;
  constexpr int U = 4;  // vertices whose rows load together
  __shared__ float sh_E[MAXDP * (MAXDP - 1)];
  // Padded a word, so that the teams of a warp read different banks (not on the wide path, which would
  // pass the 48 KB of static shared memory).
  constexpr int PAD = MAXDP < SGP_MAX_DP1 ? 1 : 0;
  __shared__ float sh_a[TEAMS][MAXDP + PAD];  // the differentials, then the weight gradients gw
  __shared__ float sh_b[TEAMS][MAXDP + PAD];  // the ranks (as ints), then the coordinate gradients de
  const unsigned int full = 0xffffffffu;
  const int dp1 = d + 1;
  for (int k = threadIdx.x; k < dp1 * d; k += GRAD_THREADS) sh_E[k] = E[k];
  __syncthreads();
  const int lane = threadIdx.x % T, team = threadIdx.x / T;
  const long long p = (long long)blockIdx.x * TEAMS + team;
  // A team past the last point runs the last point's shuffles and writes nothing.
  const bool valid = p < n;
  const long long pc = valid ? p : n - 1;
  const float fdp1 = (float)dp1;
  float* a = sh_a[team];
  int* rank = reinterpret_cast<int*>(sh_b[team]);
  float* de = sh_b[team];

  // The point's simplex: coordinate i on lane i mod T (sgp_simplex_rank's steps, common.cuh).
  const float* xp = ref + pc * d;
  int csum = 0;
  for (int i = lane; i < dp1; i += T) {
    const float elev = sgp_elevate(xp, sh_E, d, i);
    const int gd = sgp_round_div(elev, scale, fdp1);
    csum += gd;
    a[i] = __fsub_rn(elev, __fmul_rn((float)gd, fdp1));
  }
#pragma unroll
  for (int off = T / 2; off > 0; off >>= 1) csum += __shfl_xor_sync(full, csum, off, T);
  __syncwarp();
  for (int i = lane; i < dp1; i += T) {
    const float di = a[i];
    int r = 0;
    for (int j = 0; j < dp1; ++j) r += sgp_ranks_before(a[j], j, di, i);
    rank[i] = sgp_repair_rank(r, csum, d, nullptr);
  }
  __syncwarp();

  // gw[k] for every vertex k: the team's columns of both table rows, lane l
  // columns l, l + T, ... in order, then the xor butterfly; U vertices at a
  // time so that their loads are in flight together.
  const int* sk = seg + pc * dp1;
  const float* gp = g + pc * c;
  const float* vp = v + pc * c;
  constexpr int NC = CPL > 0 ? CPL : 1;
  float gc[NC], vc[NC];  // this lane's columns lane, lane + T, ... (0 past c)
#pragma unroll
  for (int t = 0; t < NC; ++t) {
    const int col = lane + t * T;
    gc[t] = col < c ? gp[col] : 0.0f;
    vc[t] = col < c ? vp[col] : 0.0f;
  }
  for (int kb = 0; kb < dp1; kb += U) {
    float acc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      acc[u] = 0.0f;
      if (kb + u < dp1) {
        const long long row = (long long)__ldg(sk + kb + u) * c;
        float x = 0.0f;
#pragma unroll
        for (int t = 0; t < NC; ++t) {
          const int col = lane + t * T;
          if (col < c) {
            const float y = __fadd_rn(__fmul_rn(gc[t], __ldg(table_f + row + col)),
                                      __fmul_rn(vc[t], __ldg(table_b + row + col)));
            x = __fadd_rn(x, y);  // the first column: 0 + y
          }
        }
        if (CPL == 0)
          for (int col = lane + T; col < c; col += T)
            x = __fadd_rn(x, __fadd_rn(__fmul_rn(gp[col], __ldg(table_f + row + col)),
                                       __fmul_rn(vp[col], __ldg(table_b + row + col))));
        acc[u] = x;
      }
    }
#pragma unroll
    for (int off = T / 2; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u) acc[u] = __fadd_rn(acc[u], __shfl_xor_sync(full, acc[u], off, T));
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (lane == 0 && kb + u < dp1) a[kb + u] = __fmul_rn(acc[u], norm);
  }
  __syncwarp();

  // de_j through its rank's differential, then grad_ref[k] = sum_j de_j E[j, k] in order of j.
  for (int j = lane; j < dp1; j += T) {
    const int r = rank[j];
    de[j] = __fmul_rn(scale, __fsub_rn(a[d - r], a[r == 0 ? 0 : d + 1 - r]));
  }
  __syncwarp();
  if (!valid) return;
  for (int k = lane; k < d; k += T) {
    float out = 0.0f;
    for (int j = 0; j < dp1; ++j) out = __fadd_rn(out, __fmul_rn(de[j], sh_E[j * d + k]));
    grad_ref[p * d + k] = out;
  }
}

template <int T, int CPL>
static int launch_grad(const float* ref, const float* E, const int* seg, const float* v, const float* g,
                       const float* table_f, const float* table_b, int n, int d, int c, float scale, float norm,
                       float* grad_ref, cudaStream_t st) {
  const unsigned int blocks = (unsigned int)(((long long)n * T + GRAD_THREADS - 1) / GRAD_THREADS);
  if (d + 1 <= 16)
    filter_grad_kernel<T, 16, CPL><<<blocks, GRAD_THREADS, 0, st>>>(ref, E, seg, v, g, table_f, table_b, n, d, c,
                                                                   scale, norm, grad_ref);
  else if (d + 1 <= 32)
    filter_grad_kernel<T, 32, CPL><<<blocks, GRAD_THREADS, 0, st>>>(ref, E, seg, v, g, table_f, table_b, n, d, c,
                                                                   scale, norm, grad_ref);
  else
    filter_grad_kernel<T, SGP_MAX_DP1, CPL><<<blocks, GRAD_THREADS, 0, st>>>(ref, E, seg, v, g, table_f, table_b,
                                                                            n, d, c, scale, norm, grad_ref);
  return (int)cudaGetLastError();
}

// A team of 4 lanes a point for c <= 16 (each lane's columns in
// registers), else 8 (kernels/lattice.py::_grad_team, the plain twin's).
extern "C" int sgp_lattice_filter_grad(const float* ref, const float* E, const int* seg,
                                       const float* v, const float* g, const float* table_f,
                                       const float* table_b, int n, int d, int c, float norm,
                                       float* grad_ref, void* stream) {
  if (d + 1 > SGP_MAX_DP1) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  const float scale = (float)(1.0 / (double)(d + 1));
  cudaStream_t st = (cudaStream_t)stream;
  if (c <= 16) return launch_grad<4, 4>(ref, E, seg, v, g, table_f, table_b, n, d, c, scale, norm, grad_ref, st);
  return launch_grad<8, 0>(ref, E, seg, v, g, table_f, table_b, n, d, c, scale, norm, grad_ref, st);
}
