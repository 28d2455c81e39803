// K5 lattice_filter_grad: the position gradient of the lattice filter,
// grad_ref = d<g, SN * S^T B S v> / d ref, for positions ref (n, d).
//
// Replaces the reverse-mode autodiff that JAX runs through the filter in
// simplex_gp_tpu/ops/filter.py::lattice_filter_exact_grad (:143) -- the
// backward of K3/K4 with respect to the positions.  Its other half, the
// gradient in the values (SN * S^T B^T S g), is K3 with the axis blurs in
// reverse order (apply.cu); it also gives this kernel table_b = B^T S g.
//
// Per point i, with seg_ik its d+1 lattice rows and table_f = B S v the
// forward's blurred table:
//   gw[k]  = SN * (g_i . table_f[seg_ik] + v_i . table_b[seg_ik])   (weights)
//   w[k]   = t_(d-k) - t_(d+1-k) for k >= 1, w[0] = 1 + t_d - t_0, with t_r
//            the scaled differential of rank r, so
//   dt_r   = gw[d-r] - gw[(d+1-r) mod (d+1)]
//   de_j   = scale * dt_(rank_j)                       (elevated coordinate j)
//   grad_i = sum_j de_j E[j, :]                        (elevation x @ E^T)
// Ranks are recomputed with sgp_simplex_rank (common.cuh), the device code
// K1 runs, so they agree with the plan bit for bit; rounding, ranks and
// keys are piecewise constant and carry no gradient, as in JAX.
//
// Bound: per point 2(d+1) scattered row reads of c floats from table_f and
// table_b (~4.6M 4-byte reads at elevators: n = 10,623, d = 18, c = 11),
// plus O(d^2) rank work.  Design: one thread per point, as K1, with the
// d+1 dot products of width c in registers and the geometry arrays in local
// memory; a wider c (a 100-column filter) would want a warp per point and a
// shuffle reduction instead.
#include "common.cuh"

__global__ void filter_grad_kernel(const float* __restrict__ ref, const float* __restrict__ E,
                                   const int* __restrict__ seg, const float* __restrict__ v,
                                   const float* __restrict__ g, const float* __restrict__ table_f,
                                   const float* __restrict__ table_b, int n, int d, int c,
                                   float scale, float norm, float* __restrict__ grad_ref) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int dp1 = d + 1;
  const float* vp = v + (long long)p * c;
  const float* gp = g + (long long)p * c;

  float gw[SGP_MAX_DP1];
  for (int k = 0; k < dp1; ++k) {
    const long long row = (long long)seg[(long long)p * dp1 + k] * c;
    float acc = 0.0f;
    for (int col = 0; col < c; ++col)
      acc += gp[col] * table_f[row + col] + vp[col] * table_b[row + col];
    gw[k] = acc * norm;
  }

  float elev[SGP_MAX_DP1];
  int gdiv[SGP_MAX_DP1], rank[SGP_MAX_DP1];
  sgp_simplex_rank(ref + (long long)p * d, E, d, scale, elev, gdiv, rank);

  // Gradient of each elevated coordinate, through its rank's differential.
  float de[SGP_MAX_DP1];
  for (int j = 0; j < dp1; ++j) {
    const int r = rank[j];
    de[j] = scale * (gw[d - r] - gw[r == 0 ? 0 : d + 1 - r]);
  }
  for (int k = 0; k < d; ++k) {
    float acc = 0.0f;
    for (int j = 0; j < dp1; ++j) acc += de[j] * E[j * d + k];
    grad_ref[(long long)p * d + k] = acc;
  }
}

extern "C" int sgp_lattice_filter_grad(const float* ref, const float* E, const int* seg,
                                       const float* v, const float* g, const float* table_f,
                                       const float* table_b, int n, int d, int c, float norm,
                                       float* grad_ref, void* stream) {
  if (d + 1 > SGP_MAX_DP1) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const float scale = (float)(1.0 / (double)(d + 1));
    filter_grad_kernel<<<sgp_blocks(n), SGP_THREADS, 0, (cudaStream_t)stream>>>(
        ref, E, seg, v, g, table_f, table_b, n, d, c, scale, norm, grad_ref);
  }
  return (int)cudaGetLastError();
}
