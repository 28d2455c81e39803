// K6 pivot_column: one step of the pivoted Cholesky of the exact kernel
// matrix s * k(||ref_i - ref_j||^2), writing column j of L and the updated
// residual diagonal.
//
// Replaces the body of simplex_gp_tpu/linalg/pivoted_cholesky.py::
// pivoted_cholesky_features (:106, column at :143-161).
//
// Bound: per pivot it reads ref (n x dim) and the first j columns of L
// (n x k row-major), ~4.6 MB at elevators (n = 10,623, dim = 18, k = 100),
// all L2-resident, for O(n (dim + j)) flops: memory-latency-bound, and 100
// pivots run one after another.  Design: one fused pass, one thread per row:
// the squared distance in the direct form sum((ref_i - ref_p)^2), the kernel
// value, the subtraction of L[i, :j] . L[p, :j], the 1/sqrt(pivot) scaling
// under the relative threshold alive = d[p] > 1e-6 max(diag), and the
// diagonal update max(d - ell^2, 0).  The pivot index stays on the device
// (torch.argmax output), so no step waits on the host.  The diagonal is
// double-buffered: every thread reads the pivot's old value d_in[p] while
// the pivot's own thread zeroes d_out[p].
//
// K6', the sharded step (pivoted_cholesky.py:129-140, :152-162), is the
// same kernel: the rows of ref, L and the diagonal are this rank's, and the
// pivot may live on another rank.  Each rank all-gathers one candidate (its
// local maximum of the diagonal, that row of ref and that row of L), and
// every rank picks the same winner.  The caller passes the winner's x row, L
// row and pivot value as device vectors (null for K6, which reads row p),
// and the pivot's local index, or -1 on the ranks that lost: only the
// winner writes sqrt(pivot) into L and zeroes its diagonal entry.
#include "common.cuh"

__device__ __forceinline__ float sgp_kernel_value(float d2, float nu) {
  // nu == 0: rbf exp(-d2); otherwise Matern-nu, nu in {0.5, 1.5, 2.5}.
  if (nu == 0.0f) return expf(-d2);
  const float d = sqrtf(fmaxf(d2, 1e-30f));
  const float e = expf(__fmul_rn(-sqrtf(2.0f * nu), d));
  if (nu == 0.5f) return e;
  if (nu == 1.5f) return __fmul_rn(__fadd_rn(1.0f, __fmul_rn(sqrtf(3.0f), d)), e);
  return __fmul_rn(
      __fadd_rn(__fadd_rn(1.0f, __fmul_rn(sqrtf(5.0f), d)), __fmul_rn((float)(5.0 / 3.0), d2)), e);
}

__global__ void pivot_column_kernel(const float* __restrict__ ref, float* L,
                                    const float* __restrict__ d_in, float* __restrict__ d_out,
                                    const float* __restrict__ x_piv, const float* __restrict__ l_piv,
                                    const float* __restrict__ pv, const long long* __restrict__ piv,
                                    const float* __restrict__ s, const float* __restrict__ d0max,
                                    long long* __restrict__ pivots, int n, int dim, int k, int j,
                                    float nu) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long p = *piv;  // -1 on a rank that does not hold the pivot
  // The pivot's rows: given (K6'), or row p of ref, L and the diagonal (K6).
  const float* rp = x_piv ? x_piv : ref + p * dim;
  const float* Lp = l_piv ? l_piv : L + p * k;
  const float pv_raw = pv ? *pv : d_in[p];
  const bool alive = pv_raw > __fmul_rn(1e-6f, *d0max);
  const float root = sqrtf(fmaxf(pv_raw, 1e-12f));

  const float* ri = ref + (long long)i * dim;
  float d2 = 0.0f;
  for (int q = 0; q < dim; ++q) {
    const float diff = __fsub_rn(ri[q], rp[q]);
    d2 = __fadd_rn(d2, __fmul_rn(diff, diff));
  }
  float col = __fmul_rn(*s, sgp_kernel_value(d2, nu));
  const float* Li = L + (long long)i * k;
  float dot = 0.0f;
  for (int q = 0; q < j; ++q) dot = __fadd_rn(dot, __fmul_rn(Li[q], Lp[q]));
  col = __fsub_rn(col, dot);

  float ell = alive ? __fdiv_rn(col, root) : 0.0f;
  if (i == p) ell = alive ? root : 0.0f;
  L[(long long)i * k + j] = ell;
  d_out[i] = i == p ? 0.0f : fmaxf(__fsub_rn(d_in[i], __fmul_rn(ell, ell)), 0.0f);
  if (i == 0) pivots[j] = p;
}

extern "C" int sgp_pivot_column(const float* ref, float* L, const float* d_in, float* d_out,
                                const float* x_piv, const float* l_piv, const float* pv,
                                const long long* piv, const float* s, const float* d0max,
                                long long* pivots, int n, int dim, int k, int j, float nu,
                                void* stream) {
  if (n > 0)
    pivot_column_kernel<<<sgp_blocks(n), SGP_THREADS, 0, (cudaStream_t)stream>>>(
        ref, L, d_in, d_out, x_piv, l_piv, pv, piv, s, d0max, pivots, n, dim, k, j, nu);
  return (int)cudaGetLastError();
}
