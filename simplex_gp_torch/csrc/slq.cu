// K14 slq_quadrature: the stochastic Lanczos quadrature of each probe's
// symmetric tridiagonal T, e1^T log(T) e1 = sum_i z_i^2 log(max(lambda_i,
// 1e-10)), with lambda_i the eigenvalues of T and z_i the first components
// of their eigenvectors.
//
// Replaces jnp.linalg.eigh on the dense (p, m, m) tridiagonals in
// simplex_gp_tpu/linalg/lanczos.py::slq_logdet (:128) and
// logdet_from_cg_tridiag (:177), which the port ran as a batched
// torch.linalg.eigh (cuSOLVER on the card, with its host round trips).
//
// Bound: latency.  The work is the QL iteration on one small tridiagonal a
// probe, about (3/4) L^2 plane rotations in sequence, L the length of the
// leading block (the CG's live steps: 11-38 on the houseelectric training
// step, at most m = 100 there).  The bytes are the band in and one float a
// probe out.  gpbench/counts.py charges the stage as a dense eigh, 4 p m^2
// bytes and 9 p m^3 operations: ~14 ns at p = 10, m = 22, far below one
// launch.  Each probe's rotations are one dependent chain (a double rsqrt
// and a few fma each), so the time is the rotations times the chain's
// latency, with the probes side by side, a warp each.
//
// Design.
//  * The leading block.  T is block diagonal wherever an off-diagonal is
//    exactly 0: logdet_from_cg_tridiag pads dead steps with a decoupled
//    identity, and a Lanczos breakdown records beta 0.  e1 lies in the
//    first block, so every eigenvector of a later block has first
//    component 0 and the quadrature is the first block's alone.  The warp
//    finds L, one past the first zero off-diagonal, by ballots over the
//    staged band and solves the L x L problem only: no (m, m) matrix, no
//    host read.
//  * Implicit QL with Wilkinson shifts (tqli: Numerical Recipes 11.4, after
//    EISPACK's tql1) in double precision on the block, carrying only the
//    first row of the eigenvector matrix (Golub-Welsch): O(L^2) operations
//    and three rows of L doubles in shared memory.  The rotations chase up
//    one lane's dependent chain; a rotation's hypotenuse is h rsqrt(h), h =
//    f^2 + g^2 (double's range keeps it from overflow for a float32 band),
//    rsqrt the SFU's approximation and two Newton steps, the next step's
//    loads issued a step ahead.  The search for the first negligible
//    off-diagonal before each sweep, the band's staging and the final sum
//    are the warp's, by ballots and shuffles.  At most 30 sweeps an
//    eigenvalue: past that (a NaN in the band) the probe's output is NaN.
//  * Inputs in float32 through strides, so each caller passes the layout it
//    holds.  Lanczos passes its (p, m) band; logdet_from_cg_tridiag passes
//    the CG record itself (the step-major (m, p) alphas, betas and live
//    mask), whose band the kernel forms as it stages it, in the plain
//    cg_band's IEEE operations: the stage is one launch, not a dozen
//    elementwise ones.  The output is rounded to float32 once.
//  * Deterministic: no atomics, every sum in a fixed order, so two calls
//    give the same bits, and so do the ranks of a data-parallel run, which
//    hold the same record.
#include "common.cuh"

#include <float.h>
#include <math.h>

// A probe's three double rows must fit the 48 KB of shared memory a launch
// gets without opting in (kernels/slq.py::MAX_M).
#define SLQ_MAX_M 2048
#define SLQ_MAX_SWEEPS 30
#define SLQ_FULL 0xffffffffu

// 1 / sqrt(h) for a normal h: the SFU's approximation, then two Newton steps
// (each doubles the correct bits), a few ulps from the rounded value.
__device__ __forceinline__ double slq_rsqrt(double h) {
  double y;
  asm("rsqrt.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(h));
  const double hh = 0.5 * h;
  y = y * fma(-hh * y, y, 1.5);
  return y * fma(-hh * y, y, 1.5);
}

// One sweep of tqli (lane 0): the implicit QL step with the Wilkinson shift on
// rows l..mm, from the bottom up, the eigenvectors' first row z carried.
// Each rotation reads the band as it was before the sweep (d[i], e[i], z[i]),
// so those loads are issued a step ahead; the rows the next step needs
// (d[i + 1] as it was, the new z[i + 1]) stay in registers.
__device__ void slq_sweep(double* d, double* e, double* z, int l, int mm) {
  double g = (d[l + 1] - d[l]) / (2.0 * e[l]);
  const double r0 = sqrt(fma(g, g, 1.0));  // |g| < 1 / (2 eps): e[l] is not negligible
  g = d[mm] - d[l] + e[l] / (g + copysign(r0, g));
  double s = 1.0, c = 1.0, p = 0.0;
  double d_up = d[mm], z_up = z[mm];
  double e_i = e[mm - 1], d_i = d[mm - 1], z_i = z[mm - 1];
  for (int i = mm - 1; i >= l; --i) {
    const int k = i > l ? i - 1 : i;
    const double e_next = e[k], d_next = d[k], z_next = z[k];
    const double f = s * e_i, b = c * e_i;
    const double h = fma(f, f, g * g);
    if (h == 0.0) {  // the rotation vanished: deflate here; the caller sweeps again
      d[i + 1] = d_up - p;
      z[i + 1] = z_up;
      e[i + 1] = 0.0;
      e[mm] = 0.0;
      return;
    }
    const double t = h >= DBL_MIN ? slq_rsqrt(h) : rsqrt(h);
    e[i + 1] = h * t;
    s = f * t;
    c = g * t;
    g = d_up - p;
    const double r = fma(d_i - g, s, 2.0 * c * b);
    p = s * r;
    d[i + 1] = g + p;
    g = fma(c, r, -b);
    z[i + 1] = fma(s, z_i, c * z_up);
    z_up = fma(c, z_i, -s * z_up);
    d_up = d_i;
    e_i = e_next, d_i = d_next, z_i = z_next;
  }
  z[l] = z_up;
  d[l] -= p;
  e[l] = g;
  e[mm] = 0.0;
}

// tqli (Numerical Recipes 11.4) on d[0, n), e[0, n) (e[i] couples i and
// i + 1; e[n - 1] = 0), z[0, n) the first row of the eigenvector matrix (e1
// at the start), run by the whole warp: the search for the first negligible
// e[mm] at or below l by ballots, the sweeps by lane 0.  On return d holds
// the eigenvalues and z their eigenvectors' first components, and every lane
// the quadrature, summed over lanes' strided partials and an xor butterfly
// in a fixed order; NaN when a sweep limit is hit.
__device__ double slq_block_quadrature(double* d, double* e, double* z, int n, int lane) {
  for (int l = 0; l < n; ++l) {
    for (int sweeps = 0;; ++sweeps) {
      int mm = n - 1;
      for (int base = l; base < n - 1; base += 32) {
        const int k = base + lane;
        const bool small = k < n - 1 && fabs(e[k]) <= DBL_EPSILON * (fabs(d[k]) + fabs(d[k + 1]));
        const unsigned hit = __ballot_sync(SLQ_FULL, small);
        if (hit) {
          mm = base + __ffs(hit) - 1;
          break;
        }
      }
      if (mm == l) break;
      if (sweeps == SLQ_MAX_SWEEPS) return nan("");
      if (lane == 0) slq_sweep(d, e, z, l, mm);
      __syncwarp();
    }
  }
  // The clamp of the float32 path, max(lambda, 1e-10f); a NaN stays NaN.
  const double lo = (double)1e-10f;
  double quad = 0.0;
  for (int i = lane; i < n; i += 32) quad += z[i] * z[i] * log(d[i] < lo ? lo : d[i]);
  for (int off = 16; off > 0; off >>= 1) quad += __shfl_xor_sync(SLQ_FULL, quad, off);
  return quad;
}

// The float32 band of a CG record's step k (lanczos.py:163-176, in
// torch's order of IEEE operations, so the band is the plain cg_band's bit
// for bit): alpha, beta and live in (probe, step) strides.
__device__ __forceinline__ void slq_record_band(const float* aj, long long as_k, const float* bj, long long bs_k,
                                                const unsigned char* mj, long long ms_k, int k, int m, float* dk,
                                                float* ek) {
  const bool live = mj[k * ms_k] != 0;
  const float inv = __fdiv_rn(1.0f, live ? aj[k * as_k] : 1.0f);
  float prev = 0.0f;  // beta_{k-1} / alpha_{k-1} of a live step before
  if (k > 0) {
    const bool live_prev = mj[(k - 1) * ms_k] != 0;
    prev = __fmul_rn(live_prev ? bj[(k - 1) * bs_k] : 0.0f, __fdiv_rn(1.0f, live_prev ? aj[(k - 1) * as_k] : 1.0f));
  }
  *dk = live ? __fadd_rn(inv, prev) : 1.0f;
  *ek = 0.0f;
  if (k < m - 1 && live && mj[(k + 1) * ms_k] != 0) {
    const float b = bj[k * bs_k];
    *ek = __fmul_rn(__fsqrt_rn(b < 0.0f ? 0.0f : b), inv);
  }
}

// One warp a probe (block j): its band staged as doubles in shared memory
// (read, or formed from the CG record when mask is given), the leading
// block's length by ballots, the QL.
__global__ void __launch_bounds__(32) slq_quadrature_kernel(const float* __restrict__ a, long long as_p,
                                                             long long as_k, const float* __restrict__ b,
                                                             long long bs_p, long long bs_k,
                                                             const unsigned char* __restrict__ mask,
                                                             long long ms_p, long long ms_k, int m,
                                                             float* __restrict__ out) {
  extern __shared__ double slq_rows[];
  double* d = slq_rows;
  double* e = d + m;
  double* z = e + m;
  const int j = blockIdx.x, lane = threadIdx.x;
  const float* aj = a + (long long)j * as_p;
  const float* bj = b + (long long)j * bs_p;
  for (int k = lane; k < m; k += 32) {
    float dk, ek;
    if (mask != nullptr) {
      slq_record_band(aj, as_k, bj, bs_k, mask + (long long)j * ms_p, ms_k, k, m, &dk, &ek);
    } else {
      dk = aj[(long long)k * as_k];
      ek = k < m - 1 ? bj[(long long)k * bs_k] : 0.0f;
    }
    d[k] = (double)dk;
    e[k] = (double)ek;
    z[k] = k == 0 ? 1.0 : 0.0;
  }
  __syncwarp();
  int n = m;
  for (int base = 0; base < m - 1; base += 32) {
    const unsigned zero = __ballot_sync(SLQ_FULL, base + lane < m - 1 && e[base + lane] == 0.0);
    if (zero) {
      n = base + __ffs(zero);  // one past the first zero off-diagonal
      break;
    }
  }
  const double quad = slq_block_quadrature(d, e, z, n, lane);
  if (lane == 0) out[j] = (float)quad;
}

// Band form (mask null): a = diag (p, m), b = off (p, m - 1).  Record form:
// a = alphas, b = betas, mask = tmask (bool), each (p, m), the band formed
// in the kernel.  Float32 (and bool) through (probe, step) strides in
// elements; out (p,) float32.
extern "C" int sgp_slq_quadrature(const float* a, long long as_p, long long as_k, const float* b, long long bs_p,
                                  long long bs_k, const unsigned char* mask, long long ms_p, long long ms_k, int p,
                                  int m, float* out, void* stream) {
  if (m < 1 || m > SLQ_MAX_M) return (int)cudaErrorInvalidValue;
  if (p <= 0) return (int)cudaGetLastError();
  slq_quadrature_kernel<<<p, 32, 3 * m * sizeof(double), (cudaStream_t)stream>>>(a, as_p, as_k, b, bs_p, bs_k, mask,
                                                                                   ms_p, ms_k, m, out);
  return (int)cudaGetLastError();
}
