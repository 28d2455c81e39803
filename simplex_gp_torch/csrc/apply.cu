// K3 lattice_apply: out = SLICE_NORM * S^T B_d ... B_0 S v for v (n, c).
//
// Replaces simplex_gp_tpu/ops/lattice.py::apply_plan_join (:470).
//
// Bound: memory traffic.  Splat moves n(d+1)c weighted values into the
// (M, c) table, each of the d+1 blurs reads (2r+1) rows and writes one per
// live row, and the slice gathers d+1 rows per point: about
// (d+1)(2r+2) M c 4 bytes, ~0.8 GB at elevators' joint plan with c = 101.
// Design: three phases, one thread per (item, column), so a warp walks the
// contiguous columns of one row and its reads coalesce whenever c >= 32;
// at c = 1 (the CG operator) every gather is a scattered 4-byte load.
//   splat: one thread per (contribution, column), atomicAdd into a table the
//          wrapper zeroed.  The order of the adds, and so the last bits of
//          the sums, varies from run to run.
//   blur:  one launch per lattice axis, ping-ponging two (M, c) buffers; a
//          (2r+1)-tap gather stencil where a missing neighbour (index M)
//          counts as zero.  Rows past the live count n_lattice are skipped.
//   slice: one thread per (point, column): barycentric sum of d+1 rows.
// Blur and slice use explicit round-to-nearest operations in the plain
// version's order, so given the same table they match it bit for bit.
#include "common.cuh"

__global__ void splat_kernel(const int* __restrict__ seg, const float* __restrict__ w,
                             const float* __restrict__ v, int n, int dp1, int c,
                             float* __restrict__ table) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n * dp1 * c) return;
  const int col = (int)(idx % c);
  const long long e = idx / c;  // contribution = point * dp1 + vertex
  const long long p = e / dp1;
  atomicAdd(&table[(long long)seg[e] * c + col], __fmul_rn(v[p * c + col], w[e]));
}

__global__ void blur_kernel(const float* __restrict__ in, float* __restrict__ out,
                            const int* __restrict__ nb, const SgpTaps taps, int M,
                            int c, int order, const int* __restrict__ count) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = idx / c;
  if (row >= *count) return;
  const int col = (int)(idx % c);
  const int r2 = 2 * order;
  float acc = __fmul_rn(taps.v[order], in[idx]);
  for (int t = 0; t < r2; ++t) {
    const int j = nb[row * r2 + t];
    if (j != M) acc = __fadd_rn(acc, __fmul_rn(taps.v[t < order ? t : t + 1], in[(long long)j * c + col]));
  }
  out[idx] = acc;
}

__global__ void slice_kernel(const float* __restrict__ table, const int* __restrict__ seg,
                             const float* __restrict__ w, int n, int dp1, int c, float norm,
                             float* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n * c) return;
  const int col = (int)(idx % c);
  const long long p = idx / c;
  float acc = 0.0f;
  for (int v = 0; v < dp1; ++v) {
    const long long e = p * dp1 + v;
    acc = __fadd_rn(acc, __fmul_rn(table[(long long)seg[e] * c + col], w[e]));
  }
  out[idx] = __fmul_rn(acc, norm);
}

extern "C" int sgp_lattice_splat(const int* seg, const float* w, const float* v, int n, int dp1,
                                 int c, float* table, void* stream) {
  const long long work = (long long)n * dp1 * c;
  if (work > 0)
    splat_kernel<<<sgp_blocks(work), SGP_THREADS, 0, (cudaStream_t)stream>>>(seg, w, v, n, dp1,
                                                                              c, table);
  return (int)cudaGetLastError();
}

// taps_host: 2*order+1 floats in host memory, copied into the launch.
extern "C" int sgp_lattice_blur(const float* in, float* out, const int* nb,
                                const float* taps_host, int M, int c, int order,
                                const int* count, void* stream) {
  if (2 * order + 1 > SGP_MAX_TAPS) return (int)cudaErrorInvalidValue;
  SgpTaps taps = {};
  for (int t = 0; t < 2 * order + 1; ++t) taps.v[t] = taps_host[t];
  const long long work = (long long)M * c;
  if (work > 0)
    blur_kernel<<<sgp_blocks(work), SGP_THREADS, 0, (cudaStream_t)stream>>>(in, out, nb, taps, M,
                                                                             c, order, count);
  return (int)cudaGetLastError();
}

extern "C" int sgp_lattice_slice(const float* table, const int* seg, const float* w, int n,
                                 int dp1, int c, float norm, float* out, void* stream) {
  const long long work = (long long)n * c;
  if (work > 0)
    slice_kernel<<<sgp_blocks(work), SGP_THREADS, 0, (cudaStream_t)stream>>>(table, seg, w, n,
                                                                              dp1, c, norm, out);
  return (int)cudaGetLastError();
}
