// K12 lattice_mixture_apply: the Gaussian-mixture lattice operator,
//   out = SN * sum_j w_j S_j^T B_j S_j v   for v (n, c),
// over J component plans stacked into one table.
//
// Replaces the mixture branches of simplex_gp_tpu/ops/filter.py
// (lattice_filter_any :167-183, build_plan_any :186-193, apply_plan_any
// :196-204, make_wide_filter_any :207-220), where JAX runs one RBF lattice
// apply per component at the positions ref * alpha_j and sums the weighted
// outputs: J applies (J x (d+3) launches here, were each K3) and a (J, n, c)
// stack of component outputs per MVM.
//
// Layout.  The J plans (K1 + K2 per component, ops/lattice.py
// build_plan_mixture) are stacked component-major into one table of J M
// rows, M = n(d+1) (untrimmed: mixture plans ignore capacity, filter.py
// :174-176).  seg (J, n, d+1) holds global rows, j M + the component's own
// row; the neighbour array (d+1, J M, 2r) keeps each component's local row
// ids with the sentinel M for a missing neighbour, exactly as K2 built them;
// live (J,) holds each component's occupied row count, on the device (the
// host never reads it).
//
// Bound: memory traffic, as K3's: per component the seg ids and weights, the
// live rows' neighbour ids, v read and out written once -- ~J times K3's
// bytes (16.2 MB at elevators' c = 1), and the (2r+1)-tap blur arithmetic
// over the J live counts.  Design: K3's three phases over the whole stack,
// so a mixture MVM is 1 + (d+1) + 1 launches instead of J (d+3):
//   splat: one thread per (component, contribution, column); it reads
//          v[p, col] directly for every component, so v is never tiled J
//          times, and atomically adds into the zeroed stacked table (the
//          order of the adds varies from run to run, as K3's);
//   blur:  d+1 launches, each over all J M rows; a thread takes its
//          component j = row / M, skips rows at or past live[j], and runs
//          K3's (2r+1)-tap stencil with the neighbour ids offset by j M;
//   slice: one thread per (point, column): sum_j w_j sum_v
//          table[seg_j[p, v]] bary_j[p, v], times SN, so the weighted sum
//          over components happens in registers, with no (J, n, c)
//          intermediate.
// The transpose reverses the order of the axis blurs (each is symmetric).
#include "common.cuh"

// Largest number of mixture components; the weights travel by value.
#define SGP_MAX_MIX 16
struct SgpMix {
  float w[SGP_MAX_MIX];
};

__global__ void mix_splat_kernel(const int* __restrict__ seg, const float* __restrict__ w,
                                 const float* __restrict__ v, int n, int dp1, int c, int J,
                                 float* __restrict__ table) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)J * n * dp1 * c) return;
  const int col = (int)(idx % c);
  const long long e = idx / c;  // stacked contribution = (j * n + point) * dp1 + vertex
  const long long p = (e / dp1) % n;
  atomicAdd(&table[(long long)seg[e] * c + col], __fmul_rn(v[p * c + col], w[e]));
}

__global__ void mix_blur_kernel(const float* __restrict__ in, float* __restrict__ out,
                                const int* __restrict__ nb, const SgpTaps taps, int M, int J,
                                int c, int order, const int* __restrict__ live) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)J * M * c) return;
  const long long row = idx / c;  // stacked row
  const int j = (int)(row / M);
  const long long base = (long long)j * M;
  if (row - base >= live[j]) return;  // a row past the component's live ones
  const int col = (int)(idx % c);
  const int r2 = 2 * order;
  float acc = __fmul_rn(taps.v[order], in[idx]);
  for (int t = 0; t < r2; ++t) {
    const int k = nb[row * r2 + t];
    if (k != M)
      acc = __fadd_rn(acc, __fmul_rn(taps.v[t < order ? t : t + 1], in[(base + k) * c + col]));
  }
  out[idx] = acc;
}

__global__ void mix_slice_kernel(const float* __restrict__ table, const int* __restrict__ seg,
                                 const float* __restrict__ w, int n, int dp1, int c, int J,
                                 const SgpMix mix, float norm, float* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n * c) return;
  const int col = (int)(idx % c);
  const long long p = idx / c;
  float acc = 0.0f;
  for (int j = 0; j < J; ++j) {
    const long long e0 = ((long long)j * n + p) * dp1;
    float s = 0.0f;
    for (int v = 0; v < dp1; ++v)
      s = __fadd_rn(s, __fmul_rn(table[(long long)seg[e0 + v] * c + col], w[e0 + v]));
    acc = __fadd_rn(acc, __fmul_rn(mix.w[j], s));
  }
  out[idx] = __fmul_rn(acc, norm);
}

// seg, w: (J, n, dp1); v: (n, c); table: (J M, c), zeroed.
extern "C" int sgp_mixture_splat(const int* seg, const float* w, const float* v, int n, int dp1, int c,
                                 int J, float* table, void* stream) {
  const long long work = (long long)J * n * dp1 * c;
  if (work > 0)
    mix_splat_kernel<<<sgp_blocks(work), SGP_THREADS, 0, (cudaStream_t)stream>>>(seg, w, v, n, dp1, c,
                                                                                 J, table);
  return (int)cudaGetLastError();
}

// One axis: nb is that axis's (J M, 2r) slice of the (dp1, J M, 2r) array;
// taps_host holds 2 order + 1 floats in host memory, copied into the launch.
extern "C" int sgp_mixture_blur(const float* in, float* out, const int* nb, const float* taps_host, int M,
                                int J, int c, int order, const int* live, void* stream) {
  if (2 * order + 1 > SGP_MAX_TAPS) return (int)cudaErrorInvalidValue;
  SgpTaps taps = {};
  for (int t = 0; t < 2 * order + 1; ++t) taps.v[t] = taps_host[t];
  const long long work = (long long)J * M * c;
  if (work > 0)
    mix_blur_kernel<<<sgp_blocks(work), SGP_THREADS, 0, (cudaStream_t)stream>>>(in, out, nb, taps, M, J, c,
                                                                                order, live);
  return (int)cudaGetLastError();
}

// mix_host: the J mixture weights in host memory, copied into the launch.
extern "C" int sgp_mixture_slice(const float* table, const int* seg, const float* w, int n, int dp1, int c,
                                 int J, const float* mix_host, float norm, float* out, void* stream) {
  if (J > SGP_MAX_MIX) return (int)cudaErrorInvalidValue;
  SgpMix mix = {};
  for (int j = 0; j < J; ++j) mix.w[j] = mix_host[j];
  const long long work = (long long)n * c;
  if (work > 0)
    mix_slice_kernel<<<sgp_blocks(work), SGP_THREADS, 0, (cudaStream_t)stream>>>(table, seg, w, n, dp1, c,
                                                                                J, mix, norm, out);
  return (int)cudaGetLastError();
}
