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
// host never reads it), so component j's live rows are j M + [0, live[j]):
// the stacked table's live rows are not one prefix.
//
// Bound: memory traffic, as K3's: per component the seg ids and weights, the
// live rows' neighbour ids, v read and out written once -- ~J times K3's
// bytes (16.2 MB at elevators' c = 1), and the (2r+1)-tap blur arithmetic
// over the J live counts.  Design: K9's on the stacked plan's row lists,
// built once per plan (kernels/mixture.py::mixture_rows: join_rows.cu's
// sgp_rows_build over all J components, each contribution's point reduced
// mod n, so v is never tiled J times), with no atomics and no memset:
//   splat: K3'b's row-order splat (rows.cuh) into every one of the J M rows
//          (a row past its component's live count has an empty run and is
//          written 0), each row's run summed in one fixed order;
//   blur:  d+1 launches of the live-row blur (rows.cuh, sgp_live_blur_rows)
//          over the live rows of every component in turn, the component
//          found from the J prefix sums of the live counts in shared memory,
//          its neighbour ids offset by j M;
//   slice: one thread per (point, column): sum_j w_j sum_v
//          table[seg_j[p, v]] bary_j[p, v], times SN, so the weighted sum
//          over components happens in registers, with no (J, n, c)
//          intermediate.
// So two applies give the same bits, those of the plain version, which sums
// in the same order (kernels/mixture.py::mixture_apply_plain).  The
// transpose reverses the order of the axis blurs (each is symmetric).
#include "rows.cuh"

// The mixture weights travel by value.
struct SgpMix {
  float w[SGP_MAX_MIX];
};

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

// The first 16 arguments are the stacked plan's row lists (sgp_runs,
// rows.cuh), whose count is J M (every row visited by the splat); seg, w
// (J, n, dp1); nb (dp1, J M, 2r); live (J,); v and out (n, c); taps_host
// and mix_host in host memory, copied into the launches.  ta and tb hold
// J M c floats each, part np_max c; none need be zeroed.  transpose: the
// axis blurs in reverse order.  The blurred table ends in ta when dp1 is
// even, else in tb.
extern "C" int sgp_mixture_apply(const int* sp, const float* sw, const int* cnt, const int* long_rows,
                                 const int* long_first, const int* n_long, const int* piece_row,
                                 const int* piece_start, const int* n_pieces, const int* mid_rows, const int* n_mid,
                                 int nl_max, int nm_max, int np_max, int N, const int* n_rows, const int* seg,
                                 const float* w, const int* nb, const int* live, const float* v, int n, int dp1,
                                 int c, int J, int M, const float* taps_host, int order, const float* mix_host,
                                 float norm, float* ta, float* tb, float* part, float* out, int transpose,
                                 void* stream) {
  if (2 * order + 1 > SGP_MAX_TAPS || J < 1 || J > SGP_MAX_MIX) return (int)cudaErrorInvalidValue;
  if (n <= 0 || c <= 0 || M <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const SgpRuns r = sgp_runs(sp, sw, cnt, long_rows, long_first, n_long, piece_row, piece_start, n_pieces,
                             mid_rows, n_mid, nl_max, nm_max, np_max, N, n_rows);
  const SgpTaps taps = sgp_taps(taps_host, order);
  SgpMix mix = {};
  for (int j = 0; j < J; ++j) mix.w[j] = mix_host[j];
  const long long Mt = (long long)J * M;
  const long long nbs = Mt * 2 * order;  // one axis of nb
  cudaError_t err;
  if ((err = sgp_splat_rows(r, SgpWindow{v, c, 0}, c, (int)Mt, ta, part, st)) != cudaSuccess) return (int)err;
  float *a = ta, *b = tb;
  for (int jj = 0; jj < dp1; ++jj) {
    const int j = transpose ? dp1 - 1 - jj : jj;
    if ((err = sgp_live_blur_rows(a, b, nb + j * nbs, taps, SgpLiveRows{live, J, M}, c, order, st)) != cudaSuccess)
      return (int)err;
    float* t = a;
    a = b;
    b = t;
  }
  mix_slice_kernel<<<sgp_blocks((long long)n * c), SGP_THREADS, 0, st>>>(a, seg, w, n, dp1, c, J, mix, norm, out);
  return (int)cudaGetLastError();
}
