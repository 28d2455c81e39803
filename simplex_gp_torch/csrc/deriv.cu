// K7 lattice_deriv_grad: the reference-parity position gradient of the
// filter, from ONE derivative-tap filter of the stacked columns
// [g, g (x) ref, src, src (x) ref] (n x 2L(1+d)):
//   grad_ref[p, j] = scale * sum_l ( sf[l,j] wg[l] - src[l] wgf[l,j]
//                                  + gf[l,j] ws[l] - g[l]   wsf[l,j] )
// with gf = g ref_j, sf = src ref_j, (wg, wgf, ws, wsf) the filtered stack
// and scale = 2 k'(0) (JAX's fix of the reference's -2).
//
// Replaces simplex_gp_tpu/ops/filter.py::_bwd (:261-291), the backward of
// lattice_filter, which writes the (n, 2L(1+d)) stack, filters it on the
// derivative plan (build_plan_join with deriv_coeffs / deriv_variance, built
// here by K1 + K2) and combines the four blocks.
//
// Design: the stack is never written and the filtered block is never read
// back whole; one host call (sgp_deriv_grad) launches every phase.
//   splat: K3'b's row-order splat (rows.cuh) on the plan's row lists
//          (apply.cu's sgp_join_rows), with the stacked columns as its
//          source: column col of point p is formed on the fly -- g[:,l],
//          g[:,l] ref[:,j], src[:,l] or src[:,l] ref[:,j] -- so the (M, C)
//          table, C = 2L(1+d) (418 at elevators with L = 11, d = 18), is
//          written row by row, live rows only, with no atomics and no
//          memset;
//   blur:  sgp_live_blur (rows.cuh) with the derivative taps: a warp per
//          live row and chunk of 64 columns, two columns a lane (8-byte
//          loads) at C = 418;
//   slice and combine: one thread per (point, j) gathers, for each l < L,
//          the four columns it needs from its d+1 rows, slices them and
//          accumulates the four-term difference; it writes grad_ref (n, d).
// Every phase sums in a fixed order, so two runs give the same bits, and
// the plain version (kernels/lattice.py::deriv_grad_plain) sums in the same
// order, bit for bit.
// Bound: memory.  The live rows of the (M, C) table are 100,178 x 418 x 4 B
// = 167 MB at elevators (two of them for the blur's ping-pong), and the d+1
// blurs move about (2r+2)(d+1) x 167 MB; the splat's reads and the slice's
// gathers are a few times one table.  Indices are 64-bit.
#include "rows.cuh"

// The splat's column source: the stacked columns of point p, formed on the
// fly.  Columns [0, L + Ld) come from g, [L + Ld, C) from src, each half
// laid out as [val[:, l] for l < L] then [val[:, l] ref[:, j] for l, j].
struct DerivCols {
  // Columns a warp's pass carries: each is decoded into (half, l, j), and 16 of them took 162
  // registers a thread on an H100 (one block of 256 threads an SM), 8 of them 94.
  static constexpr int kTile = 8;
  const float* ref;
  const float* src;
  const float* g;
  int d, L;
  __device__ __forceinline__ float operator()(int p, int col) const {
    const int Ld = L * d;
    const int half = col < L + Ld ? 0 : 1;
    const int q = col - half * (L + Ld);
    const float* val = half == 0 ? g : src;
    if (q < L) return val[(long long)p * L + q];
    const int l = (q - L) / d, j = (q - L) - l * d;
    return __fmul_rn(val[(long long)p * L + l], ref[(long long)p * d + j]);
  }
};

__global__ void deriv_slice_kernel(const float* __restrict__ table, const int* __restrict__ seg,
                                   const float* __restrict__ w, const float* __restrict__ ref,
                                   const float* __restrict__ src, const float* __restrict__ g,
                                   int n, int d, int L, float norm, float scale,
                                   float* __restrict__ grad_ref) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n * d) return;
  const int dp1 = d + 1;
  const int Ld = L * d;
  const long long C = 2 * (L + Ld);
  const int j = (int)(idx % d);
  const long long p = idx / d;
  const float r = ref[p * d + j];
  float acc = 0.0f;
  for (int l = 0; l < L; ++l) {
    float wg = 0.0f, wgf = 0.0f, ws = 0.0f, wsf = 0.0f;
    for (int v = 0; v < dp1; ++v) {
      const long long e = p * dp1 + v;
      const float* row = table + (long long)seg[e] * C;
      const float we = w[e];
      wg = __fadd_rn(wg, __fmul_rn(row[l], we));
      wgf = __fadd_rn(wgf, __fmul_rn(row[L + l * d + j], we));
      ws = __fadd_rn(ws, __fmul_rn(row[L + Ld + l], we));
      wsf = __fadd_rn(wsf, __fmul_rn(row[2 * L + Ld + l * d + j], we));
    }
    const float s = src[p * L + l], gl = g[p * L + l];
    const float term = __fmul_rn(__fmul_rn(s, r), __fmul_rn(wg, norm))
                     - __fmul_rn(s, __fmul_rn(wgf, norm))
                     + __fmul_rn(__fmul_rn(gl, r), __fmul_rn(ws, norm))
                     - __fmul_rn(gl, __fmul_rn(wsf, norm));
    acc += term;
  }
  grad_ref[idx] = acc * scale;
}

// The first 16 arguments are the derivative plan's row lists (sgp_runs,
// rows.cuh); nb its (d+1, M, 2r) neighbours, n_lattice its live count;
// ta and tb hold M * C floats each, part np_max * C; none need be zeroed.
extern "C" int sgp_deriv_grad(const int* sp, const float* sw, const int* cnt, const int* long_rows,
                              const int* long_first, const int* n_long, const int* piece_row, const int* piece_start,
                              const int* n_pieces, const int* mid_rows, const int* n_mid, int nl_max, int nm_max,
                              int np_max, int N, const int* n_lattice, const int* seg, const float* w, const int* nb,
                              const float* ref, const float* src, const float* g, int n, int d, int L, int M,
                              const float* taps_host, int order, float norm, float scale, float* ta, float* tb,
                              float* part, float* grad_ref, void* stream) {
  if (2 * order + 1 > SGP_MAX_TAPS) return (int)cudaErrorInvalidValue;
  if (n <= 0 || d <= 0 || L <= 0 || M <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const int C = 2 * L * (1 + d);
  const SgpRuns r = sgp_runs(sp, sw, cnt, long_rows, long_first, n_long, piece_row, piece_start, n_pieces,
                             mid_rows, n_mid, nl_max, nm_max, np_max, N, n_lattice);
  cudaError_t err = sgp_splat_rows(r, DerivCols{ref, src, g, d, L}, C, M, ta, part, st);
  if (err != cudaSuccess) return (int)err;
  const SgpTaps taps = sgp_taps(taps_host, order);
  const long long nbs = (long long)M * 2 * order;  // one axis of nb
  float *a = ta, *b = tb;
  for (int j = 0; j <= d; ++j) {
    if ((err = sgp_live_blur(a, b, nb + j * nbs, taps, M, C, order, n_lattice, st)) != cudaSuccess) return (int)err;
    float* t = a;
    a = b;
    b = t;
  }
  deriv_slice_kernel<<<sgp_blocks((long long)n * d), SGP_THREADS, 0, st>>>(a, seg, w, ref, src, g, n, d, L, norm,
                                                                           scale, grad_ref);
  return (int)cudaGetLastError();
}
