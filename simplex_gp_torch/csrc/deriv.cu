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
// back whole.
//   splat: one thread per (contribution, stacked column) forms its column
//          on the fly -- g[:,l], g[:,l] ref[:,j], src[:,l] or src[:,l]
//          ref[:,j] -- and atomicAdds w times it into the (M, C) table,
//          C = 2L(1+d) (418 at elevators with L = 11, d = 18).
//   blur:  K3's blur kernel (apply.cu) with the derivative taps; at C = 418
//          a warp reads 128 contiguous bytes of one row.
//   slice and combine: one thread per (point, j) gathers, for each l < L,
//          the four columns it needs from its d+1 rows, slices them and
//          accumulates the four-term difference; it writes grad_ref (n, d).
// Bound: memory.  The (M, C) table is 201,837 x 418 x 4 B = 337 MB at
// elevators (two of them for the blur's ping-pong), and the d+1 blurs move
// about (2r+2)(d+1) x 337 MB; the splat's atomics and the slice's gathers
// are a few times one table.  Indices are 64-bit.
#include "common.cuh"

__global__ void deriv_splat_kernel(const int* __restrict__ seg, const float* __restrict__ w,
                                   const float* __restrict__ ref, const float* __restrict__ src,
                                   const float* __restrict__ g, int n, int d, int L,
                                   float* __restrict__ table) {
  const int dp1 = d + 1;
  const int Ld = L * d;
  const int C = 2 * (L + Ld);
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n * dp1 * C) return;
  const int col = (int)(idx % C);
  const long long e = idx / C;  // contribution = point * dp1 + vertex
  const long long p = e / dp1;
  // Columns [0, L+Ld) come from g, [L+Ld, C) from src, in the same layout.
  const int half = col < L + Ld ? 0 : 1;
  const int q = col - half * (L + Ld);
  const float* val = half == 0 ? g : src;
  float x;
  if (q < L) {
    x = val[p * L + q];
  } else {
    const int l = (q - L) / d, j = (q - L) % d;
    x = __fmul_rn(val[p * L + l], ref[p * d + j]);
  }
  atomicAdd(&table[(long long)seg[e] * C + col], __fmul_rn(x, w[e]));
}

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

extern "C" int sgp_deriv_splat(const int* seg, const float* w, const float* ref, const float* src,
                               const float* g, int n, int d, int L, float* table, void* stream) {
  const long long work = (long long)n * (d + 1) * 2 * (L + (long long)L * d);
  if (work > 0)
    deriv_splat_kernel<<<sgp_blocks(work), SGP_THREADS, 0, (cudaStream_t)stream>>>(
        seg, w, ref, src, g, n, d, L, table);
  return (int)cudaGetLastError();
}

extern "C" int sgp_deriv_slice(const float* table, const int* seg, const float* w, const float* ref,
                               const float* src, const float* g, int n, int d, int L, float norm,
                               float scale, float* grad_ref, void* stream) {
  const long long work = (long long)n * d;
  if (work > 0)
    deriv_slice_kernel<<<sgp_blocks(work), SGP_THREADS, 0, (cudaStream_t)stream>>>(
        table, seg, w, ref, src, g, n, d, L, norm, scale, grad_ref);
  return (int)cudaGetLastError();
}
