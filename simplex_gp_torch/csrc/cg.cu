// K10: one iteration of batched preconditioned conjugate gradients over the
// t columns of an (n, t) block, with every rule of the JAX solver.
//
// Replaces the lax.while_loop body of simplex_gp_tpu/linalg/cg.py::cg_solve
// (:133-205): the column dots, alpha and beta with their guards, the x, r and
// p updates, the relative residual, the best iterate, the stall guard, the
// stop modes "mean" and "column", the breakdown freeze (pap <= 0, rz < 0) and
// the Lanczos tridiagonal record, written at a device-side iteration counter
// (JAX's k = min(it, m - 1)).  The MVM is the caller's (K3', K12, a matmul);
// a Woodbury preconditioner's two products with U (n, k) stay cuBLAS, as JAX
// computes them outside the CG body (pivoted_cholesky.py:242).
//
// Bound: memory traffic.  An iteration reads and writes about 17 (n, t)
// passes (x, r, p, the best iterate, A p, z) and reads U twice, so at t = 1
// the kernels are a few percent of it and the two reads of U the rest; at
// houseelectric's n = 1.31M and k = 100 that is 1.05 GB of U an iteration.
// The design keeps launches few (five an iteration besides the MVM and the
// two GEMMs, each a single pass over its vectors) and keeps every decision on
// the device, so one iteration can be captured in a CUDA graph and the host
// reads one stop flag per replay.  (A graph of four iterations, gated on the
// flag, measured within the run-to-run spread of one on an H100.)
//
// Determinism.  No float atomics.  A column dot is a fixed two-stage tree:
//   stage 1 (the kernel that makes the products): the grid has nb blocks, a
//     power of two fixed by n and t (not by the card: kernels/cg.py::cg_layout,
//     about 16 rows a lane, at most 512 blocks); thread (rr, col) of a
//     block, rr = tid / t < rp (rp the largest power of two with rp t <= 256),
//     adds the products of rows b rp + rr + k nb rp, k = 0, 1, ... in turn,
//     then the block folds its rp lanes of each column in halves (a tree);
//     block b writes its partial sum to part[b, col];
//   stage 2 (every block of the kernel that needs the dot): the nb partials
//     of each column are folded in halves in shared memory (a tree over b).
// Sharded rows (K10', the data-parallel CG): each of P ranks writes its own
// (nb, t) partials, the caller all-gathers them into a (P, nb, t) buffer, and
// stage 2 folds each rank's nb partials as above, then adds the P rank sums
// in rank order 0 .. P-1.  Every rank reduces the same gathered bytes, so
// every stop decision is the same bits on every rank; P = 1 is the
// one-device arithmetic exactly.
// Every block computes the same sums in the same order, and every multiply
// and add is an explicit round-to-nearest operation, so kernels/cg.py's
// plain twins, which add in the same order, give the same bits.  A lane
// loads CG_AHEAD of its rows before it adds any of them (in order), so at
// c = 11 over 1.31M rows it keeps several loads in flight, not one.
//
// State.  Per column: rz, the best residual, |b|, alpha and pap of this
// iteration, and snapshots of rz, the best residual and done taken at the
// iteration's start (cg_step_x writes them; cg_step_p's vector updates read
// them while its block 0 updates the live values); the scalars best_mean,
// since, it and stop, the flag the host reads after each iteration.
#include "common.cuh"

#define CG_THREADS 256
// Most floats of a stage-2 tree in shared memory (nb t <= this).
#define CG_TREE 8192
// Rows a lane loads before it adds the first of them.
#define CG_AHEAD 4

// Views into the wrapper's float state (7 t + 1) and int state (3 t + 3).
struct CgState {
  float *rz, *res_best, *b_norm, *alpha, *pap, *rz_prev, *res_best_prev, *best_mean;
  int *done, *done_prev, *t_alive, *since, *it, *stop;
};

__device__ inline CgState cg_state(float* f, int* i, int t) {
  return CgState{f, f + t, f + 2 * t, f + 3 * t, f + 4 * t, f + 5 * t, f + 6 * t, f + 7 * t,
                 i, i + t, i + 2 * t, i + 3 * t, i + 3 * t + 1, i + 3 * t + 2};
}

// Stage 1's fold: lane (rr, col) holds acc; returns nothing, leaves the block's
// sum of column col in sm[col].  Every thread of the block must call it.
__device__ __forceinline__ void cg_block_fold(float acc, float* sm, int rr, int col, int t, int rp) {
  if (rr < rp) sm[rr * t + col] = acc;
  __syncthreads();
  for (int h = rp >> 1; h > 0; h >>= 1) {
    if (rr < h) sm[rr * t + col] = __fadd_rn(sm[rr * t + col], sm[(rr + h) * t + col]);
    __syncthreads();
  }
}

// Stage 2: the column sums of part (P, nb, t), rank q's block at part + q pstride:
// each rank's nb partials folded in halves over the rows, then the P rank sums
// added in rank order; leaves them in sm[0 .. t).  Every thread of the block
// must call it.
__device__ __forceinline__ void cg_sum_partials(const float* __restrict__ part, int P, long long pstride, int nb,
                                                int t, float* sm) {
  float s = 0.0f;
  for (int q = 0; q < P; ++q) {
    const float* __restrict__ pq = part + q * pstride;
    for (int e = threadIdx.x; e < nb * t; e += blockDim.x) sm[e] = pq[e];
    __syncthreads();
    for (int h = nb >> 1; h > 0; h >>= 1) {
      for (int e = threadIdx.x; e < h * t; e += blockDim.x) sm[e] = __fadd_rn(sm[e], sm[e + h * t]);
      __syncthreads();
    }
    if (threadIdx.x < t) s = q == 0 ? sm[threadIdx.x] : __fadd_rn(s, sm[threadIdx.x]);
    __syncthreads();  // the next rank's load overwrites sm
  }
  if (threadIdx.x < t) sm[threadIdx.x] = s;
  __syncthreads();
}

__device__ __forceinline__ float cg_nanmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

// Partial sums of u . v over the columns; with scale, v is first replaced by
// scale v + noise u (the shifted operator s K p + noise p), written to out.
__global__ void cg_dot_kernel(const float* __restrict__ u, const float* __restrict__ v,
                              const float* __restrict__ scale, const float* __restrict__ noise,
                              float* __restrict__ out, int n, int t, int rp, float* __restrict__ part) {
  __shared__ float sm[CG_THREADS];
  const int rr = threadIdx.x / t, col = threadIdx.x - rr * t;
  float acc = 0.0f;
  if (rr < rp) {
    const float s = scale != nullptr ? *scale : 0.0f, nz = scale != nullptr ? *noise : 0.0f;
    const long long stride = (long long)gridDim.x * rp;
    long long i = (long long)blockIdx.x * rp + rr;
    for (; i + (CG_AHEAD - 1) * stride < n; i += CG_AHEAD * stride) {
      float a[CG_AHEAD], w[CG_AHEAD];
#pragma unroll
      for (int k = 0; k < CG_AHEAD; ++k) {
        const long long e = (i + k * stride) * t + col;
        a[k] = u[e];
        w[k] = v[e];
      }
#pragma unroll
      for (int k = 0; k < CG_AHEAD; ++k) {
        if (scale != nullptr) {
          w[k] = __fadd_rn(__fmul_rn(s, w[k]), __fmul_rn(nz, a[k]));
          out[(i + k * stride) * t + col] = w[k];
        }
        acc = __fadd_rn(acc, __fmul_rn(a[k], w[k]));
      }
    }
    for (; i < n; i += stride) {
      const long long e = i * t + col;
      float w = v[e];
      if (scale != nullptr) {
        w = __fadd_rn(__fmul_rn(s, w), __fmul_rn(nz, u[e]));
        out[e] = w;
      }
      acc = __fadd_rn(acc, __fmul_rn(u[e], w));
    }
  }
  cg_block_fold(acc, sm, rr, col, t, rp);
  if (threadIdx.x < t) part[(long long)blockIdx.x * t + threadIdx.x] = sm[threadIdx.x];
}

// pap from its partials (P ranks'); alpha; x += alpha p, r -= alpha ap; this
// rank's partials of r . r.  Block 0 writes alpha, pap and the iteration's snapshots.
__global__ void cg_step_x_kernel(const float* __restrict__ part_pap, int P, long long pap_stride,
                                 float* __restrict__ x, float* __restrict__ r, const float* __restrict__ p,
                                 const float* __restrict__ ap, int n, int t, int rp, float* fs, int* is,
                                 float* __restrict__ part_rr) {
  const CgState st = cg_state(fs, is, t);
  __shared__ float sm[CG_TREE];
  __shared__ float alpha_s[CG_THREADS];
  cg_sum_partials(part_pap, P, pap_stride, gridDim.x, t, sm);
  if (threadIdx.x < t) {
    const int col = threadIdx.x;
    const float pap = sm[col], rz = st.rz[col];
    const int done = st.done[col];
    const float alpha = (done || pap <= 0.0f) ? 0.0f : __fdiv_rn(rz, pap);
    alpha_s[col] = alpha;
    if (blockIdx.x == 0) {
      st.alpha[col] = alpha;
      st.pap[col] = pap;
      st.rz_prev[col] = rz;
      st.done_prev[col] = done;
      st.res_best_prev[col] = st.res_best[col];
    }
  }
  __syncthreads();
  const int rr = threadIdx.x / t, col = threadIdx.x - rr * t;
  float acc = 0.0f;
  if (rr < rp) {
    const float alpha = alpha_s[col];
    const long long stride = (long long)gridDim.x * rp;
    long long i = (long long)blockIdx.x * rp + rr;
    for (; i + (CG_AHEAD - 1) * stride < n; i += CG_AHEAD * stride) {
      float xs[CG_AHEAD], ps[CG_AHEAD], rs[CG_AHEAD], as[CG_AHEAD];
#pragma unroll
      for (int k = 0; k < CG_AHEAD; ++k) {
        const long long e = (i + k * stride) * t + col;
        xs[k] = x[e];
        ps[k] = p[e];
        rs[k] = r[e];
        as[k] = ap[e];
      }
#pragma unroll
      for (int k = 0; k < CG_AHEAD; ++k) {
        const long long e = (i + k * stride) * t + col;
        x[e] = __fadd_rn(xs[k], __fmul_rn(alpha, ps[k]));
        const float rn = __fsub_rn(rs[k], __fmul_rn(alpha, as[k]));
        r[e] = rn;
        acc = __fadd_rn(acc, __fmul_rn(rn, rn));
      }
    }
    for (; i < n; i += stride) {
      const long long e = i * t + col;
      x[e] = __fadd_rn(x[e], __fmul_rn(alpha, p[e]));
      const float rn = __fsub_rn(r[e], __fmul_rn(alpha, ap[e]));
      r[e] = rn;
      acc = __fadd_rn(acc, __fmul_rn(rn, rn));
    }
  }
  __syncthreads();  // sm is reused by the fold
  cg_block_fold(acc, sm, rr, col, t, rp);
  if (threadIdx.x < t) part_rr[(long long)blockIdx.x * t + threadIdx.x] = sm[threadIdx.x];
}

// The Woodbury solve's middle: g (k, t) scaled by w (k,) row by row.
__global__ void cg_scale_kernel(const float* __restrict__ g, const float* __restrict__ w, int k, int t,
                                float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < k * t) out[e] = __fmul_rn(w[e / t], g[e]);
}

// z = r / noise - h (h = U (w . U^T r)); partials of r . z.
__global__ void cg_precond_kernel(const float* __restrict__ r, const float* __restrict__ h,
                                  const float* __restrict__ noise, float* __restrict__ z, int n, int t, int rp,
                                  float* __restrict__ part) {
  __shared__ float sm[CG_THREADS];
  const int rr = threadIdx.x / t, col = threadIdx.x - rr * t;
  float acc = 0.0f;
  if (rr < rp) {
    const float nz = *noise;
    const long long stride = (long long)gridDim.x * rp;
    long long i = (long long)blockIdx.x * rp + rr;
    for (; i + (CG_AHEAD - 1) * stride < n; i += CG_AHEAD * stride) {
      float rs[CG_AHEAD], hs[CG_AHEAD];
#pragma unroll
      for (int k = 0; k < CG_AHEAD; ++k) {
        const long long e = (i + k * stride) * t + col;
        rs[k] = r[e];
        hs[k] = h[e];
      }
#pragma unroll
      for (int k = 0; k < CG_AHEAD; ++k) {
        const float ze = __fsub_rn(__fdiv_rn(rs[k], nz), hs[k]);
        z[(i + k * stride) * t + col] = ze;
        acc = __fadd_rn(acc, __fmul_rn(rs[k], ze));
      }
    }
    for (; i < n; i += stride) {
      const long long e = i * t + col;
      const float re = r[e];
      const float ze = __fsub_rn(__fdiv_rn(re, nz), h[e]);
      z[e] = ze;
      acc = __fadd_rn(acc, __fmul_rn(re, ze));
    }
  }
  cg_block_fold(acc, sm, rr, col, t, rp);
  if (threadIdx.x < t) part[(long long)blockIdx.x * t + threadIdx.x] = sm[threadIdx.x];
}

struct CgRules {
  float tol;
  int floor, max_iters, stall_window, column_mode, m;
};

// rz_new and r . r from their partials (P ranks'); beta; p = z + beta p; the best
// iterate; block 0: the best residual, the record, the stall guard, the stop
// rules, rz, it and the stop flag.
__global__ void cg_step_p_kernel(const float* __restrict__ part_rz, const float* __restrict__ part_rr, int P,
                                 long long rz_stride, long long rr_stride,
                                 const float* __restrict__ x, const float* __restrict__ z, float* __restrict__ p,
                                 float* __restrict__ x_best, int n, int t, int rp, float* fs, int* is,
                                 float* __restrict__ rec_a, float* __restrict__ rec_b, int* __restrict__ rec_m,
                                 const CgRules rules) {
  const CgState st = cg_state(fs, is, t);
  __shared__ float sm[CG_TREE];
  __shared__ float rzn_s[CG_THREADS], beta_s[CG_THREADS], res_s[CG_THREADS], rb_s[CG_THREADS];
  __shared__ int better_s[CG_THREADS], broken_s[CG_THREADS], done_s[CG_THREADS];
  __shared__ int stop_all_s, stalled_s;
  cg_sum_partials(part_rz, P, rz_stride, gridDim.x, t, sm);
  if (threadIdx.x < t) rzn_s[threadIdx.x] = sm[threadIdx.x];
  __syncthreads();
  cg_sum_partials(part_rr, P, rr_stride, gridDim.x, t, sm);
  if (threadIdx.x < t) {
    const int col = threadIdx.x;
    const int done = st.done_prev[col];
    const float pap = st.pap[col], rz = st.rz_prev[col], rzn = rzn_s[col];
    const int broken = !done && (pap <= 0.0f || rzn < 0.0f);
    beta_s[col] = (done || broken || rz == 0.0f) ? 0.0f : __fdiv_rn(rzn, rz);
    const float res = __fdiv_rn(__fsqrt_rn(sm[col]), st.b_norm[col]);
    res_s[col] = res;
    better_s[col] = res < st.res_best_prev[col];
    broken_s[col] = broken;
  }
  __syncthreads();
  const int rr = threadIdx.x / t, col = threadIdx.x - rr * t;
  if (rr < rp) {
    const float beta = beta_s[col];
    const int better = better_s[col];
    const long long stride = (long long)gridDim.x * rp;
    long long i = (long long)blockIdx.x * rp + rr;
    for (; i + (CG_AHEAD - 1) * stride < n; i += CG_AHEAD * stride) {
      float zs[CG_AHEAD], ps[CG_AHEAD], xs[CG_AHEAD];
#pragma unroll
      for (int k = 0; k < CG_AHEAD; ++k) {
        const long long e = (i + k * stride) * t + col;
        zs[k] = z[e];
        ps[k] = p[e];
        if (better) xs[k] = x[e];
      }
#pragma unroll
      for (int k = 0; k < CG_AHEAD; ++k) {
        const long long e = (i + k * stride) * t + col;
        p[e] = __fadd_rn(zs[k], __fmul_rn(beta, ps[k]));
        if (better) x_best[e] = xs[k];
      }
    }
    for (; i < n; i += stride) {
      const long long e = i * t + col;
      p[e] = __fadd_rn(z[e], __fmul_rn(beta, p[e]));
      if (better) x_best[e] = x[e];
    }
  }
  if (blockIdx.x != 0) return;
  const int it = *st.it;
  if (threadIdx.x < t) {
    const int c = threadIdx.x;
    rb_s[c] = cg_nanmin(res_s[c], st.res_best_prev[c]);
    st.res_best[c] = rb_s[c];
    // A step is a valid Lanczos step only while the column has never converged or broken down.
    const int ok = st.t_alive[c] && !st.done_prev[c] && st.pap[c] > 0.0f && st.rz_prev[c] > 0.0f;
    if (rules.m > 0 && ok && it < rules.m) {
      const int k = it < rules.m - 1 ? it : rules.m - 1;
      rec_a[k * t + c] = st.alpha[c];
      rec_b[k * t + c] = beta_s[c];
      rec_m[k * t + c] = 1;
    }
    st.t_alive[c] = ok;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // Column means in column order, as the plain twin sums them.
    float sb = rb_s[0], sr = res_s[0];
    for (int c = 1; c < t; ++c) {
      sb = __fadd_rn(sb, rb_s[c]);
      sr = __fadd_rn(sr, res_s[c]);
    }
    const float m_best = __fdiv_rn(sb, (float)t), m_res = __fdiv_rn(sr, (float)t);
    const float bm = *st.best_mean;
    const int improved = m_best < __fmul_rn(0.99f, bm);
    *st.best_mean = improved ? m_best : bm;
    const int since = improved ? 0 : *st.since + 1;
    *st.since = since;
    const int past_floor = it + 1 >= rules.floor;
    stalled_s = rules.stall_window > 0 && since >= rules.stall_window && past_floor;
    stop_all_s = m_res < rules.tol && past_floor;
  }
  __syncthreads();
  if (threadIdx.x < t) {
    const int c = threadIdx.x;
    const float res = res_s[c];
    int done = st.done_prev[c] || stalled_s || broken_s[c];
    if (rules.column_mode)
      done = done || (res < rules.tol && it + 1 >= rules.floor);
    else
      done = done || stop_all_s || res < 1e-10f;
    st.done[c] = done;
    done_s[c] = done;
    st.rz[c] = rzn_s[c];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int all = 1;
    for (int c = 0; c < t; ++c) all = all && done_s[c];
    *st.it = it + 1;
    *st.stop = all || it + 1 >= rules.max_iters;
  }
}

// The state at iteration 0 from the partials (P ranks') of b . b and r0 . z0.
__global__ void cg_init_kernel(const float* __restrict__ part_bb, const float* __restrict__ part_rz, int P,
                               long long bb_stride, long long rz_stride, int nb, int t, float* fs, int* is,
                               int max_iters) {
  const CgState st = cg_state(fs, is, t);
  __shared__ float sm[CG_TREE];
  __shared__ float bb_s[CG_THREADS];
  cg_sum_partials(part_bb, P, bb_stride, nb, t, sm);
  if (threadIdx.x < t) bb_s[threadIdx.x] = sm[threadIdx.x];
  __syncthreads();
  cg_sum_partials(part_rz, P, rz_stride, nb, t, sm);
  if (threadIdx.x < t) {
    const int c = threadIdx.x;
    const float norm = __fsqrt_rn(bb_s[c]);
    const float bn = norm == 0.0f ? 1.0f : norm;
    st.b_norm[c] = bn;
    st.res_best[c] = __fdiv_rn(norm, bn);
    st.rz[c] = sm[c];
    st.done[c] = 0;
    st.t_alive[c] = 1;
  }
  if (threadIdx.x == 0) {
    *st.best_mean = __int_as_float(0x7f800000);  // +inf
    *st.since = 0;
    *st.it = 0;
    *st.stop = max_iters <= 0;
  }
}

static inline bool cg_shape_ok(int n, int t, int rp, int nb) {
  return n > 0 && t > 0 && t <= CG_THREADS && rp > 0 && rp * t <= CG_THREADS && nb > 0 && nb * t <= CG_TREE;
}

// u, v, out: (n, t); part: (nb, t); scale, noise: device scalars or null.
extern "C" int sgp_cg_dot(const float* u, const float* v, const float* scale, const float* noise, float* out, int n,
                          int t, int rp, int nb, float* part, void* stream) {
  if (!cg_shape_ok(n, t, rp, nb)) return (int)cudaErrorInvalidValue;
  cg_dot_kernel<<<nb, CG_THREADS, 0, (cudaStream_t)stream>>>(u, v, scale, noise, out, n, t, rp, part);
  return (int)cudaGetLastError();
}

// part_pap: (P, nb, t), rank q's block at part_pap + q pap_stride.
extern "C" int sgp_cg_step_x(const float* part_pap, int P, long long pap_stride, float* x, float* r, const float* p,
                             const float* ap, int n, int t, int rp, int nb, float* fs, int* is, float* part_rr,
                             void* stream) {
  if (!cg_shape_ok(n, t, rp, nb) || P < 1) return (int)cudaErrorInvalidValue;
  cg_step_x_kernel<<<nb, CG_THREADS, 0, (cudaStream_t)stream>>>(part_pap, P, pap_stride, x, r, p, ap, n, t, rp, fs,
                                                               is, part_rr);
  return (int)cudaGetLastError();
}

extern "C" int sgp_cg_scale(const float* g, const float* w, int k, int t, float* out, void* stream) {
  if (k <= 0 || t <= 0) return (int)cudaErrorInvalidValue;
  cg_scale_kernel<<<sgp_blocks((long long)k * t), SGP_THREADS, 0, (cudaStream_t)stream>>>(g, w, k, t, out);
  return (int)cudaGetLastError();
}

extern "C" int sgp_cg_precond(const float* r, const float* h, const float* noise, float* z, int n, int t, int rp,
                              int nb, float* part, void* stream) {
  if (!cg_shape_ok(n, t, rp, nb)) return (int)cudaErrorInvalidValue;
  cg_precond_kernel<<<nb, CG_THREADS, 0, (cudaStream_t)stream>>>(r, h, noise, z, n, t, rp, part);
  return (int)cudaGetLastError();
}

// part_rz, part_rr: (P, nb, t) with their rank strides; rec_a, rec_b, rec_m: the (m, t) record, or null
// with m = 0.
extern "C" int sgp_cg_step_p(const float* part_rz, const float* part_rr, int P, long long rz_stride,
                             long long rr_stride, const float* x, const float* z, float* p, float* x_best, int n,
                             int t, int rp, int nb, float* fs, int* is, float* rec_a, float* rec_b, int* rec_m, int m,
                             float tol, int floor, int max_iters, int stall_window, int column_mode, void* stream) {
  if (!cg_shape_ok(n, t, rp, nb) || m < 0 || P < 1) return (int)cudaErrorInvalidValue;
  const CgRules rules{tol, floor, max_iters, stall_window, column_mode, m};
  cg_step_p_kernel<<<nb, CG_THREADS, 0, (cudaStream_t)stream>>>(part_rz, part_rr, P, rz_stride, rr_stride, x, z, p,
                                                               x_best, n, t, rp, fs, is, rec_a, rec_b, rec_m, rules);
  return (int)cudaGetLastError();
}

extern "C" int sgp_cg_init(const float* part_bb, const float* part_rz, int P, long long bb_stride,
                           long long rz_stride, int nb, int t, float* fs, int* is, int max_iters, void* stream) {
  if (t <= 0 || t > CG_THREADS || nb <= 0 || nb * t > CG_TREE || P < 1) return (int)cudaErrorInvalidValue;
  cg_init_kernel<<<1, CG_THREADS, 0, (cudaStream_t)stream>>>(part_bb, part_rz, P, bb_stride, rz_stride, nb, t, fs, is,
                                                             max_iters);
  return (int)cudaGetLastError();
}
