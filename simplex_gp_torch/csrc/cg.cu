// K10: one iteration of batched preconditioned conjugate gradients over the
// t columns of an (n, t) block, with every rule of the JAX solver.
//
// Replaces the lax.while_loop body of simplex_gp_tpu/linalg/cg.py::cg_solve
// (:133-205): the column dots, alpha and beta with their guards, the x, r and
// p updates, the relative residual, the best iterate, the stall guard, the
// stop modes "mean" and "column", the breakdown freeze (pap <= 0, rz < 0) and
// the Lanczos tridiagonal record, written at a device-side iteration counter
// (JAX's k = min(it, m - 1)).  The MVM is the caller's (K3', K12, a matmul).
// A Woodbury preconditioner's solve (pivoted_cholesky.py::precond_solve,
// :242-253) is three kernels here that read U (n, k) themselves: cg_utr (the
// block partials of G = U^T r), cg_fold (G2 = w * G from the partials) and
// cg_precond (z = r / noise - U G2 and the partials of r . z); no cuBLAS call
// and no (n, t) buffer for U G2.
//
// Bound: memory traffic.  An iteration reads and writes about 17 (n, t)
// passes (x, r, p, the best iterate, A p, z) and reads U twice, so at t = 1
// the vector kernels are a few percent of it and the two reads of U the rest;
// at houseelectric's n = 1.31M and k = 100 that is 1.05 GB of U an iteration.
// The design keeps launches few (six an iteration besides the MVM, each a
// single pass over its vectors) and keeps every decision on the device, so
// one iteration can be captured in a CUDA graph and the host reads one stop
// flag per replay.  (A graph of four iterations, gated on the flag, measured
// within the run-to-run spread of one on an H100.)  The two passes over U
// stream tiles of rows into shared memory with cp.async, double-buffered, so
// a block's next tile is in flight while it computes on the last; at t = 11
// their 2 k t multiplies and adds a row are under a row's byte time, and
// every thread of a block holds a share of them (below).
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
// The passes over U have their own layout (kernels/cg.py::u_layout, fixed by
// n, k and t): nbu blocks, block b takes the rows [b rb, b rb + rb), in tiles
// of tr rows.  cg_utr: thread (lane l, group q) holds jb rows of U^T by tca
// columns of r and adds the products of the block's rows l, l + lanes, ... in
// turn; the lanes fold in halves and block b writes part[b, j, c]; cg_fold
// folds the nbu partials of each output in halves (then the ranks in order)
// and multiplies by w[j].  cg_precond: thread (row rl, segment s) of a tile
// sums U[i, j] G2[j, c] over its segment of j in order, the js segments of a
// row fold in halves (an xor butterfly, so every lane of the row holds h);
// lane s writes z[i, c] for its columns, and adds r z to its row lane's sum,
// tile by tile; the tr row lanes fold in halves into part[b, c], which
// cg_step_p folds over the nbu blocks.
// Sharded rows (K10', the data-parallel CG): each of P ranks writes its own
// (nb, t) partials, the caller all-gathers them into a (P, nb, t) buffer, and
// stage 2 folds each rank's nb partials as above, then adds the P rank sums
// in rank order 0 .. P-1.  Every rank reduces the same gathered bytes, so
// every stop decision is the same bits on every rank; P = 1 is the
// one-device arithmetic exactly.  G likewise: each rank folds its own cg_utr
// partials (cg_fold with w = 1), the ranks' G are all-gathered and cg_fold
// adds them in rank order and multiplies by w.
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
#include <algorithm>

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

// ---- the Woodbury solve's passes over U ------------------------------------

// One tile: rows [i0, i0 + rows) of U (n, k) to su and of r (n, t) to sr (both 16-byte aligned), as one
// commit group (an empty group when rows <= 0, so that every tile of the pipeline is one group).
__device__ __forceinline__ void cg_load_tile(float* su, float* sr, const float* U, const float* r, long long i0,
                                             long long rows, int k, int t) {
  if (rows > 0) {
    sgp_copy_async(su, U + i0 * k, (int)rows * k);
    sgp_copy_async(sr, r + i0 * t, (int)rows * t);
  }
  sgp_commit();
}

// Waits for the tile before the last one issued (one group may stay in flight), then for the block.
__device__ __forceinline__ void cg_wait_tile() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();
}

// Block partials of G = U^T r (k, t): block b takes rows [b rb, min(n, b rb + rb)) in tiles of tr rows,
// double-buffered in dynamic shared memory (two buffers of tr (k + t) floats).  Thread (lane l, group q),
// q = tid mod groups: rows j0 .. j0 + JB - 1 of U^T and columns c0 .. c0 + TCA - 1 of r; lane l < lanes adds
// the products of the block's rows l, l + lanes, ... in order (tr is a multiple of lanes, so each tile's row
// l is the lane's).  Then the lanes fold in halves, one thread an output, and block b writes
// part[b, j, c].  JB = 4 reads a row's four U values with one 16-byte load (k a multiple of 4).
template <int JB, int TCA>
__global__ void __launch_bounds__(CG_THREADS)
    cg_utr_kernel(const float* __restrict__ U, const float* __restrict__ r, int n, int k, int t, int rb, int tr,
                  int lanes, float* __restrict__ part) {
  extern __shared__ __align__(16) float smem[];
  const int tile = tr * (k + t);
  const long long row0 = (long long)blockIdx.x * rb;
  const long long row1 = min((long long)n, row0 + rb);
  const int tiles = row1 > row0 ? (int)((row1 - row0 + tr - 1) / tr) : 0;
  const int nj = (k + JB - 1) / JB, groups = nj * ((t + TCA - 1) / TCA);
  const int lane = threadIdx.x / groups, q = threadIdx.x - lane * groups;
  const int j0 = (q % nj) * JB, c0 = (q / nj) * TCA;
  float acc[JB][TCA];
#pragma unroll
  for (int a = 0; a < JB; ++a)
#pragma unroll
    for (int c = 0; c < TCA; ++c) acc[a][c] = 0.0f;
  cg_load_tile(smem, smem + tr * k, U, r, row0, min((long long)tr, row1 - row0), k, t);
  for (int m = 0; m < tiles; ++m) {
    const long long i0 = row0 + (long long)m * tr;
    if (m + 1 < tiles) {
      float* nxt = smem + ((m + 1) & 1) * tile;
      cg_load_tile(nxt, nxt + tr * k, U, r, i0 + tr, min((long long)tr, row1 - i0 - tr), k, t);
    } else {
      cg_load_tile(nullptr, nullptr, U, r, 0, 0, k, t);
    }
    cg_wait_tile();
    if (lane < lanes) {
      const float* su = smem + (m & 1) * tile;
      const float* sr = su + tr * k;
      const int rows = (int)min((long long)tr, row1 - i0);
      for (int ii = lane; ii < rows; ii += lanes) {
        float u[JB], v[TCA];
        if (JB == 4) {
          const float4 u4 = *reinterpret_cast<const float4*>(su + ii * k + j0);
          u[0] = u4.x;
          u[1 % JB] = u4.y;
          u[2 % JB] = u4.z;
          u[3 % JB] = u4.w;
        } else {
          u[0] = su[ii * k + j0];
        }
#pragma unroll
        for (int c = 0; c < TCA; ++c) v[c] = c0 + c < t ? sr[ii * t + c0 + c] : 0.0f;
#pragma unroll
        for (int a = 0; a < JB; ++a)
#pragma unroll
          for (int c = 0; c < TCA; ++c) acc[a][c] = __fadd_rn(acc[a][c], __fmul_rn(u[a], v[c]));
      }
    }
    __syncthreads();  // the next iteration's copy overwrites this buffer
  }
  // The lanes' sums: red (lanes, k t) over the tile buffers, folded in halves one output a thread.
  const int kt = k * t;
  float* red = smem;
  if (lane < lanes)
#pragma unroll
    for (int a = 0; a < JB; ++a)
#pragma unroll
      for (int c = 0; c < TCA; ++c)
        if (j0 + a < k && c0 + c < t) red[lane * kt + (j0 + a) * t + c0 + c] = acc[a][c];
  __syncthreads();
  for (int o = threadIdx.x; o < kt; o += blockDim.x) {
    for (int h = lanes >> 1; h > 0; h >>= 1)
      for (int l = 0; l < h; ++l) red[l * kt + o] = __fadd_rn(red[l * kt + o], red[(l + h) * kt + o]);
    part[(long long)blockIdx.x * kt + o] = red[o];
  }
}

// out (k, t) = w[j] * (the sum of part (P, nb, k t)): each rank's nb partials of an output folded in halves
// in shared memory, the P rank sums added in rank order 0 .. P-1, then one product with w.  A block takes
// `width` outputs (nb width <= CG_TREE), few enough that a thread loads about eight partials a rank and the
// grid has a block for every eight outputs or so (the grouping does not change any output's order).
__global__ void cg_fold_kernel(const float* __restrict__ part, int P, long long pstride, int nb, int kt, int t,
                               int width, const float* __restrict__ w, float* __restrict__ out) {
  __shared__ float sm[CG_TREE];
  const int o0 = blockIdx.x * width, cnt = min(width, kt - o0);
  float s = 0.0f;
  for (int q = 0; q < P; ++q) {
    const float* __restrict__ pq = part + q * pstride;
#pragma unroll 8
    for (int e = threadIdx.x; e < nb * cnt; e += blockDim.x) {
      const int b = e / cnt, oo = e - b * cnt;
      sm[b * width + oo] = pq[(long long)b * kt + o0 + oo];
    }
    __syncthreads();
    for (int h = nb >> 1; h > 0; h >>= 1) {
      for (int e = threadIdx.x; e < h * width; e += blockDim.x) sm[e] = __fadd_rn(sm[e], sm[e + h * width]);
      __syncthreads();
    }
    if (threadIdx.x < cnt) s = q == 0 ? sm[threadIdx.x] : __fadd_rn(s, sm[threadIdx.x]);
    __syncthreads();  // the next rank's load overwrites sm
  }
  if (threadIdx.x < cnt) {
    const int o = o0 + threadIdx.x;
    out[o] = __fmul_rn(w[o / t], s);
  }
}

// z = r / noise - U G2 and the block partials of r . z, in cg_utr's blocks and tiles (dynamic shared memory:
// two tile buffers of tr (k + t) floats, G2 as (k, tpad) with zeros past t, and the (tr, t) row lanes' sums
// of r z).  Thread (row rl, segment s), tid = rl js + s, js tr = 256: the sum of U[i, j] G2[j, c] over j in
// its segment [s ks, s ks + ks) in order, TC columns at a time; the js segments fold in halves by an xor
// butterfly (every lane of the row ends with the same h); then lane s writes z[i, c] for the chunk's columns
// c = c0 + s, c0 + s + js, ... and adds r z to sacc[rl, c].  After the last tile the tr row lanes fold in
// halves into part[b, c].
template <int TC>
__global__ void __launch_bounds__(CG_THREADS)
    cg_precond_kernel(const float* __restrict__ U, const float* __restrict__ G2, const float* __restrict__ r,
                      const float* __restrict__ noise, float* __restrict__ z, int n, int k, int t, int rb, int tr,
                      int js, float* __restrict__ part) {
  extern __shared__ __align__(16) float smem[];
  const int tile = tr * (k + t), tpad = (t + 3) & ~3;
  float* sg = smem + 2 * tile;
  float* sacc = sg + k * tpad;
  const long long row0 = (long long)blockIdx.x * rb;
  const long long row1 = min((long long)n, row0 + rb);
  const int tiles = row1 > row0 ? (int)((row1 - row0 + tr - 1) / tr) : 0;
  cg_load_tile(smem, smem + tr * k, U, r, row0, min((long long)tr, row1 - row0), k, t);
  for (int e = threadIdx.x; e < k * tpad; e += blockDim.x) {
    const int j = e / tpad, c = e - j * tpad;
    sg[e] = c < t ? G2[j * t + c] : 0.0f;
  }
  for (int e = threadIdx.x; e < tr * t; e += blockDim.x) sacc[e] = 0.0f;
  const int s = threadIdx.x % js, rl = threadIdx.x / js;
  const int ks = (k + js - 1) / js, ja = min(k, s * ks), jz = min(k, ja + ks);
  const float nz = *noise;
  for (int m = 0; m < tiles; ++m) {
    const long long i0 = row0 + (long long)m * tr;
    if (m + 1 < tiles) {
      float* nxt = smem + ((m + 1) & 1) * tile;
      cg_load_tile(nxt, nxt + tr * k, U, r, i0 + tr, min((long long)tr, row1 - i0 - tr), k, t);
    } else {
      cg_load_tile(nullptr, nullptr, U, r, 0, 0, k, t);
    }
    cg_wait_tile();
    // Every lane computes (a row past the tile's end on stale data, never written), so the butterfly's
    // shuffles see whole warps.
    const float* su = smem + (m & 1) * tile + rl * k;
    const float* sr = smem + (m & 1) * tile + tr * k + rl * t;
    const bool valid = i0 + rl < row1;
    const long long i = i0 + rl;
    for (int c0 = 0; c0 < t; c0 += TC) {
      float acc[TC];
#pragma unroll
      for (int c = 0; c < TC; ++c) acc[c] = 0.0f;
      for (int j = ja; j < jz; ++j) {
        const float u = su[j];
        const float* g = sg + j * tpad + c0;
        float gv[TC];
        if (TC == 1) {
          gv[0] = g[0];
        } else {
#pragma unroll
          for (int c = 0; c < TC; c += 4) {
            const float4 g4 = *reinterpret_cast<const float4*>(g + c);
            gv[c] = g4.x;
            gv[(c + 1) % TC] = g4.y;
            gv[(c + 2) % TC] = g4.z;
            gv[(c + 3) % TC] = g4.w;
          }
        }
#pragma unroll
        for (int c = 0; c < TC; ++c) acc[c] = __fadd_rn(acc[c], __fmul_rn(u, gv[c]));
      }
      for (int off = js >> 1; off > 0; off >>= 1)
#pragma unroll
        for (int c = 0; c < TC; ++c) acc[c] = __fadd_rn(acc[c], __shfl_xor_sync(0xffffffffu, acc[c], off, js));
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const int col = c0 + c;
        if (c % js == s && col < t && valid) {
          const float rv = sr[col];
          const float zv = __fsub_rn(__fdiv_rn(rv, nz), acc[c]);
          z[i * t + col] = zv;
          sacc[rl * t + col] = __fadd_rn(sacc[rl * t + col], __fmul_rn(rv, zv));
        }
      }
    }
    __syncthreads();  // the next iteration's copy overwrites this buffer
  }
  __syncthreads();  // sacc's zeros, for a block without rows
  for (int c = threadIdx.x; c < t; c += blockDim.x) {
    for (int h = tr >> 1; h > 0; h >>= 1)
      for (int l = 0; l < h; ++l) sacc[l * t + c] = __fadd_rn(sacc[l * t + c], sacc[(l + h) * t + c]);
    part[(long long)blockIdx.x * t + c] = sacc[c];
  }
}

struct CgRules {
  float tol;
  int floor, max_iters, stall_window, column_mode, m;
};

// rz_new and r . r from their partials (P ranks'; r . z's from nb_rz blocks: cg_precond's nbu, or the
// dots' nb); beta; p = z + beta p; the best
// iterate; block 0: the best residual, the record, the stall guard, the stop
// rules, rz, it and the stop flag.
__global__ void cg_step_p_kernel(const float* __restrict__ part_rz, const float* __restrict__ part_rr, int P,
                                 long long rz_stride, long long rr_stride, int nb_rz,
                                 const float* __restrict__ x, const float* __restrict__ z, float* __restrict__ p,
                                 float* __restrict__ x_best, int n, int t, int rp, float* fs, int* is,
                                 float* __restrict__ rec_a, float* __restrict__ rec_b, int* __restrict__ rec_m,
                                 const CgRules rules) {
  const CgState st = cg_state(fs, is, t);
  __shared__ float sm[CG_TREE];
  __shared__ float rzn_s[CG_THREADS], beta_s[CG_THREADS], res_s[CG_THREADS], rb_s[CG_THREADS];
  __shared__ int better_s[CG_THREADS], broken_s[CG_THREADS], done_s[CG_THREADS];
  __shared__ int stop_all_s, stalled_s;
  cg_sum_partials(part_rz, P, rz_stride, nb_rz, t, sm);
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

// The state at iteration 0 from the partials (P ranks') of b . b (nb blocks) and r0 . z0 (nb_rz blocks).
__global__ void cg_init_kernel(const float* __restrict__ part_bb, const float* __restrict__ part_rz, int P,
                               long long bb_stride, long long rz_stride, int nb, int nb_rz, int t, float* fs, int* is,
                               int max_iters) {
  const CgState st = cg_state(fs, is, t);
  __shared__ float sm[CG_TREE];
  __shared__ float bb_s[CG_THREADS];
  cg_sum_partials(part_bb, P, bb_stride, nb, t, sm);
  if (threadIdx.x < t) bb_s[threadIdx.x] = sm[threadIdx.x];
  __syncthreads();
  cg_sum_partials(part_rz, P, rz_stride, nb_rz, t, sm);
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

// Dynamic shared memory above the default 48 KB needs the kernel's opt-in (a host call, not a stream
// operation, so a captured launch keeps it).  ``opted`` is the launcher's own record of the largest size set
// on each device, so the attribute is set once a size, not at every launch.
constexpr int CG_OPTIN_DEVICES = 64;

template <typename Kernel>
static inline int cg_smem_optin(Kernel kernel, size_t bytes, int* opted) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  const int rc = (int)cudaGetDevice(&dev);
  if (rc != 0) return rc;
  if (dev < CG_OPTIN_DEVICES && opted[dev] >= (int)bytes) return 0;
  const int set = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (set == 0 && dev < CG_OPTIN_DEVICES) opted[dev] = (int)bytes;
  return set;
}

static inline bool cg_u_ok(int n, int k, int t, int nb, int rb, int tr) {
  return n > 0 && k > 0 && t > 0 && nb > 0 && (nb & (nb - 1)) == 0 && rb > 0 && rb % 4 == 0 && tr >= 8 &&
         (tr & (tr - 1)) == 0 && (long long)nb * rb >= n;
}

template <int JB, int TCA>
static int launch_utr(const float* U, const float* r, int n, int k, int t, int nb, int rb, int tr, int lanes,
                      float* part, cudaStream_t st) {
  const size_t smem = 4 * (size_t)std::max(2 * tr * (k + t), lanes * k * t);
  static int opted[CG_OPTIN_DEVICES] = {};
  const int rc = cg_smem_optin(cg_utr_kernel<JB, TCA>, smem, opted);
  if (rc != 0) return rc;
  cg_utr_kernel<JB, TCA><<<nb, CG_THREADS, smem, st>>>(U, r, n, k, t, rb, tr, lanes, part);
  return (int)cudaGetLastError();
}

// U (n, k), r (n, t), both 16-byte aligned; part (nb, k, t); the layout is kernels/cg.py::u_layout's.
extern "C" int sgp_cg_utr(const float* U, const float* r, int n, int k, int t, int nb, int rb, int tr, int lanes,
                          int jb, int tca, float* part, void* stream) {
  const int groups = ((k + jb - 1) / jb) * ((t + tca - 1) / tca);
  if (!cg_u_ok(n, k, t, nb, rb, tr) || lanes < 1 || lanes > tr || rb % lanes != 0 || lanes * groups > CG_THREADS ||
      (jb == 4 && k % 4 != 0) || ((uintptr_t)U | (uintptr_t)r) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (jb == 4 && tca == 12) return launch_utr<4, 12>(U, r, n, k, t, nb, rb, tr, lanes, part, st);
  if (jb == 4 && tca == 4) return launch_utr<4, 4>(U, r, n, k, t, nb, rb, tr, lanes, part, st);
  if (jb == 4 && tca == 1) return launch_utr<4, 1>(U, r, n, k, t, nb, rb, tr, lanes, part, st);
  if (jb == 1 && tca == 12) return launch_utr<1, 12>(U, r, n, k, t, nb, rb, tr, lanes, part, st);
  if (jb == 1 && tca == 4) return launch_utr<1, 4>(U, r, n, k, t, nb, rb, tr, lanes, part, st);
  if (jb == 1 && tca == 1) return launch_utr<1, 1>(U, r, n, k, t, nb, rb, tr, lanes, part, st);
  return (int)cudaErrorInvalidValue;
}

// part: (P, nb, k, t), rank q's block at part + q pstride; w (k,); out (k, t).
extern "C" int sgp_cg_fold(const float* part, int P, long long pstride, int nb, int k, int t, const float* w,
                           float* out, void* stream) {
  if (P < 1 || k <= 0 || t <= 0 || nb <= 0 || (nb & (nb - 1)) != 0 || nb > CG_TREE) return (int)cudaErrorInvalidValue;
  const int kt = k * t, width = std::max(1, std::min(8 * CG_THREADS / nb, std::min(CG_THREADS, CG_TREE / nb)));
  cg_fold_kernel<<<(kt + width - 1) / width, CG_THREADS, 0, (cudaStream_t)stream>>>(part, P, pstride, nb, kt, t,
                                                                                    width, w, out);
  return (int)cudaGetLastError();
}

template <int TC>
static int launch_precond(const float* U, const float* G2, const float* r, const float* noise, float* z, int n, int k,
                          int t, int nb, int rb, int tr, int js, float* part, cudaStream_t st) {
  const size_t smem = 4 * ((size_t)2 * tr * (k + t) + (size_t)k * ((t + 3) & ~3) + (size_t)tr * t);
  static int opted[CG_OPTIN_DEVICES] = {};
  const int rc = cg_smem_optin(cg_precond_kernel<TC>, smem, opted);
  if (rc != 0) return rc;
  cg_precond_kernel<TC><<<nb, CG_THREADS, smem, st>>>(U, G2, r, noise, z, n, k, t, rb, tr, js, part);
  return (int)cudaGetLastError();
}

// U (n, k) and r (n, t) 16-byte aligned, G2 (k, t), noise a device scalar; z (n, t); part (nb, t).  js, tc:
// the layout's segments a row (js tr = 256) and columns a thread holds at once.
extern "C" int sgp_cg_precond(const float* U, const float* G2, const float* r, const float* noise, float* z, int n,
                              int k, int t, int nb, int rb, int tr, int js, int tc, float* part, void* stream) {
  if (!cg_u_ok(n, k, t, nb, rb, tr) || js * tr != CG_THREADS || js > 32 || nb * t > CG_TREE ||
      ((uintptr_t)U | (uintptr_t)r) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (tc == 12) return launch_precond<12>(U, G2, r, noise, z, n, k, t, nb, rb, tr, js, part, st);
  if (tc == 4) return launch_precond<4>(U, G2, r, noise, z, n, k, t, nb, rb, tr, js, part, st);
  if (tc == 1) return launch_precond<1>(U, G2, r, noise, z, n, k, t, nb, rb, tr, js, part, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int sgp_cg_step_p(const float* part_rz, const float* part_rr, int P, long long rz_stride,
                             long long rr_stride, int nb_rz, const float* x, const float* z, float* p,
                             float* x_best, int n, int t, int rp, int nb, float* fs, int* is, float* rec_a,
                             float* rec_b, int* rec_m, int m, float tol, int floor, int max_iters, int stall_window,
                             int column_mode, void* stream) {
  if (!cg_shape_ok(n, t, rp, nb) || !cg_shape_ok(n, t, rp, nb_rz) || m < 0 || P < 1)
    return (int)cudaErrorInvalidValue;
  const CgRules rules{tol, floor, max_iters, stall_window, column_mode, m};
  cg_step_p_kernel<<<nb, CG_THREADS, 0, (cudaStream_t)stream>>>(part_rz, part_rr, P, rz_stride, rr_stride, nb_rz, x,
                                                               z, p, x_best, n, t, rp, fs, is, rec_a, rec_b, rec_m,
                                                               rules);
  return (int)cudaGetLastError();
}

// part_bb: (P, nb, t), part_rz: (P, nb_rz, t).
extern "C" int sgp_cg_init(const float* part_bb, const float* part_rz, int P, long long bb_stride,
                           long long rz_stride, int nb, int nb_rz, int t, float* fs, int* is, int max_iters,
                           void* stream) {
  if (t <= 0 || t > CG_THREADS || nb <= 0 || nb * t > CG_TREE || nb_rz <= 0 || nb_rz * t > CG_TREE || P < 1)
    return (int)cudaErrorInvalidValue;
  cg_init_kernel<<<1, CG_THREADS, 0, (cudaStream_t)stream>>>(part_bb, part_rz, P, bb_stride, rz_stride, nb, nb_rz, t,
                                                             fs, is, max_iters);
  return (int)cudaGetLastError();
}
