// K13, the SKIP root: cubic interpolation onto a 1-D grid and the rank-r
// Khatri-Rao products of the randomized range finder, without forming the
// (n, r^2) product M = R (.) F, M[i, a r + b] = R[i, a] F[i, b].
//
// Replaces simplex_gp_tpu/models/ski.py::SKIP._root (:87-124): the gather
// Fj = (w[:, :, None] * U[idx]).sum(1) (:108, after _interp_1d :46) and the
// Hadamard step M = R[:, :, None] * Fj[:, None, :] (:114-115), Y = M @ omega
// (:119) and B = Q.T @ M (:121), where XLA materialises M: 16 KB a row at
// r = 64, 1.07 GB at 65,536 rows and 6.6 GB at precipitation's 402,223, plus
// its cotangent under autodiff.
//
//   K13a sgp_ski_interp          F[i, :] = sum_t w[i, t] U[idx[i, t], :], the
//                                Keys weights and clipped taps computed in the
//                                thread from x[i] and the grid's origin and
//                                step (device scalars); one thread per (i, col).
//        sgp_ski_interp_scatter  its backward: dU[idx[i, t], :] += w[i, t] dF[i, :]
//                                in a fixed order, no atomics: a block owns a
//                                range of points, split into SKI_SCATTER_SLICES
//                                sub-ranges; thread (s, col) walks sub-range
//                                s in index order into column col of its own
//                                (g, r) slice in shared memory, the block adds
//                                its slices in order into its (g, r) partial,
//                                and a second pass adds the blocks' partials
//                                in block order (ski_gram_reduce_kernel), so
//                                dU repeats bit for bit.
//   K13b sgp_ski_kr_matmul       out = M W, W (r^2, k): a block takes 64 rows
//                                and all k columns; for each a it forms the
//                                (64, k) tile F W_a in registers (W_a = rows
//                                a r .. a r + r - 1 of W, staged in shared
//                                memory) and adds R[:, a] times it.
//   K13c sgp_ski_kr_gram         out = Q^T M, (k, r^2): a block takes four
//                                values of a and one row chunk and sums the
//                                (k, r) tiles Q^T (R[:, a] F) over the chunk
//                                in stages of 32 rows, each staged tile of Q
//                                and F serving the four; a second pass adds
//                                the chunks' partials in chunk order.  Two
//                                passes and no atomics, so it repeats bit
//                                for bit.
//   K13d sgp_ski_kr_adjoint      dR[i, a] = sum_b F[i, b] T_a[i, b] and
//                                dF[i, b] = sum_a R[i, a] T_a[i, b] with
//                                T_a = G W_a^T formed tile by tile in
//                                registers: a block takes 64 rows, keeps
//                                its dF tile in registers over all a, and
//                                reduces each dR entry over 16 lanes.
//
// Bound: K13b, K13c and K13d each do 2 n r^2 k multiply-adds' worth of f32
// FMA work (2 n r^3 flops at k = r: 34.4 GFLOP at n = 65,536, r = 64, a
// 0.51 ms bound at 67 TFLOP/s) against ~4 n r bytes of inputs, so they are
// compute-bound; K13a moves 4 n (r + 1) bytes and is byte-bound.  The
// design is the simple register-tiled form (4 x 4 outputs a thread, f32
// FMA, TF32 off); wgmma and TMA are later work.  r and k are at most 64.
#include "common.cuh"

#define SKI_MAX_R 64
#define SKI_TILE 64         // rows of a K13b / K13d block, and the column tile
#define SKI_STAGE 32        // rows of one K13c stage
#define SKI_GRAM_A 4        // values of a one K13c block takes
#define SKI_SCATTER_SLICES 4  // point sub-ranges of a K13a backward block, each with its own (g, r) slice

// The four clipped grid indices and normalised Keys weights of x
// (_interp_1d), each float operation an explicit round-to-nearest one in
// the order of kernels/ski.py::interp_taps, so the taps are its bit for bit.
__device__ __forceinline__ float ski_cubic(float s) {
  s = fabsf(s);
  const float w1 = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(__fmul_rn(1.5f, s), 2.5f), s), s), 1.0f);
  const float w2 = __fadd_rn(__fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(__fmul_rn(-0.5f, s), 2.5f), s), 4.0f), s), 2.0f);
  return s <= 1.0f ? w1 : (s <= 2.0f ? w2 : 0.0f);
}

__device__ __forceinline__ void ski_taps(float x, float gmin, float step, int g, int* idx, float* w) {
  const float pos = __fdiv_rn(__fsub_rn(x, gmin), step);
  const int base = (int)floorf(pos);
  float sum = 0.0f;
  for (int t = 0; t < 4; ++t) {
    const int i = base + t - 1;
    w[t] = ski_cubic(__fsub_rn(pos, (float)i));
    idx[t] = min(max(i, 0), g - 1);
    sum = __fadd_rn(sum, w[t]);
  }
  sum = fmaxf(sum, 1e-12f);
  for (int t = 0; t < 4; ++t) w[t] = __fdiv_rn(w[t], sum);
}

__global__ void ski_interp_kernel(const float* __restrict__ x, const float* __restrict__ gmin,
                                  const float* __restrict__ step, const float* __restrict__ U, int n, int g,
                                  int r, float* __restrict__ F) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)n * r) return;
  const long long i = e / r;
  const int col = (int)(e % r);
  int idx[4];
  float w[4];
  ski_taps(x[i], *gmin, *step, g, idx, w);
  float acc = 0.0f;
  for (int t = 0; t < 4; ++t) acc += w[t] * U[idx[t] * r + col];
  F[e] = acc;
}

// K13a's backward, first pass: block b owns the points [b S span, (b + 1) S
// span) (S = SKI_SCATTER_SLICES); thread (s, col) adds w[i, t] dF[i, col]
// into row idx[i, t] of its slice s for i in sub-range s ([(b S + s) span,
// + span)) in index order and t = 0..3, each add round-to-nearest; then
// the block's partial (g, r) is slice 0 + slice 1 + ... in order.
__global__ void __launch_bounds__(SKI_MAX_R * SKI_SCATTER_SLICES)
    ski_interp_scatter_kernel(const float* __restrict__ x, const float* __restrict__ gmin,
                              const float* __restrict__ step, const float* __restrict__ dF, int n, int g, int r,
                              int span, float* __restrict__ partial) {
  extern __shared__ float slices[];  // (S, g, r)
  const int size = g * r;
  for (int e = threadIdx.x; e < SKI_SCATTER_SLICES * size; e += blockDim.x) slices[e] = 0.0f;
  __syncthreads();
  const int s = threadIdx.x / SKI_MAX_R, col = threadIdx.x % SKI_MAX_R;
  if (col < r) {
    float* mine = slices + s * size;
    const float gm = *gmin, st = *step;
    const long long lo = ((long long)blockIdx.x * SKI_SCATTER_SLICES + s) * span;
    const long long hi = lo + span < n ? lo + span : n;
    for (long long i = lo; i < hi; ++i) {
      int idx[4];
      float w[4];
      ski_taps(x[i], gm, st, g, idx, w);
      const float v = dF[i * r + col];
      for (int t = 0; t < 4; ++t) mine[idx[t] * r + col] = __fadd_rn(mine[idx[t] * r + col], __fmul_rn(w[t], v));
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < size; e += blockDim.x) {
    float acc = slices[e];
    for (int k = 1; k < SKI_SCATTER_SLICES; ++k) acc = __fadd_rn(acc, slices[k * size + e]);
    partial[(long long)blockIdx.x * size + e] = acc;
  }
}

// out (n, k) = sum_a R[:, a] * (F @ W[a r : a r + r, :]).  Thread (ty, tx)
// holds rows ty + 16 m and columns tx + 16 q, m, q < 4.
__global__ void __launch_bounds__(256) ski_kr_matmul_kernel(const float* __restrict__ R,
                                                            const float* __restrict__ F,
                                                            const float* __restrict__ W, int n, int r, int k,
                                                            float* __restrict__ out) {
  __shared__ float Fs[SKI_TILE][SKI_TILE + 1];
  __shared__ float Ws[SKI_TILE][SKI_TILE];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long i0 = (long long)blockIdx.x * SKI_TILE;
  for (int e = tid; e < SKI_TILE * SKI_TILE; e += 256) {
    const int ii = e / SKI_TILE, c = e % SKI_TILE;
    const long long i = i0 + ii;
    Fs[ii][c] = (i < n && c < r) ? F[i * r + c] : 0.0f;
  }
  float acc[4][4];
  for (int m = 0; m < 4; ++m)
    for (int q = 0; q < 4; ++q) acc[m][q] = 0.0f;
  for (int a = 0; a < r; ++a) {
    __syncthreads();  // the previous W_a is consumed (at a = 0: Fs is written)
    for (int e = tid; e < SKI_TILE * SKI_TILE; e += 256) {
      const int b = e / SKI_TILE, c = e % SKI_TILE;
      Ws[b][c] = (b < r && c < k) ? W[((long long)a * r + b) * k + c] : 0.0f;
    }
    __syncthreads();
    float t[4][4];
    for (int m = 0; m < 4; ++m)
      for (int q = 0; q < 4; ++q) t[m][q] = 0.0f;
    for (int b = 0; b < r; ++b) {
      float fv[4], wv[4];
      for (int m = 0; m < 4; ++m) fv[m] = Fs[ty + 16 * m][b];
      for (int q = 0; q < 4; ++q) wv[q] = Ws[b][tx + 16 * q];
      for (int m = 0; m < 4; ++m)
        for (int q = 0; q < 4; ++q) t[m][q] = fmaf(fv[m], wv[q], t[m][q]);
    }
    for (int m = 0; m < 4; ++m) {
      const long long i = i0 + ty + 16 * m;
      const float ra = i < n ? R[i * r + a] : 0.0f;
      for (int q = 0; q < 4; ++q) acc[m][q] = fmaf(ra, t[m][q], acc[m][q]);
    }
  }
  for (int m = 0; m < 4; ++m) {
    const long long i = i0 + ty + 16 * m;
    if (i >= n) continue;
    for (int q = 0; q < 4; ++q) {
      const int c = tx + 16 * q;
      if (c < k) out[i * k + c] = acc[m][q];
    }
  }
}

// partial[chunk, p, a r + b] = sum over the chunk's rows of Q[i, p] R[i, a] F[i, b]:
// block (four values of a, chunk), so each staged tile of Q and F serves four
// a; thread (ty, tx) holds p = ty + 16 m and b = tx + 16 q for each of them.
__global__ void __launch_bounds__(256) ski_kr_gram_kernel(const float* __restrict__ Q, const float* __restrict__ R,
                                                          const float* __restrict__ F, int n, int r, int k,
                                                          int chunk_rows, float* __restrict__ partial) {
  __shared__ float Qs[SKI_STAGE][SKI_TILE];
  __shared__ float Fs[SKI_STAGE][SKI_TILE];
  __shared__ float Rs[SKI_STAGE][SKI_GRAM_A];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int a0 = blockIdx.x * SKI_GRAM_A, chunk = blockIdx.y;
  const long long c0 = (long long)chunk * chunk_rows;
  const long long c1 = c0 + chunk_rows < (long long)n ? c0 + chunk_rows : (long long)n;
  float acc[SKI_GRAM_A][4][4];
  for (int aa = 0; aa < SKI_GRAM_A; ++aa)
    for (int m = 0; m < 4; ++m)
      for (int q = 0; q < 4; ++q) acc[aa][m][q] = 0.0f;
  for (long long s = c0; s < c1; s += SKI_STAGE) {
    __syncthreads();
    for (int e = tid; e < SKI_STAGE * SKI_TILE; e += 256) {
      const int kk = e / SKI_TILE, c = e % SKI_TILE;
      const long long i = s + kk;
      const bool row = i < c1;
      Qs[kk][c] = (row && c < k) ? Q[i * k + c] : 0.0f;
      Fs[kk][c] = (row && c < r) ? F[i * r + c] : 0.0f;
    }
    if (tid < SKI_STAGE * SKI_GRAM_A) {
      const int kk = tid / SKI_GRAM_A, aa = tid % SKI_GRAM_A;
      const long long i = s + kk;
      Rs[kk][aa] = (i < c1 && a0 + aa < r) ? R[i * r + a0 + aa] : 0.0f;
    }
    __syncthreads();
    for (int kk = 0; kk < SKI_STAGE; ++kk) {
      float qv[4], fv[4];
      for (int m = 0; m < 4; ++m) qv[m] = Qs[kk][ty + 16 * m];
      for (int q = 0; q < 4; ++q) fv[q] = Fs[kk][tx + 16 * q];
      for (int aa = 0; aa < SKI_GRAM_A; ++aa) {
        const float ra = Rs[kk][aa];
        for (int q = 0; q < 4; ++q) {
          const float gv = ra * fv[q];
          for (int m = 0; m < 4; ++m) acc[aa][m][q] = fmaf(qv[m], gv, acc[aa][m][q]);
        }
      }
    }
  }
  const long long rr = (long long)r * r;
  float* dst = partial + (long long)chunk * k * rr;
  for (int aa = 0; aa < SKI_GRAM_A; ++aa) {
    const int a = a0 + aa;
    if (a >= r) continue;
    for (int m = 0; m < 4; ++m) {
      const int p = ty + 16 * m;
      if (p >= k) continue;
      for (int q = 0; q < 4; ++q) {
        const int b = tx + 16 * q;
        if (b < r) dst[p * rr + (long long)a * r + b] = acc[aa][m][q];
      }
    }
  }
}

__global__ void ski_gram_reduce_kernel(const float* __restrict__ partial, long long size, int chunks,
                                       float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= size) return;
  float s = 0.0f;
  for (int c = 0; c < chunks; ++c) s += partial[(long long)c * size + e];
  out[e] = s;
}

// dR, dF (n, r) of <G, M W>: block of 64 rows; thread (ty, tx) holds rows
// ty + 16 m and grid columns b = tx + 16 q of T_a and of dF.
__global__ void __launch_bounds__(256) ski_kr_adjoint_kernel(const float* __restrict__ R,
                                                             const float* __restrict__ F,
                                                             const float* __restrict__ W,
                                                             const float* __restrict__ G, int n, int r, int k,
                                                             float* __restrict__ dR, float* __restrict__ dF) {
  __shared__ float Gs[SKI_TILE][SKI_TILE + 1];
  __shared__ float Wt[SKI_TILE][SKI_TILE + 1];  // Wt[c][b] = W[a r + b, c]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long i0 = (long long)blockIdx.x * SKI_TILE;
  for (int e = tid; e < SKI_TILE * SKI_TILE; e += 256) {
    const int ii = e / SKI_TILE, c = e % SKI_TILE;
    const long long i = i0 + ii;
    Gs[ii][c] = (i < n && c < k) ? G[i * k + c] : 0.0f;
  }
  float fv[4][4], acc[4][4];
  for (int m = 0; m < 4; ++m) {
    const long long i = i0 + ty + 16 * m;
    for (int q = 0; q < 4; ++q) {
      const int b = tx + 16 * q;
      fv[m][q] = (i < n && b < r) ? F[i * r + b] : 0.0f;
      acc[m][q] = 0.0f;
    }
  }
  for (int a = 0; a < r; ++a) {
    __syncthreads();
    for (int e = tid; e < SKI_TILE * SKI_TILE; e += 256) {
      const int b = e / SKI_TILE, c = e % SKI_TILE;
      Wt[c][b] = (b < r && c < k) ? W[((long long)a * r + b) * k + c] : 0.0f;
    }
    __syncthreads();
    float t[4][4];
    for (int m = 0; m < 4; ++m)
      for (int q = 0; q < 4; ++q) t[m][q] = 0.0f;
    for (int c = 0; c < k; ++c) {
      float gv[4], wv[4];
      for (int m = 0; m < 4; ++m) gv[m] = Gs[ty + 16 * m][c];
      for (int q = 0; q < 4; ++q) wv[q] = Wt[c][tx + 16 * q];
      for (int m = 0; m < 4; ++m)
        for (int q = 0; q < 4; ++q) t[m][q] = fmaf(gv[m], wv[q], t[m][q]);
    }
    for (int m = 0; m < 4; ++m) {
      const long long i = i0 + ty + 16 * m;
      const float ra = i < n ? R[i * r + a] : 0.0f;
      float p = 0.0f;
      for (int q = 0; q < 4; ++q) {
        acc[m][q] = fmaf(ra, t[m][q], acc[m][q]);
        p = fmaf(fv[m][q], t[m][q], p);
      }
      // The 16 lanes of one ty sit in one half of a warp.
      for (int off = 8; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
      if (tx == 0 && i < n) dR[i * r + a] = p;
    }
  }
  for (int m = 0; m < 4; ++m) {
    const long long i = i0 + ty + 16 * m;
    if (i >= n) continue;
    for (int q = 0; q < 4; ++q) {
      const int b = tx + 16 * q;
      if (b < r) dF[i * r + b] = acc[m][q];
    }
  }
}

static unsigned int ski_row_blocks(int n) { return (unsigned int)((n + SKI_TILE - 1) / SKI_TILE); }

extern "C" int sgp_ski_interp(const float* x, const float* gmin, const float* step, const float* U, int n, int g,
                              int r, float* F, void* stream) {
  const long long work = (long long)n * r;
  if (work > 0)
    ski_interp_kernel<<<sgp_blocks(work), SGP_THREADS, 0, (cudaStream_t)stream>>>(x, gmin, step, U, n, g, r, F);
  return (int)cudaGetLastError();
}

// K13a's backward: blocks blocks of SKI_SCATTER_SLICES sub-ranges of span
// points (kernels/ski.py::_scatter_split); partial (blocks, g, r) need not
// be zeroed; dU (g, r) is written (partial itself when blocks == 1).  The
// S (g, r) slices must fit in a block's shared memory.
extern "C" int sgp_ski_interp_scatter(const float* x, const float* gmin, const float* step, const float* dF, int n,
                                      int g, int r, int span, int blocks, float* partial, float* dU, void* stream) {
  const size_t smem = (size_t)SKI_SCATTER_SLICES * g * r * sizeof(float);
  if (r > SKI_MAX_R || smem > 227 * 1024 || span < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  static size_t opted = 0;  // the shared-memory opt-in, set once a size
  if (smem > 48 * 1024 && smem > opted) {
    const cudaError_t err =
        cudaFuncSetAttribute(ski_interp_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted = smem;
  }
  ski_interp_scatter_kernel<<<blocks, SKI_MAX_R * SKI_SCATTER_SLICES, smem, st>>>(x, gmin, step, dF, n, g, r, span,
                                                                                 blocks == 1 ? dU : partial);
  if (blocks > 1) {
    const long long size = (long long)g * r;
    ski_gram_reduce_kernel<<<sgp_blocks(size), SGP_THREADS, 0, st>>>(partial, size, blocks, dU);
  }
  return (int)cudaGetLastError();
}

extern "C" int sgp_ski_kr_matmul(const float* R, const float* F, const float* W, int n, int r, int k, float* out,
                                 void* stream) {
  if (r > SKI_MAX_R || k > SKI_MAX_R) return (int)cudaErrorInvalidValue;
  if (n > 0)
    ski_kr_matmul_kernel<<<ski_row_blocks(n), 256, 0, (cudaStream_t)stream>>>(R, F, W, n, r, k, out);
  return (int)cudaGetLastError();
}

// partial: (chunks, k, r^2), or out itself when chunks == 1.
extern "C" int sgp_ski_kr_gram(const float* Q, const float* R, const float* F, int n, int r, int k, int chunks,
                               int chunk_rows, float* partial, float* out, void* stream) {
  if (r > SKI_MAX_R || k > SKI_MAX_R || chunks < 1) return (int)cudaErrorInvalidValue;
  if (r == 0 || k == 0) return (int)cudaGetLastError();
  ski_kr_gram_kernel<<<dim3((r + SKI_GRAM_A - 1) / SKI_GRAM_A, chunks), 256, 0, (cudaStream_t)stream>>>(
      Q, R, F, n, r, k, chunk_rows, partial);
  if (chunks > 1) {
    const long long size = (long long)k * r * r;
    ski_gram_reduce_kernel<<<sgp_blocks(size), SGP_THREADS, 0, (cudaStream_t)stream>>>(partial, size, chunks, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int sgp_ski_kr_adjoint(const float* R, const float* F, const float* W, const float* G, int n, int r,
                                  int k, float* dR, float* dF, void* stream) {
  if (r > SKI_MAX_R || k > SKI_MAX_R) return (int)cudaErrorInvalidValue;
  if (n > 0)
    ski_kr_adjoint_kernel<<<ski_row_blocks(n), 256, 0, (cudaStream_t)stream>>>(R, F, W, G, n, r, k, dR, dF);
  return (int)cudaGetLastError();
}
