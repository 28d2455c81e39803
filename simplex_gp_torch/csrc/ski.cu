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
//        sgp_ski_interp_scatter  its backward: dU[idx[i, t], :] += w[i, t] dF[i, :],
//                                into a (g, r) table in each block's shared
//                                memory (shared atomics), then added to dU
//                                with global atomics (the order of the adds
//                                varies from run to run).
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
#define SKI_SCATTER_BLOCKS 264  // two blocks per SM for K13a's backward

__device__ __forceinline__ float ski_cubic(float s) {
  s = fabsf(s);
  const float w1 = (1.5f * s - 2.5f) * s * s + 1.0f;
  const float w2 = ((-0.5f * s + 2.5f) * s - 4.0f) * s + 2.0f;
  return s <= 1.0f ? w1 : (s <= 2.0f ? w2 : 0.0f);
}

// The four clipped grid indices and normalised Keys weights of x (_interp_1d).
__device__ __forceinline__ void ski_taps(float x, float gmin, float step, int g, int* idx, float* w) {
  const float pos = (x - gmin) / step;
  const int base = (int)floorf(pos);
  float sum = 0.0f;
  for (int t = 0; t < 4; ++t) {
    const int i = base + t - 1;
    w[t] = ski_cubic(pos - (float)i);
    idx[t] = min(max(i, 0), g - 1);
    sum += w[t];
  }
  sum = fmaxf(sum, 1e-12f);
  for (int t = 0; t < 4; ++t) w[t] = w[t] / sum;
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

__global__ void ski_interp_scatter_kernel(const float* __restrict__ x, const float* __restrict__ gmin,
                                          const float* __restrict__ step, const float* __restrict__ dF, int n,
                                          int g, int r, float* __restrict__ dU) {
  extern __shared__ float table[];  // (g, r)
  for (int e = threadIdx.x; e < g * r; e += blockDim.x) table[e] = 0.0f;
  __syncthreads();
  const float gm = *gmin, st = *step;
  const long long total = (long long)n * r;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long i = e / r;
    const int col = (int)(e % r);
    int idx[4];
    float w[4];
    ski_taps(x[i], gm, st, g, idx, w);
    const float v = dF[e];
    for (int t = 0; t < 4; ++t) atomicAdd(&table[idx[t] * r + col], w[t] * v);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < g * r; e += blockDim.x)
    if (table[e] != 0.0f) atomicAdd(&dU[e], table[e]);
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

// dU (g, r) must be zeroed; g r floats must fit in 48 KB of shared memory.
extern "C" int sgp_ski_interp_scatter(const float* x, const float* gmin, const float* step, const float* dF, int n,
                                      int g, int r, float* dU, void* stream) {
  const size_t smem = (size_t)g * r * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const long long work = (long long)n * r;
  if (work > 0) {
    const unsigned int blocks = sgp_blocks(work) < SKI_SCATTER_BLOCKS ? sgp_blocks(work) : SKI_SCATTER_BLOCKS;
    ski_interp_scatter_kernel<<<blocks, SGP_THREADS, smem, (cudaStream_t)stream>>>(x, gmin, step, dF, n, g, r, dU);
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
