// K6: the rank-k pivoted Cholesky of the exact kernel matrix
// s * k(||ref_i - ref_j||^2): each step writes column j of L and the updated
// residual diagonal, and picks the next pivot.
//
// Replaces simplex_gp_tpu/linalg/pivoted_cholesky.py::
// pivoted_cholesky_features (:106, the step at :126-163: argmax, column,
// update).
//
// Bound: per pivot j it reads ref (n x dim) and the first j columns of L,
// and reads and writes the diagonal: 4n(dim + j + 3) bytes.  The whole
// factor at houseelectric (n = 1,311,539, dim = 11, k = 100) moves 33.3 GB,
// 9.9 ms at 3.35 TB/s; at elevators (n = 10,623, dim = 18) 0.3 GB, 0.09 ms,
// so there the floor is k dependent steps, not bytes.
//
// Design.
//  * Layout.  ref and L are read through (row, column) strides.  The factor
//    holds L column-major, as L^T (k, n) contiguous, and ref likewise, so a
//    thread per row reads L[i, q] and ref[i, q] coalesced across a warp.
//    (A row-major L, the layout before, still works, strided.)  Each block
//    stages the pivot's rows of ref and L in shared memory.
//  * One step, per row i: the squared distance in the direct form
//    sum((ref_i - ref_p)^2), the kernel value, the subtraction of
//    sum_q L[i, q] L[p, q] in the order q = 0..j-1, the 1/sqrt(pivot)
//    scaling under the relative threshold alive = d[p] > 1e-6 max(diag), the
//    diagonal update max(d - ell^2, 0).  Every operation is an explicit
//    round-to-nearest intrinsic, so the layouts and both ways below give
//    the same bits.  The diagonal is double-buffered: every thread reads
//    the pivot's old value d_in[p] while the pivot's own thread zeroes
//    d_out[p].
//  * The argmax of the new diagonal, fused: each block reduces its rows'
//    (value, index) to the largest value with the lowest index (ties go to
//    the lowest index, as torch.argmax and jnp.argmax), writes it to
//    part[block], and the last block to arrive (a fence, then a ticket on a
//    device counter) reduces the blocks' entries and writes the next pivot
//    to a device scalar.  No step waits on the host.
//  * The whole factor from one host call (sgp_pivot_factor): k launches
//    of one step, with no host read and no allocation per pivot.  (One
//    persistent launch for all k steps, its blocks waiting on a step flag
//    between pivots, gave the same bits and was not faster: on an H100 at
//    700 W, 1.45-1.51 ms against the launches' 1.03-1.13 at elevators,
//    10,623 rows, and the same 15.8-16.3 ms at houseelectric.)
//
// K6', the sharded step (pivoted_cholesky.py:129-140, :152-162), is the
// one-step kernel on this rank's rows of ref, L and the diagonal; the pivot
// may live on another rank.  Each rank all-gathers one candidate (its local
// maximum of the diagonal, from the fused reduction of the step before,
// that row of ref and that row of L), and every rank picks the same winner.
// The caller passes the winner's x row, L row and pivot value as device
// vectors (null for K6, which reads row p), and the pivot's local index,
// or -1 on the ranks that lost: only the winner writes sqrt(pivot) into L
// and zeroes its diagonal entry.
#include "common.cuh"

#include <limits.h>
#include <math.h>

__device__ __forceinline__ float sgp_kernel_value(float d2, float nu) {
  // nu == 0: rbf exp(-d2); otherwise Matern-nu, nu in {0.5, 1.5, 2.5}.
  if (nu == 0.0f) return expf(-d2);
  const float d = sqrtf(fmaxf(d2, 1e-30f));
  const float e = expf(__fmul_rn(-sqrtf(2.0f * nu), d));
  if (nu == 0.5f) return e;
  if (nu == 1.5f) return __fmul_rn(__fadd_rn(1.0f, __fmul_rn(sqrtf(3.0f), d)), e);
  return __fmul_rn(
      __fadd_rn(__fadd_rn(1.0f, __fmul_rn(sqrtf(5.0f), d)), __fmul_rn((float)(5.0 / 3.0), d2)), e);
}

// (value, index) of the larger residual diagonal; ties to the lower index.
struct PivotBest {
  float v;
  int i;
};

__device__ __forceinline__ PivotBest pivot_better(PivotBest a, PivotBest b) {
  return (b.v > a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}

__device__ __forceinline__ PivotBest pivot_block_best(PivotBest x, PivotBest* scratch) {
  for (int off = 16; off > 0; off >>= 1) {
    PivotBest o{__shfl_xor_sync(0xffffffffu, x.v, off), __shfl_xor_sync(0xffffffffu, x.i, off)};
    x = pivot_better(x, o);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // scratch may still be read from the last call
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < (int)(blockDim.x >> 5) ? scratch[lane] : PivotBest{-INFINITY, INT_MAX};
    for (int off = 16; off > 0; off >>= 1) {
      PivotBest o{__shfl_xor_sync(0xffffffffu, x.v, off), __shfl_xor_sync(0xffffffffu, x.i, off)};
      x = pivot_better(x, o);
    }
  }
  return x;  // valid in thread 0
}

struct PivotArgs {
  const float* ref;  // (n, dim) at ref[i * ref_si + q * ref_sq]
  long long ref_si, ref_sq;
  float* L;  // (n, k) at L[i * l_si + q * l_sq]
  long long l_si, l_sq;
  const float* x_piv;  // K6': the pivot's rows (dim,), (k,), (1,); null for K6
  const float* l_piv;
  const float* pv;
  const float* s;
  const float* d0max;
  long long* pivots;  // pivots[j] = the pivot (K6': its local index, or -1)
  float2* part;       // one (value, index as float bits) per block
  unsigned int* ticket;
  int n, dim, k;
  float nu;
};

// One step j (K6 and K6'): column j of L and d_out from d_in with the
// pivot *piv_in; with piv_out, the argmax of d_out into *piv_out, written by
// the last block to arrive, which leaves the ticket at 0 again.  smem: the
// pivot's rows (dim + k floats), then a warp's scratch for the block
// reduction.
__global__ void __launch_bounds__(SGP_THREADS) pivot_column_kernel(PivotArgs a, const float* d_in, float* d_out,
                                                                   const long long* piv_in, long long* piv_out,
                                                                   int j) {
  extern __shared__ float smem[];
  const long long p = __ldcg(piv_in);  // -1 on a rank that does not hold the pivot
  float* sx = smem;
  float* sl = smem + a.dim;
  // The pivot's rows: given (K6'), or row p of ref and L (K6), staged for the block.
  for (int q = threadIdx.x; q < a.dim; q += blockDim.x)
    sx[q] = a.x_piv ? __ldcg(a.x_piv + q) : __ldcg(a.ref + p * a.ref_si + q * a.ref_sq);
  for (int q = threadIdx.x; q < j; q += blockDim.x)
    sl[q] = a.l_piv ? __ldcg(a.l_piv + q) : __ldcg(a.L + p * a.l_si + q * a.l_sq);
  const float pv_raw = a.pv ? __ldcg(a.pv) : __ldcg(d_in + p);
  __syncthreads();
  const bool alive = pv_raw > __fmul_rn(1e-6f, __ldg(a.d0max));
  const float root = sqrtf(fmaxf(pv_raw, 1e-12f));
  const float s = __ldg(a.s);

  PivotBest best{-INFINITY, INT_MAX};
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.n; i += stride) {
    const float* ri = a.ref + (long long)i * a.ref_si;
    float d2 = 0.0f;
    for (int q = 0; q < a.dim; ++q) {
      const float diff = __fsub_rn(__ldg(ri + q * a.ref_sq), sx[q]);
      d2 = __fadd_rn(d2, __fmul_rn(diff, diff));
    }
    float col = __fmul_rn(s, sgp_kernel_value(d2, a.nu));
    const float* Li = a.L + (long long)i * a.l_si;
    float dot = 0.0f;
#pragma unroll 16
    for (int q = 0; q < j; ++q) dot = __fadd_rn(dot, __fmul_rn(__ldcg(Li + q * a.l_sq), sl[q]));
    col = __fsub_rn(col, dot);

    float ell = alive ? __fdiv_rn(col, root) : 0.0f;
    if (i == p) ell = alive ? root : 0.0f;
    a.L[(long long)i * a.l_si + (long long)j * a.l_sq] = ell;
    const float dn = i == p ? 0.0f : fmaxf(__fsub_rn(__ldcg(d_in + i), __fmul_rn(ell, ell)), 0.0f);
    d_out[i] = dn;
    best = pivot_better(best, PivotBest{dn, i});
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) a.pivots[j] = p;
  if (piv_out == nullptr) return;

  // The fused argmax: this block's best, then the last block to arrive reduces them all.
  __shared__ unsigned int last;
  best = pivot_block_best(best, reinterpret_cast<PivotBest*>(smem + a.dim + a.k));
  if (threadIdx.x == 0) {
    a.part[blockIdx.x] = make_float2(best.v, __int_as_float(best.i));
    __threadfence();
    last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last) {
    __threadfence();
    PivotBest all{-INFINITY, INT_MAX};
#pragma unroll 4
    for (int b = threadIdx.x; b < (int)gridDim.x; b += blockDim.x) {
      const float2 e = __ldcg(a.part + b);
      all = pivot_better(all, PivotBest{e.x, __float_as_int(e.y)});
    }
    all = pivot_block_best(all, reinterpret_cast<PivotBest*>(smem + a.dim + a.k));
    if (threadIdx.x == 0) {
      *piv_out = all.i;
      *a.ticket = 0u;
    }
  }
}

static inline size_t pivot_smem(int dim, int k) {
  return sizeof(float) * (size_t)(dim + k) + sizeof(PivotBest) * (SGP_THREADS / 32);
}

static inline PivotArgs pivot_args(const float* ref, long long ref_si, long long ref_sq, float* L, long long l_si,
                                   long long l_sq, const float* x_piv, const float* l_piv, const float* pv,
                                   const float* s, const float* d0max, long long* pivots, float* part,
                                   unsigned int* ticket, int n, int dim, int k, float nu) {
  return PivotArgs{ref, ref_si, ref_sq, L, l_si, l_sq, x_piv, l_piv, pv, s, d0max, pivots,
                   reinterpret_cast<float2*>(part), ticket, n, dim, k, nu};
}

// One step.  part: 2 * sgp_blocks(n) floats; ticket: one uint, 0 (the
// step leaves it 0); piv_out: null for no argmax (part and ticket then
// unused).
extern "C" int sgp_pivot_column(const float* ref, long long ref_si, long long ref_sq, float* L, long long l_si,
                                long long l_sq, const float* d_in, float* d_out, const float* x_piv,
                                const float* l_piv, const float* pv, const long long* piv, const float* s,
                                const float* d0max, long long* pivots, long long* piv_out, float* part,
                                unsigned int* ticket, int n, int dim, int k, int j, float nu, void* stream) {
  const size_t smem = pivot_smem(dim, k);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (n > 0)
    pivot_column_kernel<<<sgp_blocks(n), SGP_THREADS, smem, (cudaStream_t)stream>>>(
        pivot_args(ref, ref_si, ref_sq, L, l_si, l_sq, x_piv, l_piv, pv, s, d0max, pivots, part, ticket, n, dim,
                   k, nu),
        d_in, d_out, piv, piv_out, j);
  return (int)cudaGetLastError();
}

// The whole factor from one host call: k launches of one step, a thread a
// row.  d0 holds the initial diagonal and d1 is scratch of n floats;
// piv[0] the first pivot (piv: 2 int64); ticket: one uint, 0; part:
// 2 * sgp_blocks(n) floats.
extern "C" int sgp_pivot_factor(const float* ref, long long ref_si, long long ref_sq, float* L, long long l_si,
                                long long l_sq, float* d0, float* d1, long long* piv, const float* s,
                                const float* d0max, long long* pivots, float* part, unsigned int* ticket, int n,
                                int dim, int k, float nu, void* stream) {
  const size_t smem = pivot_smem(dim, k);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (n <= 0 || k <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const int need = (int)sgp_blocks(n);
  const PivotArgs a = pivot_args(ref, ref_si, ref_sq, L, l_si, l_sq, nullptr, nullptr, nullptr, s, d0max, pivots,
                                 part, ticket, n, dim, k, nu);
  for (int j = 0; j < k; ++j) {
    pivot_column_kernel<<<need, SGP_THREADS, smem, st>>>(a, (j & 1) ? d1 : d0, (j & 1) ? d0 : d1, piv + (j & 1),
                                                         piv + ((j + 1) & 1), j);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
