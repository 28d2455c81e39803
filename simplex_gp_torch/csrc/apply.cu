// K3 lattice_apply: out = SLICE_NORM * S^T B_d ... B_0 S v for v (n, c);
// and K9 lattice_apply_cols: the same operator over a wide v, one column
// window at a time, on a join plan's row lists.
//
// K3 replaces simplex_gp_tpu/ops/lattice.py::apply_plan_join (:470), with
// the capacity guard of apply_plan_chain (:1093-1100); K9 replaces
// simplex_gp_tpu/ops/filter.py::lattice_filter_wide_chunked (:65) and
// make_wide_filter (:87), the chunked apply above 4M contribution rows.
//
// Bound: memory traffic.  Splat moves n(d+1)c weighted values into the
// (M, c) table, each of the d+1 blurs reads (2r+1) rows and writes one per
// live row, and the slice gathers d+1 rows per point: about
// (d+1)(2r+2) M c 4 bytes, ~0.8 GB at elevators' joint plan with c = 101.
// K3's design: three phases, one thread per (item, column), so a warp walks
// the contiguous columns of one row and its reads coalesce whenever c >= 32;
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
//
// Capacity guard.  A plan built with a capacity (K2 bounded, dedup.cu) has
// M = capacity rows, and its live count may pass M; every contribution then
// points at row 0.  Splat and blur read the count on the device and do
// nothing once it passes M, so no launch touches a row at or past M, and the
// slice writes NaN (JAX's guard).  The host never reads the count.  An
// untrimmed plan (M = n(d+1)) passes no count to splat and slice.
//
// K9.  At houseelectric's eval sizes (19.7M contribution rows, 101 columns,
// ~20k live rows) two (M, c) tables would take 16 GB.  lattice_apply_cols
// keeps one pair of (M, w) tables and runs splat, blurs and slice once per
// window [c0, c0 + w) of the columns (the last window narrower), reading
// each window of v in place (row stride c) and writing it in place into
// out.  Its cost follows the contributions and the live rows, not M:
//   rows (once per plan): from a stable sort of the seg ids (the
//          wrapper's torch.sort), sgp_join_rows gives each contribution's
//          point and weight in row order, each row's run end cnt and class,
//          and chain.cu's sgp_run_lists the splat's lists of mid rows and
//          long-row pieces, as for the sort chain's plan;
//   splat: K3'b's row-order splat (rows.cuh) of the window: no atomics, no
//          memset (every live row is written, no other row is read), the
//          same bits in every run;
//   blur:  sgp_live_blur (rows.cuh): a grid fixed by the card strides over
//          the live rows only;
//   slice: K3's, with its guard.
// Each window re-reads the row lists; that costs ceil(c / w) plan reads
// against one, for w / c of the tables.  The exact backward of the NLML and
// of the filter (ops/filter.py) runs K9 too, one window of all its columns
// (11 on the training path), forward and transposed (the blurs in reverse
// order), keeping the blurred table for K5: K3's operator without its
// atomics.
//
// K11b, the sharded apply (apply_plan_join's sharded branch, ops/lattice.py
// :499-521): each of P ranks holds n_loc points of a global plan of M rows.
// The column block b of c_pad = P cb columns (c rounded up to a multiple of
// P; the padding columns stay zero) is rank b's to blur.
//   splat_blocks: this rank's contributions into a zeroed (P, M, cb) block
//     buffer, column col to block col / cb, one thread per (contribution,
//     column) with atomics as K3's splat; reduce-scatter over the blocks
//     (the wrapper, torch.distributed) leaves rank b the sum of every rank's
//     block b;
//   blur: K3's blur on the rank's (M, cb) block, d+1 launches;
//   slice_blocks: after the all-gather of the blurred blocks, one thread per
//     (point, column) reads block col / cb at column col % cb and writes out
//     (n_loc, c) in place, skipping the padding.
// Per apply each rank sends P-1 blocks of M cb floats in the reduce-scatter
// and receives P-1 in the all-gather; the blur's traffic is K3's at cb =
// c_pad / P columns.  The last block is narrower than cb when P does not
// divide c, so the block kernels take cb as the stride and cover every
// block in one launch.
#include "rows.cuh"

__global__ void splat_kernel(const int* __restrict__ seg, const float* __restrict__ w,
                             const float* __restrict__ v, int n, int dp1, int c,
                             float* __restrict__ table, const int* __restrict__ count, int capacity) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n * dp1 * c) return;
  if (count != nullptr && *count > capacity) return;
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
  const int live = *count;
  if (live > M || row >= live) return;  // a tripped guard, or a row past the live ones
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
                             const float* __restrict__ w, int n, int dp1, int wd, float norm,
                             float* __restrict__ out, int ldo, int c0,
                             const int* __restrict__ count, int capacity) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n * wd) return;
  const int col = (int)(idx % wd);
  const long long p = idx / wd;
  float* dst = out + p * ldo + c0 + col;
  if (count != nullptr && *count > capacity) {
    *dst = __int_as_float(0x7fc00000);  // quiet NaN
    return;
  }
  float acc = 0.0f;
  for (int v = 0; v < dp1; ++v) {
    const long long e = p * dp1 + v;
    acc = __fadd_rn(acc, __fmul_rn(table[(long long)seg[e] * wd + col], w[e]));
  }
  *dst = __fmul_rn(acc, norm);
}

__global__ void splat_blocks_kernel(const int* __restrict__ seg, const float* __restrict__ w,
                                    const float* __restrict__ v, int n, int dp1, int c, int cb,
                                    int M, float* __restrict__ blocks) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n * dp1 * c) return;
  const int col = (int)(idx % c);
  const long long e = idx / c;  // contribution = point * dp1 + vertex
  const long long p = e / dp1;
  const int b = col / cb;
  atomicAdd(&blocks[((long long)b * M + seg[e]) * cb + (col - b * cb)], __fmul_rn(v[p * c + col], w[e]));
}

__global__ void slice_blocks_kernel(const float* __restrict__ blocks, const int* __restrict__ seg,
                                    const float* __restrict__ w, int n, int dp1, int c, int cb,
                                    int M, float norm, float* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n * c) return;
  const int col = (int)(idx % c);
  const long long p = idx / c;
  const int b = col / cb;
  const float* table = blocks + (long long)b * M * cb + (col - b * cb);
  float acc = 0.0f;
  for (int v = 0; v < dp1; ++v) {
    const long long e = p * dp1 + v;
    acc = __fadd_rn(acc, __fmul_rn(table[(long long)seg[e] * cb], w[e]));
  }
  out[idx] = __fmul_rn(acc, norm);
}

// K11b.  v and out are (n, c); blocks is (c_pad / cb, M, cb), zeroed.
extern "C" int sgp_lattice_splat_blocks(const int* seg, const float* w, const float* v, int n, int dp1,
                                        int c, int cb, int M, float* blocks, void* stream) {
  if (cb <= 0) return (int)cudaErrorInvalidValue;
  const long long work = (long long)n * dp1 * c;
  if (work > 0)
    splat_blocks_kernel<<<sgp_blocks(work), SGP_THREADS, 0, (cudaStream_t)stream>>>(seg, w, v, n, dp1, c,
                                                                                   cb, M, blocks);
  return (int)cudaGetLastError();
}

extern "C" int sgp_lattice_slice_blocks(const float* blocks, const int* seg, const float* w, int n,
                                        int dp1, int c, int cb, int M, float norm, float* out,
                                        void* stream) {
  if (cb <= 0) return (int)cudaErrorInvalidValue;
  const long long work = (long long)n * c;
  if (work > 0)
    slice_blocks_kernel<<<sgp_blocks(work), SGP_THREADS, 0, (cudaStream_t)stream>>>(blocks, seg, w, n, dp1,
                                                                                   c, cb, M, norm, out);
  return (int)cudaGetLastError();
}

// count (nullable): the guard's live count, against capacity.
extern "C" int sgp_lattice_splat(const int* seg, const float* w, const float* v, int n, int dp1,
                                 int c, float* table, const int* count, int capacity,
                                 void* stream) {
  const long long work = (long long)n * dp1 * c;
  if (work > 0)
    splat_kernel<<<sgp_blocks(work), SGP_THREADS, 0, (cudaStream_t)stream>>>(seg, w, v, n, dp1, c, table,
                                                                            count, capacity);
  return (int)cudaGetLastError();
}

// taps_host: 2*order+1 floats in host memory, copied into the launch.
extern "C" int sgp_lattice_blur(const float* in, float* out, const int* nb,
                                const float* taps_host, int M, int c, int order,
                                const int* count, void* stream) {
  if (2 * order + 1 > SGP_MAX_TAPS) return (int)cudaErrorInvalidValue;
  const long long work = (long long)M * c;
  if (work > 0)
    blur_kernel<<<sgp_blocks(work), SGP_THREADS, 0, (cudaStream_t)stream>>>(
        in, out, nb, sgp_taps(taps_host, order), M, c, order, count);
  return (int)cudaGetLastError();
}

extern "C" int sgp_lattice_slice(const float* table, const int* seg, const float* w, int n,
                                 int dp1, int c, float norm, float* out, const int* count,
                                 int capacity, void* stream) {
  const long long work = (long long)n * c;
  if (work > 0)
    slice_kernel<<<sgp_blocks(work), SGP_THREADS, 0, (cudaStream_t)stream>>>(
        table, seg, w, n, dp1, c, norm, out, c, 0, count, capacity);
  return (int)cudaGetLastError();
}

// K9's rows, after the wrapper's stable sort of the N seg ids (sorted, with
// its permutation perm).  Contribution at sorted position q: its point
// (reduced mod n_pts: a mixture's stacked contribution of component j
// belongs to point p of j n_pts + p) and weight; where the row changes,
// the row's run end.  Every contribution of a plan lies in a live row, or,
// past the capacity, in row 0.
__global__ void join_runs_kernel(const int* __restrict__ sorted, const long long* __restrict__ perm,
                                 const float* __restrict__ w, int N, int dp1, int n_pts, int* __restrict__ sp,
                                 float* __restrict__ sw, int* __restrict__ cnt) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= N) return;
  const int e = (int)perm[q];
  const int pt = e / dp1;
  sp[q] = pt < n_pts ? pt : pt % n_pts;
  sw[q] = w[e];
  const int g = sorted[q];
  if (q == N - 1 || sorted[q + 1] != g) cnt[g] = q + 1;
}

// The first sorted position whose row is past g: the run end of row g.
__device__ __forceinline__ int sgp_upper_bound(const int* __restrict__ sorted, int N, int g) {
  int lo = 0, hi = N;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sorted[mid] <= g) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Row g of J components of M rows each (rows.cuh, SgpLiveRows; J = 1: a
// join plan): the run end of every row that join_runs_kernel left unset
// (the rows past a component's live count; past the capacity, every row:
// row 0's run is all N contributions and the others are empty), and the
// long / mid class of each live row (rows.cuh).  An unset row of the last
// component ends at N; of another, where the sorted ids pass it.  A row's
// start is the previous row's end, computed where this launch writes it,
// so no thread reads another's write.
__global__ void join_rows_kernel(const int* __restrict__ sorted, const int* __restrict__ live, int J, int N, int M,
                                 int* __restrict__ cnt, int* __restrict__ long_info) {
  const int Mt = J * M;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= Mt) return;
  const int j = J == 1 ? 0 : g / M, l = g - j * M;
  const int nl = live[j];
  const bool over = nl > M;
  const bool unset = over || l >= nl;
  const int end = !unset ? cnt[g] : (over || j == J - 1 ? N : sgp_upper_bound(sorted, N, g));
  if (unset) cnt[g] = end;
  if (l >= (over ? M : nl)) {
    long_info[g] = long_info[Mt + g] = long_info[2 * Mt + g] = 0;
    return;
  }
  const int start = g == 0 ? 0 : (over ? N : (l == 0 ? sgp_upper_bound(sorted, N, g - 1) : cnt[g - 1]));
  sgp_run_class(long_info, Mt, g, end - start);
}

// live: J counts on the device (J = 1: the plan's n_lattice); M rows a
// component; n_pts the points a component's contributions belong to.
extern "C" int sgp_join_rows(const int* sorted, const long long* perm, const float* w, const int* live, int J, int N,
                             int M, int dp1, int n_pts, int* sp, float* sw, int* cnt, int* long_info, void* stream) {
  if (J < 1 || n_pts < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (N > 0) join_runs_kernel<<<sgp_blocks(N), SGP_THREADS, 0, st>>>(sorted, perm, w, N, dp1, n_pts, sp, sw, cnt);
  if (M > 0)
    join_rows_kernel<<<sgp_blocks((long long)J * M), SGP_THREADS, 0, st>>>(sorted, live, J, N, M, cnt, long_info);
  return (int)cudaGetLastError();
}

// K9.  The first 16 arguments are the plan's row lists (sgp_runs, rows.cuh);
// v and out are (n, c) row-major; nb is the plan's (dp1, M, 2r) neighbour
// array; n_lattice its live count; guard (nullable) as for K3's slice.  ta
// and tb hold M * chunk floats each, part np_max * chunk; none need be
// zeroed.  transpose: the axis blurs in reverse order (S^T B^T S, the exact
// backward's transposed apply).  After the last window its blurred table is
// in ta when dp1 is even, else in tb (the backward's one window of all c
// columns keeps it).
extern "C" int sgp_lattice_apply_cols(const int* sp, const float* sw, const int* cnt, const int* long_rows,
                                      const int* long_first, const int* n_long, const int* piece_row,
                                      const int* piece_start, const int* n_pieces, const int* mid_rows,
                                      const int* n_mid, int nl_max, int nm_max, int np_max, int N,
                                      const int* n_lattice, const int* seg, const float* w, const int* nb,
                                      const float* v, int n, int dp1, int c, int chunk, int M,
                                      const float* taps_host, int order, float norm, const int* guard, float* ta,
                                      float* tb, float* part, float* out, int transpose, void* stream) {
  if (2 * order + 1 > SGP_MAX_TAPS || chunk <= 0) return (int)cudaErrorInvalidValue;
  if (n <= 0 || c <= 0 || M <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const SgpRuns r = sgp_runs(sp, sw, cnt, long_rows, long_first, n_long, piece_row, piece_start, n_pieces,
                             mid_rows, n_mid, nl_max, nm_max, np_max, N, n_lattice);
  const SgpTaps taps = sgp_taps(taps_host, order);
  const long long nbs = (long long)M * 2 * order;  // one axis of nb
  cudaError_t err;
  for (int c0 = 0; c0 < c; c0 += chunk) {
    const int wd = c - c0 < chunk ? c - c0 : chunk;
    if ((err = sgp_splat_rows(r, SgpWindow{v, c, c0}, wd, M, ta, part, st)) != cudaSuccess) return (int)err;
    float *a = ta, *b = tb;
    for (int jj = 0; jj < dp1; ++jj) {
      const int j = transpose ? dp1 - 1 - jj : jj;
      if ((err = sgp_live_blur(a, b, nb + j * nbs, taps, M, wd, order, n_lattice, st)) != cudaSuccess)
        return (int)err;
      float* t = a;
      a = b;
      b = t;
    }
    slice_kernel<<<sgp_blocks((long long)n * wd), SGP_THREADS, 0, st>>>(a, seg, w, n, dp1, wd, norm, out, c, c0,
                                                                        guard, M);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
