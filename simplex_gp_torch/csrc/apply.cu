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
//   rows (once per plan, join_rows.cu): each contribution's point and
//          weight in row order, each row's run end cnt, and the splat's
//          lists of mid rows and long-row pieces, as for the sort chain's
//          plan;
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
// :499-521): each of P ranks holds n_loc points of a global plan (K11a) whose
// rows are numbered by first contributing vertex, so its live rows are
// [0, n_lattice) on every rank.  The column block b of c_pad = P cb columns
// (c rounded up to a multiple of P; the padding columns are zero) is rank
// b's to blur.  Every buffer covers the n_lattice live rows only, not the
// plan's M = n_loc (d+1) P: the dead rows hold nothing and JAX's
// psum_scatter only carries them along.
//   rows (once per plan, ops/lattice.py::build_plan_sharded_join): this
//     rank's contributions in row order over the n_lattice rows, K9's
//     JoinRows built from its seg ids;
//   splat_blocks: K3'b's row-order splat (rows.cuh) of each column block
//     into its (n_lattice, cb) block of the (P, n_lattice, cb) buffer: no
//     atomics, no memset, every live row written (zero where this rank
//     contributes nothing); the reduce-scatter over the blocks (the
//     wrapper, torch.distributed) leaves rank b the sum of every rank's
//     block b;
//   blur: the d+1 axes of the rank's (n_lattice, cb) block in one launch
//     of resident blocks with a grid barrier between axes (rows.cuh,
//     sgp_blur_axes; reversed for the transpose); the plan's neighbour ids
//     index the live rows, M meaning missing;
//   slice_blocks: after the all-gather of the blurred blocks, one thread
//     per (point, column) reads block col / cb at column col % cb and
//     writes out (n_loc, c) in place, skipping the padding.
// Per apply each rank sends P-1 blocks of n_lattice cb floats in the
// reduce-scatter and receives P-1 in the all-gather (elevators at P = 2:
// 100,178 rows, not 201,818).  No step adds in an order that varies, so two
// applies give the same bits; the collectives reduce each element once.
// The last block is narrower than cb when P does not divide c, so the
// block kernels take cb as the stride and cover every block.
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

// K11b.  The first 16 arguments are this rank's row lists over nl rows
// (sgp_runs, rows.cuh); v is (n, c); blocks is (P, nl, cb), part np_max *
// cb floats; neither need be zeroed.
extern "C" int sgp_lattice_splat_blocks(const int* sp, const float* sw, const int* cnt, const int* long_rows,
                                        const int* long_first, const int* n_long, const int* piece_row,
                                        const int* piece_start, const int* n_pieces, const int* mid_rows,
                                        const int* n_mid, int nl_max, int nm_max, int np_max, int N,
                                        const int* n_lattice, const float* v, int c, int cb, int P, int nl,
                                        float* blocks, float* part, void* stream) {
  const SgpRuns r = sgp_runs(sp, sw, cnt, long_rows, long_first, n_long, piece_row, piece_start, n_pieces,
                             mid_rows, n_mid, nl_max, nm_max, np_max, N, n_lattice);
  return (int)sgp_splat_blocks(r, v, c, cb, P, nl, blocks, part, (cudaStream_t)stream);
}

// K11b's blur: the dp1 axes of ta (nl, c), its rows the plan's nl live
// ones, in one launch (rows.cuh, sgp_blur_axes), ping-ponging with tb
// (axis j reads nb + j M 2r, the global plan's (dp1, M, 2r) neighbour ids,
// M missing; reversed with transpose); barrier is one uint of scratch.  The
// result is in ta when dp1 is even, else in tb.
extern "C" int sgp_lattice_blur_live(float* ta, float* tb, const int* nb, const float* taps_host, int M, int nl, int c,
                                     int order, int dp1, int transpose, unsigned int* barrier, void* stream) {
  if (2 * order + 1 > SGP_MAX_TAPS) return (int)cudaErrorInvalidValue;
  return (int)sgp_blur_axes(ta, tb, nb, sgp_taps(taps_host, order), M, nl, c, dp1, order, transpose, barrier,
                            (cudaStream_t)stream);
}

// K11b's slice: blocks is (P, nl, cb), the gathered blurred blocks of
// the nl live rows (M = nl here).
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

// K3's splat, on no model path since K11b and K4 splat in row order (it
// stays as the yardstick of lattice_apply).  count (nullable): the guard's
// live count, against capacity.
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
