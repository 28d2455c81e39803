// K9/K7 rows, join_rows: a join plan's row lists -- each row's contributions
// in contribution order, each row's run end, the splat's lists of mid rows
// and long-row pieces -- from one host call on one workspace; and the wide
// plan from one host call: K2 (dedup.cu) and then these rows.
//
// Replaces what the sort chain's plan holds and K9 (apply.cu), K7
// (deriv.cu), K11b and K12 (mixture.cu) stand for: _chain_core's
// contribution order and run ends cnt (simplex_gp_tpu/ops/lattice.py
// :752-756).  K4 (once.cu) builds its rows here too.
//
// Bound: the N seg ids and weights read and each contribution's point and
// weight and each row's run end written, 4(4N + M) bytes (0.094 ms at
// houseelectric's untrimmed N = M = 15.7M on an H100).  The sort moves more
// than that: a radix sort reads and writes its keys and values once a pass.
// Design, in order on the caller's stream:
//   1. the sort's values: each contribution's index (N < 2^31, the hash
//      table's limit, ops/lattice.py::_table_slots) in the low word of a
//      64-bit value and its weight's bits in the high word, so the sorted
//      values bring the weights in row order: gathering w[e] by the
//      permutation took 0.38 ms of a 0.73 ms build at houseelectric on an
//      H100 (each contribution of a row ~20,000 entries from the last, one
//      32-byte sector a read; kernel_times.py --join-build);
//   2. a stable cub::DeviceRadixSort::SortPairs of the seg ids with those
//      values, over bits [0, bit_length(J M - 1)) only: every seg id lies
//      below J M, so no higher bit can differ, and each pass of the sort
//      takes 8 bits (2 passes at a trimmed plan's M = 32,768, 3 at an
//      untrimmed houseelectric plan's 15.7M, against 4 for 32 bits);
//      PyTorch's torch.sort sorted all 32 bits with int64 indices;
//   3. join_runs_kernel and join_rows_kernel: each contribution's point
//      and weight in row order, each row's run end and its class (short,
//      mid, long and its pieces);
//   4. three cub::DeviceScan::InclusiveSum over the classes, then chain.cu's
//      sgp_run_lists places the long rows, their pieces and the mid rows,
//      as for the sort chain's plan.
// No host read: the sizes follow from N and J M, the live counts are read
// on the device.  cub's temporary storage comes from the same workspace,
// so the call allocates nothing.  A stable sort keeps each row's
// contributions in contribution order, so the lists equal the plain
// version's (kernels/lattice.py::join_rows_plain) bit for bit, whatever
// numbering the dedup gave the rows.
//
// Past a bounded plan's capacity every seg id is 0: the sort sees N equal
// keys, row 0's run holds every contribution (in pieces of CHAIN_PIECE),
// the other rows are empty, and the applies' guard writes NaN.
#include <cub/cub.cuh>

#include "rows.cuh"

// Contribution e's sort value: e in the low word, the bits of w[e] above.
__global__ void rows_pack_kernel(const float* __restrict__ w, int N, unsigned long long* __restrict__ packed) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < N) packed[e] = (unsigned long long)__float_as_uint(w[e]) << 32 | (unsigned int)e;
}

// After the stable sort of the N seg ids (sorted, with the packed values
// in their order): the contribution at sorted position q, its point
// (reduced mod n_pts: a mixture's stacked contribution of component j
// belongs to point p of j n_pts + p) and weight; where the row changes,
// the row's run end.  Every contribution of a plan lies in a live row, or,
// past the capacity, in row 0.
__global__ void join_runs_kernel(const int* __restrict__ sorted, const unsigned long long* __restrict__ packed,
                                 int N, int dp1, int n_pts, int* __restrict__ sp, float* __restrict__ sw,
                                 int* __restrict__ cnt) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= N) return;
  const unsigned long long v = packed[q];
  const int pt = (int)(unsigned int)v / dp1;
  sp[q] = pt < n_pts ? pt : pt % n_pts;
  sw[q] = __uint_as_float((unsigned int)(v >> 32));
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
// row 0's run is all N contributions and the others are empty; with
// `sparse`, also a live row that no contribution reaches, as in a sharded
// plan's rank, whose every row's end is found by a binary search), and the
// long / mid class of each live row (rows.cuh).  An unset row of the last
// component ends at N; of another, where the sorted ids pass it.  A row's
// start is the previous row's end, computed where this launch writes it,
// so no thread reads another's write.
__global__ void join_rows_kernel(const int* __restrict__ sorted, const int* __restrict__ live, int J, int N, int M,
                                 int sparse, int* __restrict__ cnt, int* __restrict__ long_info) {
  const int Mt = J * M;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= Mt) return;
  const int j = J == 1 ? 0 : g / M, l = g - j * M;
  const int nl = live[j];
  const bool over = nl > M;
  const bool unset = over || l >= nl;
  const int end = !unset ? (sparse ? sgp_upper_bound(sorted, N, g) : cnt[g])
                         : (over || j == J - 1 ? N : sgp_upper_bound(sorted, N, g));
  if (unset || sparse) cnt[g] = end;
  if (l >= (over ? M : nl)) {
    long_info[g] = long_info[Mt + g] = long_info[2 * Mt + g] = 0;
    return;
  }
  const int start =
      g == 0 ? 0 : (over ? N : (l == 0 || sparse ? sgp_upper_bound(sorted, N, g - 1) : cnt[g - 1]));
  sgp_run_class(long_info, Mt, g, end - start);
}

// The bits the sort looks at: bit_length(Mt - 1), at least 1
// (kernels/lattice.py::rows_key_bits).
static inline int rows_key_bits(int Mt) {
  int b = 1;
  while (b < 31 && (1LL << b) < (long long)Mt) ++b;
  return b;
}

// The row build's scratch, carved from one workspace (base null: only the
// size), each part 256-byte aligned: the sorted seg ids, the packed values
// before and after the sort, the rows' classes and their scans, cub's
// temporary storage for the sort and the scans.
struct RowsWork {
  unsigned int* keys;
  unsigned long long *packed, *sorted_packed;
  int *info, *scan;
  void* temp;
  size_t temp_bytes;
};

static size_t rows_carve(char* base, int N, int Mt, RowsWork& b) {
  size_t off = 0;
  auto take = [&](size_t bytes) -> char* {
    off = (off + 255) & ~(size_t)255;
    char* at = base == nullptr ? nullptr : base + off;
    off += bytes;
    return at;
  };
  b.keys = (unsigned int*)take(sizeof(int) * (size_t)N);
  b.packed = (unsigned long long*)take(sizeof(unsigned long long) * (size_t)N);
  b.sorted_packed = (unsigned long long*)take(sizeof(unsigned long long) * (size_t)N);
  b.info = (int*)take(sizeof(int) * 3 * (size_t)Mt);
  b.scan = (int*)take(sizeof(int) * 3 * (size_t)Mt);
  size_t sort_bytes = 0, scan_bytes = 0;
  cub::DeviceRadixSort::SortPairs(nullptr, sort_bytes, (const unsigned int*)nullptr, (unsigned int*)nullptr,
                                  (const unsigned long long*)nullptr, (unsigned long long*)nullptr, N, 0,
                                  rows_key_bits(Mt));
  cub::DeviceScan::InclusiveSum(nullptr, scan_bytes, (const int*)nullptr, (int*)nullptr, Mt);
  b.temp_bytes = sort_bytes > scan_bytes ? sort_bytes : scan_bytes;
  b.temp = take(b.temp_bytes);
  return off;
}

// chain.cu: the splat's lists from the rows' classes and their scans.
extern "C" int sgp_run_lists(const int* long_info, const int* scan, const int* cnt, int Mc, int* long_rows,
                             int* long_first, int* piece_row, int* piece_start, int* n_long, int* n_pieces,
                             int* mid_rows, int* n_mid, void* stream);

// The ints of the lists buffer and the workspace bytes of sgp_rows_build
// for N contributions over Mt = J M rows.
extern "C" int sgp_rows_sizes(int N, int Mt, long long* lists_ints, long long* work_bytes) {
  RowsWork b;
  *lists_ints = (long long)rows_lists_ints(N, Mt);
  *work_bytes = (long long)rows_carve(nullptr, N, Mt, b);
  return (int)cudaSuccess;
}

// The row lists of N seg ids (.., d+1, point-major) over J components of M
// rows: live (J,) the components' live counts on the device, each
// contribution's point reduced mod n_pts, sparse: a live row may hold no
// contribution (a sharded plan's rank).  Writes sp, sw (N,), cnt (J M,)
// and the lists buffer (sgp_rows_sizes' ints, laid out as RowsLists); work
// holds work_bytes and need not be zeroed.
extern "C" int sgp_rows_build(const int* seg, const float* w, const int* live, int J, int N, int M, int dp1,
                              int n_pts, int sparse, int* sp, float* sw, int* cnt, int* lists, void* work,
                              long long work_bytes, void* stream) {
  if (J < 1 || n_pts < 1 || dp1 < 1 || (long long)J * M > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int Mt = J * M;
  RowsWork b;
  if ((long long)rows_carve(nullptr, N, Mt, b) > work_bytes) return (int)cudaErrorInvalidValue;
  rows_carve((char*)work, N, Mt, b);
  cudaError_t err;
  if (N > 0) {
    rows_pack_kernel<<<sgp_blocks(N), SGP_THREADS, 0, st>>>(w, N, b.packed);
    size_t temp_bytes = b.temp_bytes;
    if ((err = cub::DeviceRadixSort::SortPairs(b.temp, temp_bytes, (const unsigned int*)seg, b.keys, b.packed,
                                               b.sorted_packed, N, 0, rows_key_bits(Mt), st)) != cudaSuccess)
      return (int)err;
    join_runs_kernel<<<sgp_blocks(N), SGP_THREADS, 0, st>>>((const int*)b.keys, b.sorted_packed, N, dp1, n_pts, sp,
                                                            sw, cnt);
  }
  if (Mt <= 0) return (int)cudaGetLastError();
  join_rows_kernel<<<sgp_blocks(Mt), SGP_THREADS, 0, st>>>((const int*)b.keys, live, J, N, M, sparse, cnt, b.info);
  for (int i = 0; i < 3; ++i) {
    size_t temp_bytes = b.temp_bytes;
    if ((err = cub::DeviceScan::InclusiveSum(b.temp, temp_bytes, b.info + (size_t)i * Mt, b.scan + (size_t)i * Mt,
                                             Mt, st)) != cudaSuccess)
      return (int)err;
  }
  const RowsLists l = rows_lists(lists, N, Mt);
  if ((err = cudaMemsetAsync(lists, 0, sizeof(int) * rows_lists_ints(N, Mt), st)) != cudaSuccess) return (int)err;
  return sgp_run_lists(b.info, b.scan, cnt, Mt, l.long_rows, l.long_first, l.piece_row, l.piece_start, l.n_long,
                       l.n_pieces, l.mid_rows, l.n_mid, stream);
}

// dedup.cu: K2's workspace and K2 from one host call.
extern "C" int sgp_dedup_workspace(int N, int M, int slots, long long* bytes);
extern "C" int sgp_dedup(const int* h1, const int* h2, int N, const int* oh1, const int* oh2, int dp1, int r2,
                         int M, int mask, int* seg, int* neighbors, int* count, void* work, long long work_bytes,
                         void* stream);

// The workspace bytes of sgp_plan_rows: K2's, then the row build's.
extern "C" int sgp_plan_rows_workspace(int N, int M, int slots, long long* bytes) {
  long long dedup_bytes = 0, lists_ints = 0, rows_bytes = 0;
  sgp_dedup_workspace(N, M, slots, &dedup_bytes);
  sgp_rows_sizes(N, M, &lists_ints, &rows_bytes);
  *bytes = ((dedup_bytes + 255) & ~255LL) + rows_bytes;
  return (int)cudaSuccess;
}

// A wide plan from one host call: K2 over M rows (sgp_dedup: seg (N,),
// neighbors (dp1, M, r2), count) and then its row lists (sgp_rows_build
// with one component of the n = N / dp1 points: sp, sw, cnt, lists), on one
// workspace of sgp_plan_rows_workspace bytes.  w: the (n, dp1) weights.
extern "C" int sgp_plan_rows(const int* h1, const int* h2, const float* w, int N, const int* oh1, const int* oh2,
                             int dp1, int r2, int M, int mask, int* seg, int* neighbors, int* count, int* sp,
                             float* sw, int* cnt, int* lists, void* work, long long work_bytes, void* stream) {
  long long dedup_bytes = 0, lists_ints = 0, rows_bytes = 0;
  sgp_dedup_workspace(N, M, mask + 1, &dedup_bytes);
  sgp_rows_sizes(N, M, &lists_ints, &rows_bytes);
  dedup_bytes = (dedup_bytes + 255) & ~255LL;
  if (dedup_bytes + rows_bytes > work_bytes || dp1 < 1) return (int)cudaErrorInvalidValue;
  const int err =
      sgp_dedup(h1, h2, N, oh1, oh2, dp1, r2, M, mask, seg, neighbors, count, work, dedup_bytes, stream);
  if (err != (int)cudaSuccess) return err;
  return sgp_rows_build(seg, w, count, 1, N, M, dp1, N / dp1 > 0 ? N / dp1 : 1, 0, sp, sw, cnt, lists,
                        (char*)work + dedup_bytes, rows_bytes, stream);
}
