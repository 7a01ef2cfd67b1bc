// Batched Thomas solve on materialized rows (a, b, c) and k right-hand
// sides d, for sm_90a.
//
// Replaces: cmcfs_tpu/ops/pallas_tridiag.py::tridiag_pallas (_fwd_kernel,
//   _bwd_kernel), backend "pallas" of ops/tridiag.tridiag_solve, and serves
//   backend "scan" on the card too (the reference's Thomas order,
//   ops/tridiag._solve_leading_axis_scan).  The TPU kernel runs two
//   pallas_calls, forward elimination then backward substitution, each
//   carrying its recurrence across row chunks in VMEM scratch because a TPU
//   grid runs its steps in order.  Here one thread owns one line and carries
//   its own recurrence, so one launch does both passes (walk.cuh).  Order of
//   operations as pallas_tridiag.py: c[n-1] = 0; row 0's a is ignored;
//   denom = b - a*c'; ``exact`` divides twice, else one IEEE reciprocal and
//   two multiplies (row 0 too when ``recip_row0``, the "pallas" form;
//   "scan" divides row 0 in both modes); x = d' - c'*x_next.  Products are
//   rounded before the subtraction, as the plain PyTorch version
//   (ops/tridiag_rows.tridiag_rows_ref) rounds them.  Lines run their true
//   length: no padding to the TPU's (8, 128) tiles.
//
// What bounds it on this card: memory traffic.  k systems that share their
//   rows read a, b and c once and d and x once each: 12 + 8k bytes a cell.
//   The scratch holds c' (one chain) and the k d' (written forward, read
//   backward, [plane][row][column]): 8 + 8k bytes more, so a launch moves 20
//   + 16k bytes a cell, 36 at k = 1 and 68 at k = 3 (the 3D row path's
//   velocity launch, against 108 for three launches of one system).  A few
//   operations a byte and a serial dependence along each line.
//
// What the design does about it (walk.cuh):
// * k right-hand sides on one set of rows: c' is computed once and the k d'
//   chains advance beside it.  The 3D row path solves u, v and w (k = 3)
//   and T (k = 1) in two launches a direction; the wrapper
//   (ops/tridiag_rows.py) runs other k as launches of 3 and 1.
// * Rows fetched ahead: chunk buffers of L lines x R rows x S stages, filled
//   by cp.async while the block walks the previous chunk; the backward walk
//   fetches its scratch rows the same way.
// * Lines addressed by stride inside a contiguous (pre, n, post) array, so
//   no transpose is made.  post > 1: neighbouring threads take neighbouring
//   lines of the contiguous batch axis, every row one coalesced run.  post
//   == 1 (every 3D Z sweep, the 2D Y sweep): the transposing tile, a chunk
//   copied as L runs of R contiguous floats into a padded [row][line] tile,
//   x stored back through it as the same runs.
// * Tiles (L x R x S): post > 1 32 x 2 x 2 (a 256^3 sweep's 65,536 lines
//   resident at once, and 99 blocks for the 2D box's 3,123 lines); post ==
//   1 32 x 16 x 3 (64-byte runs a line and chunk, 26 KB a block at k = 1,
//   39 KB at k = 3; 98 blocks on the 2D box).
#include <cstdint>

#include <cuda_runtime.h>

#include "walk.cuh"

namespace {

// Tiles: L lines a block, R rows a chunk, S chunk buffers
constexpr int kXyL = 32, kXyR = 2, kXyS = 2;    // post > 1
constexpr int kZL = 32, kZR = 16, kZS = 3;      // post == 1

// The rows of the row solve: staged a, b, c and the K right-hand sides,
// one c' chain for all.
template <int K>
struct Materialized {
  static constexpr int kNF = 3 + K, kNC = 1, kND = K;
  static constexpr bool kMask = false, kStaged = false;
  const float *a, *b, *c, *d;
  long long fs;
  __device__ static constexpr int chain(int) { return 0; }
  template <class Ln>
  __device__ void fetch(const Ln& lane, int i, unsigned sa, long long o,
                        bool full, int rows_v, int lines_v) const {
    const float* f = i == 0 ? a : i == 1 ? b : i == 2 ? c : d + (i - 3) * fs;
    lane.copy(sa, f + o, full, rows_v, lines_v, NoShift());
  }
  __device__ const int8_t* mask() const { return nullptr; }
  __device__ void rows(const float (&f)[kNF], int, float (&aa)[1],
                       float (&bb)[1], float (&cc)[1], float (&dd)[K]) const {
    aa[0] = f[0];
    bb[0] = f[1];
    cc[0] = f[2];
#pragma unroll
    for (int v = 0; v < K; ++v) dd[v] = f[3 + v];
  }
};

template <int K, bool kZ, bool kExact, int L, int R, int S>
__global__ void __launch_bounds__(L)
tridiag_rows_kernel(Materialized<K> pol, Lines g, int recip_row0,
                    float* __restrict__ x, float* __restrict__ scratch) {
  walk<Materialized<K>, kZ, kExact, L, R, S>(pol, g, recip_row0, x,
                                              scratch);
}

template <int K, bool kZ, int L, int R, int S>
int launch_tile(const Materialized<K>& pol, const Lines& g, int exact,
                int recip_row0, float* x, float* scratch, cudaStream_t st) {
  return exact ? launch_walk<Materialized<K>, kZ, L, R, S>(
                     tridiag_rows_kernel<K, kZ, true, L, R, S>, pol, g,
                     recip_row0, x, scratch, st)
               : launch_walk<Materialized<K>, kZ, L, R, S>(
                     tridiag_rows_kernel<K, kZ, false, L, R, S>, pol, g,
                     recip_row0, x, scratch, st);
}

// rows_fast: lines along the contiguous axis, the transposing tile
template <int K>
int launch_k(const Materialized<K>& pol, const Lines& g, bool rows_fast,
             int exact, int recip_row0, float* x, float* scratch,
             cudaStream_t st) {
  return rows_fast ? launch_tile<K, true, kZL, kZR, kZS>(
                         pol, g, exact, recip_row0, x, scratch, st)
                   : launch_tile<K, false, kXyL, kXyR, kXyS>(
                         pol, g, exact, recip_row0, x, scratch, st);
}

}  // namespace

// Launch one batched solve on ``stream``.  a, b, c: contiguous float32
// arrays of shape (pre, n, post); d and x: contiguous (k, pre, n, post),
// k = 1 or 3: the systems run along the middle axis, k of them per (pre,
// post) pair, all with the same rows.  scratch holds (1 + k) * n *
// scratch_lines floats (walk.cuh; lines (pre, post), or (1, pre) when post
// == 1).  Returns cudaGetLastError().
extern "C" int cmcfs_tridiag_rows(const void* a, const void* b,
                                  const void* c, const void* d, void* x,
                                  void* scratch, long long pre, int n,
                                  long long post, int k, int exact,
                                  int recip_row0, void* stream) {
  if (pre < 1 || post < 1 || pre > 0x7fffffffLL || post > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Lines g;
  g.n = n;
  g.fs = pre * n * post;
  const bool rows_fast = post == 1;     // lines along the contiguous axis
  if (rows_fast) {
    g.sp = 1; g.n1 = 1; g.s1 = 0; g.n2 = (int)pre; g.s2 = n;
  } else {                              // along the contiguous batch axis
    g.sp = post; g.n1 = (int)pre; g.s1 = n * post; g.n2 = (int)post;
    g.s2 = 1;
  }
  if (!lines_ok(g)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float *fa = (const float*)a, *fb = (const float*)b,
              *fc = (const float*)c, *fd = (const float*)d;
  if (k == 1)
    return launch_k<1>({fa, fb, fc, fd, g.fs}, g, rows_fast, exact,
                       recip_row0, (float*)x, (float*)scratch, st);
  if (k == 3)
    return launch_k<3>({fa, fb, fc, fd, g.fs}, g, rows_fast, exact,
                       recip_row0, (float*)x, (float*)scratch, st);
  return (int)cudaErrorInvalidValue;
}
