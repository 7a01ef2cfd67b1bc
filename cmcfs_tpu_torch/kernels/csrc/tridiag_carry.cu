// The carry Thomas solve of the Z-blocked wavefront X sweep, for sm_90a:
// forward elimination and back substitution of the lines of one Z block of
// one X slab, each started from the carry plane its upstream shard handed
// over.
//
// Replaces: cmcfs_tpu/parallel/pipeline.py::_local_fwd and _local_bwd
//   (:26, :45), the per-shard recurrences of pipelined_tridiag_x_blocked
//   and pipelined_tridiag_x.  Those are lax.scan, not pallas_call: XLA runs
//   the row loop on the TPU.  Eager PyTorch would launch some 8 elementwise
//   kernels a row, which a 256^3 step multiplies into about 1e5 launches,
//   so the port runs each recurrence as one kernel here.
//
// Lines: the rows are the slab's owned X planes (n of them, sp floats
//   apart); a line is (i1, i2), i1 over the n1 leading cross positions
//   (Y, s1 apart) and i2 over the block's n2 columns of the contiguous axis
//   (Z, unit stride), starting ``off`` floats into the planes.  No copy of
//   the block is made.  The carry planes (cin_*, out_*) are contiguous
//   (n1, n2) planes, one a system.
//
// Forward (k systems on one set of rows, k = 3 for u, v, w and 1 for T,
//   as the 3D row path solves them): from c'_in, d'_in at row 0, every row
//   denom = b - a c'_prev, c' = c / denom and d' = (d - d'_prev a) / denom
//   (``exact``), or both times one reciprocal 1 / denom on every row, row 0
//   included (cmcfs_tpu's _local_fwd; the port's tridiag_rows calls it
//   recip_row0).  Row 0's a is not zeroed: the carry takes its place (the
//   global first row has a = 0 by the row build).  ``last``: the slab ends
//   the line, and its last row takes c = 0.  c' and d' of every row are
//   stored for the backward pass; the last row's go out as the carry.
// Backward: from x_in, x = d' - c' x_next on every row, the last included
//   (x_in = 0 on the last shard, whose last c' is 0); x of row 0 goes out.
// Products are rounded before the subtraction (__fmul_rn / __fsub_rn), the
//   quotients are IEEE divisions, as in walk.cuh and the plain version
//   (ops/tridiag_carry.py), so the kernel equals it bit for bit.
//
// What bounds it on this card: latency.  A launch holds 1/(shards x blocks)
//   of the lines (a 256^3 X solve over 2 shards at 8 blocks: 8,192 lines,
//   one thread each), and each thread's row loop is a serial chain, so
//   few warps are in flight.  The bytes a cell: forward 12 + 8k read and
//   4 + 4k written (a, b, c, d in; c', d' out), backward 4 + 4k read and
//   4k written.
//
// What the design does about it: nothing yet beyond the simplest correct
//   form.  One thread a line, neighbouring threads on neighbouring Z
//   columns, so every row's loads and stores are coalesced runs of the
//   block's width; the next rows' loads are independent of the chain and
//   unrolled ahead of it.  Splitting a line's systems over threads, or
//   staging rows with cp.async as walk.cuh does, is later work.
#include <cstdint>

#include <cuda_runtime.h>

#include "walk.cuh"

namespace {

constexpr int kThreads = 128;

// Line t of the launch: (its first cell's offset in the planes, its
// offset in the carry planes)
__device__ __forceinline__ bool line_of(const Lines& g, long long off,
                                        long long& o, long long& oc) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)g.n1 * g.n2) return false;
  const long long i1 = t / g.n2, i2 = t - i1 * g.n2;
  o = off + i1 * g.s1 + i2 * g.s2;
  oc = t;
  return true;
}

template <int K, bool kExact>
__global__ void __launch_bounds__(kThreads)
carry_fwd_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 const float* __restrict__ c, const float* __restrict__ d,
                 const float* __restrict__ cin_c,
                 const float* __restrict__ cin_d, float* __restrict__ cp,
                 float* __restrict__ dp, float* __restrict__ out_c,
                 float* __restrict__ out_d, Lines g, long long off,
                 long long fsd, long long fsp, int last) {
  long long o, oc;
  if (!line_of(g, off, o, oc)) return;
  const long long cs = (long long)g.n1 * g.n2;    // carry planes apart
  float cq = cin_c[oc];
  float dq[K];
#pragma unroll
  for (int v = 0; v < K; ++v) dq[v] = cin_d[oc + v * cs];
  const int n = g.n;
#pragma unroll 4
  for (int p = 0; p < n; ++p) {
    const long long q = o + (long long)p * g.sp;
    const float ai = a[q], bi = b[q];
    const float ci = last && p == n - 1 ? 0.f : c[q];
    const float den = __fsub_rn(bi, __fmul_rn(ai, cq));
    float r = 0.f;
    if (kExact) {
      cq = ci / den;
    } else {
      r = 1.0f / den;
      cq = __fmul_rn(ci, r);
    }
    cp[q] = cq;
#pragma unroll
    for (int v = 0; v < K; ++v) {
      const float num = __fsub_rn(d[q + v * fsd], __fmul_rn(dq[v], ai));
      dq[v] = kExact ? num / den : __fmul_rn(num, r);
      dp[q + v * fsp] = dq[v];
    }
  }
  out_c[oc] = cq;
#pragma unroll
  for (int v = 0; v < K; ++v) out_d[oc + v * cs] = dq[v];
}

template <int K>
__global__ void __launch_bounds__(kThreads)
carry_bwd_kernel(const float* __restrict__ cp, const float* __restrict__ dp,
                 const float* __restrict__ xin, float* __restrict__ x,
                 float* __restrict__ out_x, Lines g, long long off,
                 long long fsp) {
  long long o, oc;
  if (!line_of(g, off, o, oc)) return;
  const long long cs = (long long)g.n1 * g.n2;
  float xq[K];
#pragma unroll
  for (int v = 0; v < K; ++v) xq[v] = xin[oc + v * cs];
#pragma unroll 4
  for (int p = g.n - 1; p >= 0; --p) {
    const long long q = o + (long long)p * g.sp;
    const float ci = cp[q];
#pragma unroll
    for (int v = 0; v < K; ++v) {
      xq[v] = __fsub_rn(dp[q + v * fsp], __fmul_rn(ci, xq[v]));
      x[q + v * fsp] = xq[v];
    }
  }
#pragma unroll
  for (int v = 0; v < K; ++v) out_x[oc + v * cs] = xq[v];
}

// The lines of a launch: n rows sp apart, n1 x n2 lines (s1, 1)
bool make_lines(int n, int n1, long long s1, int n2, long long sp,
                Lines& g) {
  g.n = n;
  g.n1 = n1;
  g.n2 = n2;
  g.sp = sp;
  g.s1 = s1;
  g.s2 = 1;
  g.fs = 0;
  return n >= 1 && n1 >= 1 && n2 >= 1 && s1 >= n2 && sp >= 1;
}

unsigned blocks_for(const Lines& g) {
  return (unsigned)(((long long)g.n1 * g.n2 + kThreads - 1) / kThreads);
}

}  // namespace

// Forward elimination on ``stream``.  a, b, c: float32 planes (n, ...) with
// the lines' cells at off + i1 s1 + i2 + p sp; d: k systems fsd floats
// apart, each laid out as a; cp, dp: outputs laid out as a and as k
// systems fsp apart; cin_c, out_c: (n1, n2) carry planes; cin_d, out_d: k
// of them, n1 n2 apart.  k = 1 or 3.  Returns cudaGetLastError().
extern "C" int cmcfs_tridiag_carry_fwd(
    const void* a, const void* b, const void* c, const void* d,
    const void* cin_c, const void* cin_d, void* cp, void* dp, void* out_c,
    void* out_d, int n, int n1, long long s1, int n2, long long sp,
    long long off, long long fsd, long long fsp, int k, int last, int exact,
    void* stream) {
  Lines g;
  if (!make_lines(n, n1, s1, n2, sp, g) || (k != 1 && k != 3))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float *fa = (const float*)a, *fb = (const float*)b,
              *fc = (const float*)c, *fd = (const float*)d,
              *ic = (const float*)cin_c, *id = (const float*)cin_d;
  float *fcp = (float*)cp, *fdp = (float*)dp, *oc = (float*)out_c,
        *od = (float*)out_d;
  const unsigned blocks = blocks_for(g);
#define CARRY_FWD(K, E)                                                     \
  carry_fwd_kernel<K, E><<<blocks, kThreads, 0, st>>>(                      \
      fa, fb, fc, fd, ic, id, fcp, fdp, oc, od, g, off, fsd, fsp, last)
  if (k == 3) {
    if (exact) CARRY_FWD(3, true); else CARRY_FWD(3, false);
  } else {
    if (exact) CARRY_FWD(1, true); else CARRY_FWD(1, false);
  }
#undef CARRY_FWD
  return (int)cudaGetLastError();
}

// Back substitution on ``stream``: cp, dp as the forward pass wrote them;
// x laid out as dp; xin, out_x: k (n1, n2) carry planes.  Returns
// cudaGetLastError().
extern "C" int cmcfs_tridiag_carry_bwd(
    const void* cp, const void* dp, const void* xin, void* x, void* out_x,
    int n, int n1, long long s1, int n2, long long sp, long long off,
    long long fsp, int k, void* stream) {
  Lines g;
  if (!make_lines(n, n1, s1, n2, sp, g) || (k != 1 && k != 3))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float *fcp = (const float*)cp, *fdp = (const float*)dp,
              *xi = (const float*)xin;
  float *fx = (float*)x, *ox = (float*)out_x;
  const unsigned blocks = blocks_for(g);
  if (k == 3)
    carry_bwd_kernel<3><<<blocks, kThreads, 0, st>>>(fcp, fdp, xi, fx, ox, g,
                                                     off, fsp);
  else
    carry_bwd_kernel<1><<<blocks, kThreads, 0, st>>>(fcp, fdp, xi, fx, ox, g,
                                                     off, fsp);
  return (int)cudaGetLastError();
}
