// Batched Thomas solve on materialized rows (a, b, c, d), for sm_90a.
//
// Replaces: cmcfs_tpu/ops/pallas_tridiag.py::tridiag_pallas (_fwd_kernel,
//   _bwd_kernel), backend "pallas" of ops/tridiag.tridiag_solve, and serves
//   backend "scan" on the card too (the reference's Thomas order,
//   ops/tridiag._solve_leading_axis_scan).  The TPU kernel runs two
//   pallas_calls, forward elimination then backward substitution, each
//   carrying its recurrence across row chunks in VMEM scratch because a TPU
//   grid runs its steps in order.  Here one thread owns one line and carries
//   its own recurrence, so one launch does both passes and no chunk carry
//   exists.  Order of operations as pallas_tridiag.py: c[n-1] = 0; row 0's
//   a is ignored; denom = b - a*c'; ``exact`` divides twice, else one IEEE
//   reciprocal and two multiplies (row 0 too when ``recip_row0``, the
//   "pallas" form; "scan" divides row 0 in both modes); x = d' - c'*x_next.
//   Products are rounded before the subtraction (__fmul_rn / __fsub_rn), as
//   the plain PyTorch version rounds them.  Lines run their true length:
//   no padding to the TPU's (8, 128) tiles.
//
// What bounds it on this card: memory traffic and latency.  Compulsory
//   traffic is a, b, c, d read and x written, 20 bytes per cell; the c'
//   scratch and the d' staged in x add 16 bytes.  A few flops per cell, and
//   a serial dependence along each line, so the launch needs many lines in
//   flight to hide load latency: a 3D grid gives 65k-147k of them, a 2D
//   grid only a few thousand.
//
// What the design does about it: the rows of a line sit at a fixed stride
//   ``post`` inside a contiguous (pre, n, post) array, so neighbouring
//   threads take neighbouring lines of the contiguous batch axis and every
//   row's reads and writes coalesce; no transpose is made for a sweep along
//   a middle axis.  Lines along the contiguous axis itself (post == 1) read
//   strided and rely on L1 reuse across consecutive rows.  d' goes into x
//   and is overwritten in place by the backward pass, so the only scratch is
//   c'.  Not done yet: register or shared-memory tiles of (c', d') for
//   short lines, a coalesced post == 1 form.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
tridiag_rows_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ c, const float* __restrict__ d,
                    float* __restrict__ x, float* __restrict__ cp, int n,
                    long long post, long long lines, int exact,
                    int recip_row0) {
  const long long line = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (line >= lines) return;
  const long long i_pre = line / post;
  const long long base = i_pre * n * post + (line - i_pre * post);

  float c_prev = 0.f, d_prev = 0.f;
  for (int p = 0; p < n; ++p) {
    const long long o = base + p * post;
    const float bi = b[o];
    const float ci = p == n - 1 ? 0.f : c[o];
    float denom, num;
    if (p == 0) {
      denom = bi;
      num = d[o];
    } else {
      const float ai = a[o];
      denom = __fsub_rn(bi, __fmul_rn(ai, c_prev));
      num = __fsub_rn(d[o], __fmul_rn(d_prev, ai));
    }
    float cn, dn;
    if (exact || (p == 0 && !recip_row0)) {
      cn = ci / denom;
      dn = num / denom;
    } else {
      const float r = 1.0f / denom;
      cn = __fmul_rn(ci, r);
      dn = __fmul_rn(num, r);
    }
    cp[o] = cn;
    x[o] = dn;
    c_prev = cn;
    d_prev = dn;
  }

  float x_next = 0.f;
  for (int p = n - 1; p >= 0; --p) {
    const long long o = base + p * post;
    const float xv =
        p == n - 1 ? x[o] : __fsub_rn(x[o], __fmul_rn(cp[o], x_next));
    x[o] = xv;
    x_next = xv;
  }
}

}  // namespace

// Launch one batched solve on ``stream``.  a, b, c, d, x and cp are
// contiguous float32 arrays of shape (pre, n, post): the systems run along
// the middle axis, one per (pre, post) pair.  Returns cudaGetLastError().
extern "C" int cmcfs_tridiag_rows(const void* a, const void* b,
                                  const void* c, const void* d, void* x,
                                  void* cp, long long pre, int n,
                                  long long post, int exact, int recip_row0,
                                  void* stream) {
  if (pre < 1 || n < 1 || post < 1) return (int)cudaErrorInvalidValue;
  const long long lines = pre * post;
  const long long blocks = (lines + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  tridiag_rows_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (const float*)c, (const float*)d,
      (float*)x, (float*)cp, n, post, lines, exact, recip_row0);
  return (int)cudaGetLastError();
}
