// Row build + Thomas solve of one sweep direction on caller-built
// right-hand sides, all variables of the step: u, v, w, T in 3D, u, v, T
// in 2D (``nvars`` 4 or 3; T is the last), for sm_90a.
//
// Replaces three TPU kernels that compute one function and differ only in
//   how they tile VMEM: cmcfs_tpu/ops/pallas_sweep_dma.py::fused_sweep_dma
//   (lines up to 288 cells), pallas_sweep_long.py::fused_sweep_long (longer
//   lines, chunked, (c', d') staged through HBM) and
//   pallas_sweep.py::fused_sweep (the BlockSpec form), in their 3D form and
//   their 2D one (t_var = 2, bc2d: the 2D ADI solver's rows, called with
//   bc_temp as both masks, cmcfs_tpu/models/adi2d.py:92-137).  Each builds
//   the tridiagonal rows in-kernel from the advection field and one packed
//   mask (code = cls + 4*bc_vel + 8*bc_temp, build_abc of rows.cuh) and runs
//   Thomas in pallas_sweep_dma._solve_var's order: a = 0 on row 0, c = 0 on
//   row n-1, denom = b - a*c', two IEEE divisions (exact) or one IEEE
//   reciprocal and two multiplies, back substitution x = d' - c'*x_next.
//   Products are rounded before the subtraction (__fmul_rn / __fsub_rn),
//   as the TPU kernels and the plain PyTorch version round them.
//
// What bounds it on this card: memory traffic and latency.  Per cell the
//   compulsory traffic is adv and the packed mask read, d4 read and x4
//   written (37 bytes); the (c', d') scratch round trip adds 64 bytes.  A
//   handful of flops per byte, far below the card's compute-to-bandwidth
//   ratio, and a serial dependence along each line.
//
// What the design does about it: one thread per (line, variable), so at
//   384^3 the card holds 590k independent chains (a 2D grid only 3-6k: its
//   launches are bound by latency, not bytes); the variables of a line are
//   the warps of a block (threadIdx.y), so their adv and mask reads of one
//   row hit L1 together.  A 2D field (nx, ny) is swept as the 3D view
//   (1, nx, ny) on axis 1 (X, coalesced) or 2 (Y, strided).  threadIdx.x
//   runs along the contiguous cross dimension, so the X and Y sweeps read
//   and write whole coalesced rows; (c', d') sit in global scratch laid out
//   [row][line], so
//   their accesses coalesce on every axis and no length cap exists.  The Z
//   sweep, whose line is the contiguous axis, reads strided and relies on L1
//   reuse across consecutive rows.  Not done yet: shared-memory tiles for
//   (c', d') of short lines, a coalesced Z sweep, TMA staging.
#include <cstdint>

#include <cuda_runtime.h>

#include "rows.cuh"

namespace {

constexpr int kLines = 32;    // lines per block (threadIdx.x)

struct Scal {                 // [v_vis/h^2, t_vis/h^2, 3/dt, 1/(2h)], float32
  float v_vis_h2, t_vis_h2, inv3dt, inv2h;
};

__global__ void __launch_bounds__(kLines * 4)
line_sweep_kernel(const float* __restrict__ adv,
                  const int8_t* __restrict__ pk,
                  const float* __restrict__ d4, float* __restrict__ x4,
                  float* __restrict__ scratch, int n, long long sp, int n1,
                  long long s1, int n2, long long s2, long long fs, int exact,
                  int nvars, Scal s) {
  const int i2 = blockIdx.x * kLines + threadIdx.x;
  const int i1 = blockIdx.y;
  const int v = threadIdx.y;
  if (i2 >= n2) return;
  const long long lines = (long long)n1 * n2;
  const long long line = (long long)i1 * n2 + i2;
  const long long base = i1 * s1 + i2 * s2;
  float* cp = scratch + (long long)v * n * lines + line;  // c' of row p at cp[p*lines]
  float* dp = scratch + (long long)(nvars + v) * n * lines + line;
  const float* d = d4 + v * fs;
  float* x = x4 + v * fs;
  const int t_var = nvars - 1;
  const bool bc2d = is_2d(nvars);
  const float vis = v == t_var ? s.t_vis_h2 : s.v_vis_h2;
  const float b_int = s.inv3dt + 2.0f * vis;
  const int free_shift = v == t_var ? 3 : 2;   // bc_temp or bc_vel bit

  float c_prev = 0.f, d_prev = 0.f;
  for (int p = 0; p < n; ++p) {
    const long long o = base + p * sp;
    const int code = pk[o];
    const int cl = code & 3;
    const bool free = (code >> free_shift) & 1;
    const float adv2h = __fmul_rn(adv[o], s.inv2h);   // rounded, as plain
    float a, b, c;
    build_abc(cl, free, bc2d, adv2h, vis, b_int, a, b, c);
    if (p == 0) a = 0.f;
    if (p == n - 1) c = 0.f;
    const float denom = __fsub_rn(b, __fmul_rn(a, c_prev));
    const float num = __fsub_rn(d[o], __fmul_rn(d_prev, a));
    float cn, dn;
    if (exact) {
      cn = c / denom;
      dn = num / denom;
    } else {
      const float r = 1.0f / denom;
      cn = __fmul_rn(c, r);
      dn = __fmul_rn(num, r);
    }
    cp[p * lines] = cn;
    dp[p * lines] = dn;
    c_prev = cn;
    d_prev = dn;
  }

  float x_next = 0.f;
  for (int p = n - 1; p >= 0; --p) {
    const float xv = __fsub_rn(dp[p * lines], __fmul_rn(cp[p * lines], x_next));
    x[base + p * sp] = xv;
    x_next = xv;
  }
}

}  // namespace

// Launch one line sweep on ``stream``.  adv (nx, ny, nz) float32, pk
// (nx, ny, nz) int8, d4 and x4 contiguous (nvars, nx, ny, nz) float32;
// scratch holds 2 * nvars * n * (lines) floats, n the sweep length;
// the last variable (T) takes t_vis and the bc_temp bit, the others v_vis
// and the bc_vel bit; nvars 3 (2D) selects the 2D FREE rows.  Returns
// cudaGetLastError().
extern "C" int cmcfs_line_sweep(const void* adv, const void* pk,
                                const void* d4, void* x4, void* scratch,
                                int nx, int ny, int nz, int axis, int exact,
                                int nvars, float v_vis_h2, float t_vis_h2,
                                float inv3dt, float inv2h, void* stream) {
  const long long sx = (long long)ny * nz, sy = nz, sz = 1;
  int n, n1, n2;
  long long sp, s1, s2;
  if (axis == 0) {
    n = nx; sp = sx; n1 = ny; s1 = sy; n2 = nz; s2 = sz;
  } else if (axis == 1) {
    n = ny; sp = sy; n1 = nx; s1 = sx; n2 = nz; s2 = sz;
  } else if (axis == 2) {
    n = nz; sp = sz; n1 = nx; s1 = sx; n2 = ny; s2 = sy;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (n < 1 || n1 < 1 || n2 < 1 || n1 > 65535 || nvars < 3 || nvars > 4)
    return (int)cudaErrorInvalidValue;
  const Scal s{v_vis_h2, t_vis_h2, inv3dt, inv2h};
  const dim3 block(kLines, nvars);
  const dim3 grid((n2 + kLines - 1) / kLines, n1);
  line_sweep_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)adv, (const int8_t*)pk, (const float*)d4, (float*)x4,
      (float*)scratch, n, sp, n1, s1, n2, s2, (long long)nx * ny * nz, exact,
      nvars, s);
  return (int)cudaGetLastError();
}
