// One local ADI iteration of one sweep direction, all variables (u, v, w, T
// in 3D; u, v, T in 2D), for sm_90a.  The pair sweep is two launches of it;
// the stream sweep is one launch with the T forcing supplied by the caller.
//
// Replaces: cmcfs_tpu/ops/pallas_sweep_nl.py::fused_sweep_nl (kernel body
//   _make_kernel), which runs both local iterations of a direction in one
//   TPU launch.  Per iteration this kernel builds the tridiagonal rows from
//   the line classes (sweep_common.build_abc), the right-hand side
//   rhs*3/dt (- v_T dT/dh on the sweep velocity, + t_phi*diss on T, with
//   the dissipation's cross derivatives read from the neighbouring lines),
//   Dirichlet d values read from temp (the UpdateBoundaries invariant),
//   solves with Thomas in the reference operation order (ops/tridiag.py),
//   and writes UpdateSegment + the NODE_IN merge (+ the folded global
//   MergeLayer when gmerge is set).  Every product is rounded before it is
//   added (__fmul_rn / __fadd_rn / __fsub_rn: no contraction into FMAs), in
//   the plain PyTorch version's order of operations, so the kernel rounds
//   as that version does; the 2D solver's v_T dt/(2h) (115 at the 2D
//   bench's parameters) would otherwise turn one ulp of T into 115 of v.
// Also replaces: cmcfs_tpu/ops/pallas_sweep_stream.py::fused_sweep_stream,
//   one local iteration whose T forcing t_phi*diss is computed by the caller
//   (entry point cmcfs_stream_sweep_iter, forcing != null), in its 3D form
//   and its 2D merge2d one (3 variables, T last, the 2D FREE rows, RHS
//   rhs*1/dt, and the copy-then-merge update of AdiSolver2D.cpp:203-226:
//   out = x and temp = first ? x : (temp + x)/2 on INTERIOR cells only,
//   pallas_sweep_stream.py:287-294).  A 2D field (nx, ny) is swept as the
//   3D view (1, nx, ny) on axis 1 (X) or 2 (Y); ``axis_var`` names the
//   velocity that advects.
//
// What bounds it on this card: memory traffic and latency.  Per iteration a
//   line's thread streams ~12 field reads (adv, rhs x4, temp x4, out_prev x4,
//   masks, the T-line and the +-1 neighbour lines of adv) and 8 field
//   writes (out x4, tn x4), plus the c'/r/d' scratch round trip.  It does a
//   few flops per byte, far below the card's compute-to-bandwidth ratio.
//   Parallelism is one thread per grid line (65,536 lines at 256^3), so
//   the card holds about a quarter of its resident-thread capacity and
//   relies on independent lines to hide load latency.
//
// What the design does about it: threadIdx.x runs along the contiguous
//   cross dimension, so the X and Y sweeps read and write whole coalesced
//   rows; the scratch arrays are laid out [row][line] so their accesses are
//   coalesced on every axis.  The Z sweep, whose line is the contiguous
//   axis, reads strided (one cache sector per thread per row) and relies on
//   L1 reuse across consecutive rows.  Outputs go to buffers distinct from
//   temp: neighbouring lines read temp[axis] while this one writes tn.
//   Lines at the grid edge clamp their +-1 cross-line reads to themselves;
//   those values only feed cells that are never NODE_IN.
//   Not done yet: one fused launch per pair with halo lines recomputed in
//   shared-memory tiles, a coalesced Z sweep, and TMA staging.
#include <cstdint>

#include <cuda_runtime.h>

#include "rows.cuh"

namespace {

constexpr int kFree = 1;      // core/types.py BCtype.FREE
constexpr int kThreads = 128;

struct Mode {
  int nvars;     // 4 (u, v, w, T) or 3 (2D: u, v, T, the 2D FREE rows and
                 // update: writes masked by INTERIOR, copy-then-merge)
  int axis_var;  // the velocity that advects along the sweep
  int exact, gmerge;
  int first;     // 2D: the first local iteration copies x into temp
};

struct Scal {                 // models/adi3d._nl_scal, float32
  float v_vis_h2, t_vis_h2, inv3dt, inv2h, v_T, t_phi, inv2h_1, inv2h_2;
};

__global__ void __launch_bounds__(kThreads)
pair_sweep_iter_kernel(const float* __restrict__ temp,
                       const int8_t* __restrict__ cls,
                       const int8_t* __restrict__ bcv,
                       const int8_t* __restrict__ bct,
                       const float* __restrict__ rhs,
                       const float* __restrict__ op,
                       const float* __restrict__ forcing,
                       float* __restrict__ out, float* __restrict__ tn,
                       float* __restrict__ scratch, int n, long long sp,
                       int n1, long long s1, int n2, long long s2,
                       long long fs, int axis, Mode m, Scal s) {
  const int i2 = blockIdx.x * blockDim.x + threadIdx.x;
  const int i1 = blockIdx.y;
  if (i2 >= n2) return;
  const long long lines = (long long)n1 * n2;
  const long long line = (long long)i1 * n2 + i2;
  const long long base = i1 * s1 + i2 * s2;
  float* cp = scratch + line;                  // c' of row p at cp[p*lines]
  float* rr = scratch + n * lines + line;      // denominator or reciprocal
  float* dp = scratch + 2 * n * lines + line;  // d'
  const int tv = m.nvars - 1;                   // T
  const bool two_d = is_2d(m.nvars);
  const float* adv = temp + m.axis_var * fs;
  const float* tT = temp + tv * fs;
  // the two other velocities (o1 < o2), whose axes are the cross dims
  const float* t1 = temp + (axis == 0 ? 1 : 0) * fs;
  const float* t2 = temp + (axis == 2 ? 1 : 2) * fs;
  const long long m1 = i1 > 0 ? -s1 : 0, p1 = i1 < n1 - 1 ? s1 : 0;
  const long long m2 = i2 > 0 ? -s2 : 0, p2 = i2 < n2 - 1 ? s2 : 0;

  // g = 0: the velocity chain (u, v, w share rows); g = 1: T's rows
  for (int g = 0; g < 2; ++g) {
    const float vis = g ? s.t_vis_h2 : s.v_vis_h2;
    const int8_t* fr = g ? bct : bcv;
    const float b_int = s.inv3dt + 2.0f * vis;

    float c_prev = 0.f;
    for (int p = 0; p < n; ++p) {
      const long long o = base + p * sp;
      float a, b, c;
      build_abc(cls[o], fr[o] == kFree, two_d, __fmul_rn(adv[o], s.inv2h),
                vis, b_int, a, b, c);
      if (p == n - 1) c = 0.f;
      float cn, r;
      if (p == 0) {
        cn = c / b;
        r = b;
      } else {
        const float denom = __fsub_rn(b, __fmul_rn(a, c_prev));
        if (m.exact) {
          cn = c / denom;
          r = denom;
        } else {
          r = 1.0f / denom;
          cn = c * r;
        }
      }
      cp[p * lines] = cn;
      rr[p * lines] = r;
      c_prev = cn;
    }

    for (int v = g ? tv : 0; v < (g ? tv + 1 : tv); ++v) {
      const float* tvar = temp + v * fs;
      float d_prev = 0.f;
      for (int p = 0; p < n; ++p) {
        const long long o = base + p * sp;
        const int cl = cls[o];
        const bool free = fr[o] == kFree;
        float d = 0.f;
        float a = 0.f;
        if (cl == kInterior) {
          const long long om = p > 0 ? o - sp : o;
          const long long on = p < n - 1 ? o + sp : o;
          a = -__fmul_rn(adv[o], s.inv2h) - vis;
          d = __fmul_rn(rhs[v * fs + o], s.inv3dt);
          if (v == m.axis_var) {
            const float gT = __fmul_rn(tT[on] - tT[om], s.inv2h);
            d = __fsub_rn(d, __fmul_rn(s.v_T, gT));
          } else if (v == tv && forcing) {
            d = __fadd_rn(d, forcing[o]);
          } else if (v == tv) {
            const float gav = __fmul_rn(adv[on] - adv[om], s.inv2h);
            const float go1 = __fmul_rn(t1[on] - t1[om], s.inv2h);
            const float go2 = __fmul_rn(t2[on] - t2[om], s.inv2h);
            const float h1 = __fmul_rn(adv[o + p1] - adv[o + m1], s.inv2h_1);
            const float h2 = __fmul_rn(adv[o + p2] - adv[o + m2], s.inv2h_2);
            const float sav = __fmul_rn(2.f * gav, gav);
            const float s1 = __fmul_rn(go1, go1), s2 = __fmul_rn(go2, go2);
            // the term order of ops/pair_sweep._forcing
            float diss = axis == 0   ? __fadd_rn(__fadd_rn(sav, s1), s2)
                         : axis == 1 ? __fadd_rn(__fadd_rn(s1, sav), s2)
                                     : __fadd_rn(__fadd_rn(s1, s2), sav);
            diss = __fadd_rn(__fadd_rn(diss, __fmul_rn(go1, h1)),
                             __fmul_rn(go2, h2));
            d = __fadd_rn(d, __fmul_rn(s.t_phi, diss));
          }
        } else if (cl == kBC0 || cl == kBC1) {
          d = free ? 0.f : tvar[o];
          if (cl == kBC1 && free) a = two_d ? 1.f : -1.f;
        }
        float dn;
        if (p == 0) {
          dn = d / rr[0];
        } else {
          const float num = __fsub_rn(d, __fmul_rn(d_prev, a));
          dn = m.exact ? num / rr[p * lines] : num * rr[p * lines];
        }
        dp[p * lines] = dn;
        d_prev = dn;
      }

      // backward substitution, UpdateSegment and the NODE_IN merge (3D),
      // or the 2D copy-then-merge
      float x = 0.f;
      for (int p = n - 1; p >= 0; --p) {
        const long long o = base + p * sp;
        x = p == n - 1 ? dp[p * lines]
                       : __fsub_rn(dp[p * lines], __fmul_rn(cp[p * lines], x));
        const int cl = cls[o];
        const float told = tvar[o];
        float onew, tnew = told;
        if (two_d) {
          onew = cl == kInterior ? x : op[v * fs + o];
          if (cl == kInterior) tnew = m.first ? x : (told + x) * 0.5f;
        } else {
          onew = cl != 0 ? x : op[v * fs + o];
          if (cl == kInterior) {
            tnew = (told + onew) * 0.5f;
            if (m.gmerge) tnew = (tnew + onew) * 0.5f;
          }
        }
        out[v * fs + o] = onew;
        tn[v * fs + o] = tnew;
      }
    }
  }
}

int launch(const void* temp, const void* cls, const void* bcv,
           const void* bct, const void* rhs, const void* op,
           const void* forcing, void* out, void* tn, void* scratch, int nx,
           int ny, int nz, int axis, const Mode& m, const Scal& s,
           void* stream) {
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
  if (n < 1 || n1 < 1 || n2 < 1 || n1 > 65535 || m.nvars < 3 ||
      m.nvars > 4 || m.axis_var < 0 || m.axis_var >= m.nvars - 1)
    return (int)cudaErrorInvalidValue;
  const dim3 block(kThreads);
  const dim3 grid((n2 + kThreads - 1) / kThreads, n1);
  pair_sweep_iter_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)temp, (const int8_t*)cls, (const int8_t*)bcv,
      (const int8_t*)bct, (const float*)rhs, (const float*)op,
      (const float*)forcing, (float*)out, (float*)tn, (float*)scratch, n, sp,
      n1, s1, n2, s2, (long long)nx * ny * nz, axis, m, s);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch one pair-sweep iteration on ``stream``.  All fields are
// contiguous (4, nx, ny, nz) float32; masks (nx, ny, nz) int8; scratch
// holds 3 * n * (lines) floats, n the sweep length.  Returns
// cudaGetLastError().
extern "C" int cmcfs_pair_sweep_iter(
    const void* temp, const void* cls, const void* bcv, const void* bct,
    const void* rhs, const void* op, void* out, void* tn, void* scratch,
    int nx, int ny, int nz, int axis, int exact, int gmerge, float v_vis_h2,
    float t_vis_h2, float inv3dt, float inv2h, float v_T, float t_phi,
    float inv2h_1, float inv2h_2, void* stream) {
  const Scal s{v_vis_h2, t_vis_h2, inv3dt, inv2h, v_T, t_phi, inv2h_1,
               inv2h_2};
  const Mode m{4, axis, exact, gmerge, 0};
  return launch(temp, cls, bcv, bct, rhs, op, nullptr, out, tn, scratch, nx,
                ny, nz, axis, m, s, stream);
}

// Launch one stream-sweep iteration: as above with the T forcing
// ``forcing`` (nx, ny, nz) float32 = t_phi * diss_axis(temp) and no
// global-merge fold; fields (nvars, nx, ny, nz).  3D: nvars 4, axis_var =
// axis.  2D: nvars 3 on the view (1, nx, ny) (the 2D rows and update,
// ``first``), inv3dt = 1/dt.  Returns cudaGetLastError().
extern "C" int cmcfs_stream_sweep_iter(
    const void* temp, const void* cls, const void* bcv, const void* bct,
    const void* rhs, const void* op, const void* forcing, void* out,
    void* tn, void* scratch, int nx, int ny, int nz, int axis, int exact,
    int nvars, int axis_var, int first,
    float v_vis_h2, float t_vis_h2, float inv3dt, float inv2h, float v_T,
    void* stream) {
  if (!forcing) return (int)cudaErrorInvalidValue;
  const Scal s{v_vis_h2, t_vis_h2, inv3dt, inv2h, v_T, 0.f, 0.f, 0.f};
  const Mode m{nvars, axis_var, exact, 0, first};
  return launch(temp, cls, bcv, bct, rhs, op, forcing, out, tn, scratch, nx,
                ny, nz, axis, m, s, stream);
}
