// One local ADI iteration of one sweep direction, all four variables
// (u, v, w, T), for sm_90a.  The pair sweep is two launches of it; the
// stream sweep is one launch with the T forcing supplied by the caller.
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
//   MergeLayer when gmerge is set).
// Also replaces: cmcfs_tpu/ops/pallas_sweep_stream.py::fused_sweep_stream
//   (3D form), one local iteration whose T forcing t_phi*diss is computed
//   by the caller (entry point cmcfs_stream_sweep_iter, forcing != null).
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

namespace {

constexpr int kBC0 = 1;       // ops/masks.py line classes
constexpr int kBC1 = 2;
constexpr int kInterior = 3;
constexpr int kFree = 1;      // core/types.py BCtype.FREE
constexpr int kThreads = 128;

struct Scal {                 // models/adi3d._nl_scal, float32
  float v_vis_h2, t_vis_h2, inv3dt, inv2h, v_T, t_phi, inv2h_1, inv2h_2;
};

// sweep_common.build_abc, 3D form
__device__ __forceinline__ void build_abc(int cl, bool free, float adv2h,
                                          float vis, float b_int, float& a,
                                          float& b, float& c) {
  if (cl == kInterior) {
    a = -adv2h - vis;
    b = b_int;
    c = adv2h - vis;
  } else if (cl == kBC0) {
    a = 0.f;
    b = free ? 2.f : 1.f;
    c = free ? -1.f : 0.f;
  } else if (cl == kBC1) {
    a = free ? -1.f : 0.f;
    b = free ? 2.f : 1.f;
    c = 0.f;
  } else {
    a = 0.f;
    b = 1.f;
    c = 0.f;
  }
}

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
                       long long fs, int axis, int exact, int gmerge,
                       Scal s) {
  const int i2 = blockIdx.x * blockDim.x + threadIdx.x;
  const int i1 = blockIdx.y;
  if (i2 >= n2) return;
  const long long lines = (long long)n1 * n2;
  const long long line = (long long)i1 * n2 + i2;
  const long long base = i1 * s1 + i2 * s2;
  float* cp = scratch + line;                  // c' of row p at cp[p*lines]
  float* rr = scratch + n * lines + line;      // denominator or reciprocal
  float* dp = scratch + 2 * n * lines + line;  // d'
  const float* adv = temp + axis * fs;
  const float* tT = temp + 3 * fs;
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
      build_abc(cls[o], fr[o] == kFree, adv[o] * s.inv2h, vis, b_int, a, b,
                c);
      if (p == n - 1) c = 0.f;
      float cn, r;
      if (p == 0) {
        cn = c / b;
        r = b;
      } else {
        const float denom = b - a * c_prev;
        if (exact) {
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

    for (int v = g ? 3 : 0; v < (g ? 4 : 3); ++v) {
      const float* tv = temp + v * fs;
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
          a = -(adv[o] * s.inv2h) - vis;
          d = rhs[v * fs + o] * s.inv3dt;
          if (v == axis) {
            d = d - s.v_T * ((tT[on] - tT[om]) * s.inv2h);
          } else if (v == 3 && forcing) {
            d = d + forcing[o];
          } else if (v == 3) {
            const float gav = (adv[on] - adv[om]) * s.inv2h;
            const float go1 = (t1[on] - t1[om]) * s.inv2h;
            const float go2 = (t2[on] - t2[om]) * s.inv2h;
            const float h1 = (adv[o + p1] - adv[o + m1]) * s.inv2h_1;
            const float h2 = (adv[o + p2] - adv[o + m2]) * s.inv2h_2;
            float diss;
            if (axis == 0)
              diss = 2.f * gav * gav + go1 * go1 + go2 * go2 + go1 * h1 +
                     go2 * h2;
            else if (axis == 1)
              diss = go1 * go1 + 2.f * gav * gav + go2 * go2 + go1 * h1 +
                     go2 * h2;
            else
              diss = go1 * go1 + go2 * go2 + 2.f * gav * gav + go1 * h1 +
                     go2 * h2;
            d = d + s.t_phi * diss;
          }
        } else if (cl == kBC0 || cl == kBC1) {
          d = free ? 0.f : tv[o];
          if (cl == kBC1 && free) a = -1.f;
        }
        float dn;
        if (p == 0) {
          dn = d / rr[0];
        } else {
          const float num = d - d_prev * a;
          dn = exact ? num / rr[p * lines] : num * rr[p * lines];
        }
        dp[p * lines] = dn;
        d_prev = dn;
      }

      // backward substitution, UpdateSegment and the NODE_IN merge
      float x = 0.f;
      for (int p = n - 1; p >= 0; --p) {
        const long long o = base + p * sp;
        x = p == n - 1 ? dp[p * lines] : dp[p * lines] - cp[p * lines] * x;
        const int cl = cls[o];
        const float onew = cl != 0 ? x : op[v * fs + o];
        const float told = tv[o];
        float tnew = told;
        if (cl == kInterior) {
          tnew = (told + onew) * 0.5f;
          if (gmerge) tnew = (tnew + onew) * 0.5f;
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
           int ny, int nz, int axis, int exact, int gmerge, const Scal& s,
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
  if (n < 1 || n1 < 1 || n2 < 1 || n1 > 65535) return (int)cudaErrorInvalidValue;
  const dim3 block(kThreads);
  const dim3 grid((n2 + kThreads - 1) / kThreads, n1);
  pair_sweep_iter_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)temp, (const int8_t*)cls, (const int8_t*)bcv,
      (const int8_t*)bct, (const float*)rhs, (const float*)op,
      (const float*)forcing, (float*)out, (float*)tn, (float*)scratch, n, sp,
      n1, s1, n2, s2, (long long)nx * ny * nz, axis, exact, gmerge, s);
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
  return launch(temp, cls, bcv, bct, rhs, op, nullptr, out, tn, scratch, nx,
                ny, nz, axis, exact, gmerge, s, stream);
}

// Launch one stream-sweep iteration: as above with the T forcing
// ``forcing`` (nx, ny, nz) float32 = t_phi * diss_axis(temp) and no
// global-merge fold.
extern "C" int cmcfs_stream_sweep_iter(
    const void* temp, const void* cls, const void* bcv, const void* bct,
    const void* rhs, const void* op, const void* forcing, void* out,
    void* tn, void* scratch, int nx, int ny, int nz, int axis, int exact,
    float v_vis_h2, float t_vis_h2, float inv3dt, float inv2h, float v_T,
    void* stream) {
  if (!forcing) return (int)cudaErrorInvalidValue;
  const Scal s{v_vis_h2, t_vis_h2, inv3dt, inv2h, v_T, 0.f, 0.f, 0.f};
  return launch(temp, cls, bcv, bct, rhs, op, forcing, out, tn, scratch, nx,
                ny, nz, axis, exact, 0, s, stream);
}
