// The right-hand side that pair_sweep.cu and pcr_sweep.cu share: the 8
// scalars of models/adi3d._nl_scal, the T equation's in-kernel forcing
// t_phi * diss_axis(temp) (ops/pair_sweep._forcing) and the d of one
// variable at one cell (ops/pair_sweep.iteration_ref).  Every product is
// rounded before it is added, in the plain version's order.
#pragma once

#include "rows.cuh"

namespace {

struct Scal {                 // models/adi3d._nl_scal, float32
  float v_vis_h2, t_vis_h2, inv3dt, inv2h, v_T, t_phi, inv2h_1, inv2h_2;
};

// a[i] for a run-time i, by selects (no local-memory array)
template <int N>
__device__ __forceinline__ float pick(const float (&a)[N], int i) {
  float x = a[0];
#pragma unroll
  for (int k = 1; k < N; ++k) x = i == k ? a[k] : x;
  return x;
}

// t_phi * diss_axis(temp) at one cell of a sweep along ``axis``, from the
// temps of the previous and next cells along the line (pv, nx; u, v, w
// first) and the advecting velocity ``axis_var`` across it (ex: at -1 and
// +1 along the first cross axis, then the second); the term order of
// ops/pair_sweep._forcing.
template <int N, int NX>
__device__ __forceinline__ float diss_forcing(int axis, int axis_var,
                                              const float (&pv)[N],
                                              const float (&nx)[N],
                                              const float (&ex)[NX],
                                              const Scal& s) {
  const int o1 = axis == 0 ? 1 : 0, o2 = axis == 2 ? 1 : 2;
  const float gav =
      __fmul_rn(pick(nx, axis_var) - pick(pv, axis_var), s.inv2h);
  const float go1 = __fmul_rn(pick(nx, o1) - pick(pv, o1), s.inv2h);
  const float go2 = __fmul_rn(pick(nx, o2) - pick(pv, o2), s.inv2h);
  const float h1 = __fmul_rn(ex[1] - ex[0], s.inv2h_1);
  const float h2 = __fmul_rn(ex[3] - ex[2], s.inv2h_2);
  const float sav = __fmul_rn(2.f * gav, gav);
  const float q1 = __fmul_rn(go1, go1), q2 = __fmul_rn(go2, go2);
  float diss = axis == 0   ? __fadd_rn(__fadd_rn(sav, q1), q2)
               : axis == 1 ? __fadd_rn(__fadd_rn(q1, sav), q2)
                           : __fadd_rn(__fadd_rn(q1, q2), sav);
  diss = __fadd_rn(__fadd_rn(diss, __fmul_rn(go1, h1)), __fmul_rn(go2, h2));
  return __fmul_rn(s.t_phi, diss);
}

// The d of variable v (T when is_t) at a cell of class cl: interior rows
// rhs * 3/dt, - v_T gT on the advecting velocity axis_var, + fT on T;
// boundary rows 0 if FREE (fv for the velocities, ft for T), else the
// cell's temp t; identity rows 0.
__device__ __forceinline__ float rhs_d(int cl, int v, int axis_var, bool is_t,
                                       bool fv, bool ft, float t, float rh,
                                       float gT, float fT, const Scal& s) {
  float d = 0.f;
  if (cl == kInterior) {
    d = __fmul_rn(rh, s.inv3dt);
    if (v == axis_var)
      d = __fsub_rn(d, __fmul_rn(s.v_T, gT));
    else if (is_t)
      d = __fadd_rn(d, fT);
  } else if (cl == kBC0 || cl == kBC1) {
    d = (is_t ? ft : fv) ? 0.f : t;
  }
  return d;
}

}  // namespace
