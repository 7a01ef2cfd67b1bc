// The tridiagonal row build that line_sweep.cu and pair_sweep.cu share:
// the line classes of ops/masks.py and the rows of
// ops/sweep_common.build_abc.  A kernel sweeps 4 variables (u, v, w, T) in
// 3D and 3 (u, v, T) in 2D, so the number of variables names the mode.
#pragma once

namespace {

constexpr int kBC0 = 1;       // ops/masks.py line classes
constexpr int kBC1 = 2;
constexpr int kInterior = 3;

// The 2D ADI solver's mode: 3 variables, T the last, the 2D FREE rows.
__device__ __forceinline__ bool is_2d(int nvars) { return nvars == 3; }

// sweep_common.build_abc: interior rows (-adv/(2h) - vis, b_int,
// adv/(2h) - vis), with adv2h rounded by the caller; FREE boundary rows
// (2, -1 | -1, 2) in 3D, (1, -1 | +1, -1) in 2D (bc2d); Dirichlet and
// identity rows (0, 1, 0).
__device__ __forceinline__ void build_abc(int cl, bool free, bool bc2d,
                                          float adv2h, float vis, float b_int,
                                          float& a, float& b, float& c) {
  if (cl == kInterior) {
    a = -adv2h - vis;
    b = b_int;
    c = adv2h - vis;
  } else if (cl == kBC0) {
    a = 0.f;
    b = free && !bc2d ? 2.f : 1.f;
    c = free ? -1.f : 0.f;
  } else if (cl == kBC1) {
    a = free ? (bc2d ? 1.f : -1.f) : 0.f;
    b = free ? (bc2d ? -1.f : 2.f) : 1.f;
    c = 0.f;
  } else {
    a = 0.f;
    b = 1.f;
    c = 0.f;
  }
}

}  // namespace
