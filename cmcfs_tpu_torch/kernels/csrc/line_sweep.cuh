// Row build + Thomas solve of one sweep direction on caller-built
// right-hand sides, all variables of the step: u, v, w, T in 3D, u, v, T
// in 2D (``nvars`` 4 or 3; T is the last), for sm_90a.  The kernel and its
// host dispatch; the entry points are line_sweep.cu's (float32 d and x)
// and line_sweep_bf16.cu's (bf16 d and x).
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
//   Thomas in pallas_sweep_dma._solve_var's order (walk.cuh), which the
//   plain PyTorch version (ops/line_sweep.line_sweep_ref) repeats.
// The bf16 payload mode (the d type TD) replaces the TPU kernels' bf16
//   storage (pallas_sweep_dma.py:38, :79-81, :263; pallas_sweep_long.py:310,
//   :344-353): d is staged as bf16 (the words covering each run, by
//   cp.async: tile.cuh) and upcast where the walk reads a row, x written
//   as bf16 rounded to nearest even; adv, the code plane, the (c', d')
//   scratch and all arithmetic stay float32, as the TPU kernels' carries
//   do (21 B a cell compulsory in 3D, 17 in 2D).
//
// What bounds it on this card: memory traffic in 3D, each line's serial
//   walk in 2D.  Per cell a launch must read adv, the packed mask and d4
//   and write x4: 37 bytes in 3D, 29 in 2D.  Thomas adds its scratch,
//   written on the way forward and read on the way back: 6 planes in 3D
//   (c' of the velocity rows, c' of T's rows, d' of u, v, w, T), 5 in 2D,
//   so a launch moves 85 B a cell in 3D and 69 in 2D.  A handful of
//   operations a byte, far below the card's ratio; but a row's step depends
//   on the one before, and the 2D launches have only 1-2 k lines to
//   overlap, so there a row step's latency, not bytes, sets the time.
//
// What the design does about it (walk.cuh):
// * Six chains, one forward and one backward walk a launch.  One thread
//   walks one line for all variables; u, v and w have the same rows (the
//   same vis and the bc_vel bit; in 2D u and v), so their c' chain is
//   computed once.  The scratch is (nvars + 2, n, columns),
//   [plane][row][column], each value written once and read once, its
//   columns padded so that every block's run of a row starts 256-byte
//   aligned.
// * Rows fetched ahead: chunk buffers of L lines x R rows x S stages, filled
//   by cp.async while the block walks the previous chunk; the backward walk
//   fetches its scratch rows the same way.
// * A coalesced Z sweep (and the 2D Y sweep, the contiguous axis of the
//   (1, nx, ny) view): a chunk is L runs of R contiguous floats (and the
//   mask words covering them) in a padded [row][line] tile; x goes back
//   through the same tile as the same runs.
// * No (c', d') ring on chip for long lines: a 383-row line's six chains
//   take 9 KB, so a ring for 64 lines would cut the lines resident on an
//   SM, where the launch needs them all to keep its loads in flight; the
//   B7 probe (kernel_probe.cu) found (c', d') on chip slower than the full
//   round trip through device memory.  Long lines are chunks like any.
// * Tiles (L x R x S), per mode, from H100 timings (PERF.md, Findings):
//   3D X and Y 64 x 2 x 2 (6 KB a block, the pair kernel's X/Y tile: lines
//   resident, not rows in flight, set the speed); 3D Z 64 x 16 x 3 (64-byte
//   runs a line and chunk, 74 KB a block), which chip_smoke.py phase 9
//   times beside the Z tiles of 8 rows (32-byte runs, 64 x 8 x 3) and 32
//   rows (128-byte runs, 32 x 32 x 3), kZ8* and kZ32*; 2D 8 x 8 x 4 (5-8
//   KB), so the 1,041-2,048 lines of the 2D cases run as 131-256 blocks
//   over the card's 132 SMs: a 2D launch is bound by each line's walk.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "rows.cuh"
#include "walk.cuh"

namespace {

// Tiles: L lines a block, R rows a chunk, S chunk buffers
constexpr int kXyL = 64, kXyR = 2, kXyS = 2;    // 3D X and Y sweeps
constexpr int kZL = 64, kZR = 16, kZS = 3;      // 3D Z sweep
constexpr int k2dL = 8, k2dR = 8, k2dS = 4;     // 2D sweeps (X and Y)
// the 3D Z tiles a caller may name by their rows (``z_rows``), timed
// beside kZR: 32-byte and 128-byte runs
constexpr int kZ8L = 64, kZ8S = 3;
constexpr int kZ32L = 32, kZ32S = 3;

struct Scal {                 // [v_vis/h^2, t_vis/h^2, 3/dt, 1/(2h)], float32
  float v_vis_h2, t_vis_h2, inv3dt, inv2h;
};

// The rows of the line sweep: staged adv and d of every variable (d of
// type TD, float32 or bf16) and the packed code; chain 0 is the
// velocities' rows (v_vis, the bc_vel bit), chain 1 T's (t_vis, the
// bc_temp bit).
template <int NV, class TD>
struct LineRows {
  static constexpr int kNF = 1 + NV, kNC = 2, kND = NV;
  static constexpr bool kMask = true;
  // bf16 d planes are staged (tile.cuh): read() upcasts them from the tile
  static constexpr bool kStaged = !std::is_same<TD, float>::value;
  const float* adv;
  const TD* d;
  const int8_t* pk;
  long long fs;
  Scal s;
  __device__ static constexpr int chain(int v) { return v == NV - 1; }
  template <class Ln>
  __device__ void fetch(const Ln& lane, int i, unsigned sa, long long o,
                        bool full, int rows_v, int lines_v) const {
    // float32: one pointer select (the two branches below compile to
    // other float32 code: the walk's SASS would change)
    if constexpr (std::is_same<TD, float>::value)
      lane.copy(sa, (i == 0 ? adv : d + (i - 1) * fs) + o, full, rows_v,
                lines_v, NoShift());
    else if (i == 0)
      lane.copy(sa, adv + o, full, rows_v, lines_v, NoShift());
    else
      lane.copy(sa, d + (i - 1) * fs + o, full, rows_v, lines_v, NoShift());
  }
  // A staged row (kStaged): adv from its float slot, each d from its bf16
  // slot; the block's first cell lies o0 past a plane's first cell, the
  // chunk's runs (rows lines fast, lines rows fast) rs apart; row r of
  // line t.  Only the parity of an element offset matters (bf16_half),
  // which a chunk's first row (k R, R even) leaves alone.
  template <bool kLinesFast, int L, int R, int kS, int kPlane>
  __device__ void read(const float* st, long long o0, int rs, int r, int t,
                       float (&f)[kNF]) const {
    f[0] = st[r * kS + t];
    const unsigned run = (unsigned)o0 + (unsigned)(kLinesFast ? r : t) * rs;
#pragma unroll
    for (int v = 0; v < NV; ++v)
      f[1 + v] = staged_bf16<kLinesFast, L, R>(
          st + (1 + v) * kPlane, bf16_half(d, (unsigned)(v * fs) + run), r,
          t);
  }
  __device__ const int8_t* mask() const { return pk; }
  __device__ void rows(const float (&f)[kNF], int code, float (&a)[2],
                       float (&b)[2], float (&c)[2], float (&dd)[NV]) const {
    const int cl = code & 3;
    const float adv2h = __fmul_rn(f[0], s.inv2h);   // rounded, as plain
    build_abc(cl, (code >> 2) & 1, is_2d(NV), adv2h, s.v_vis_h2,
              s.inv3dt + 2.0f * s.v_vis_h2, a[0], b[0], c[0]);
    build_abc(cl, (code >> 3) & 1, is_2d(NV), adv2h, s.t_vis_h2,
              s.inv3dt + 2.0f * s.t_vis_h2, a[1], b[1], c[1]);
#pragma unroll
    for (int v = 0; v < NV; ++v) dd[v] = f[1 + v];
  }
};

template <int NV, bool kZ, bool kExact, int L, int R, int S, class TD>
__global__ void __launch_bounds__(L)
line_sweep_kernel(LineRows<NV, TD> pol, Lines g, int recip_row0,
                  TD* __restrict__ x, float* __restrict__ scratch) {
  walk<LineRows<NV, TD>, kZ, kExact, L, R, S>(pol, g, recip_row0, x,
                                               scratch);
}

template <int NV, bool kZ, int L, int R, int S, class TD>
int launch_tile(const LineRows<NV, TD>& pol, const Lines& g, int exact,
                TD* x, float* scratch, cudaStream_t st) {
  return exact ? launch_walk<LineRows<NV, TD>, kZ, L, R, S>(
                     line_sweep_kernel<NV, kZ, true, L, R, S, TD>, pol, g, 1,
                     x, scratch, st)
               : launch_walk<LineRows<NV, TD>, kZ, L, R, S>(
                     line_sweep_kernel<NV, kZ, false, L, R, S, TD>, pol, g,
                     1, x, scratch, st);
}

// One line sweep of d4 (TD) into x4 (TD): the arguments of the entry
// points (line_sweep.cu).
template <class TD>
int launch_lines(const void* adv, const void* pk, const void* d4, void* x4,
                 void* scratch, int nx, int ny, int nz, int axis, int exact,
                 int nvars, int z_rows, const Scal& s, void* stream) {
  const long long sx = (long long)ny * nz, sy = nz, sz = 1;
  Lines g;
  g.fs = (long long)nx * ny * nz;
  if (axis == 0) {
    g.n = nx; g.sp = sx; g.n1 = ny; g.s1 = sy; g.n2 = nz; g.s2 = sz;
  } else if (axis == 1) {
    g.n = ny; g.sp = sy; g.n1 = nx; g.s1 = sx; g.n2 = nz; g.s2 = sz;
  } else if (axis == 2) {
    g.n = nz; g.sp = sz; g.n1 = nx; g.s1 = sx; g.n2 = ny; g.s2 = sy;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (!lines_ok(g) || nvars < 3 || nvars > 4 ||
      (z_rows != 0 && (nvars != 4 || axis != 2)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  TD* const x = (TD*)x4;
  float* const sc = (float*)scratch;
  if (nvars == 3) {
    const LineRows<3, TD> pol{(const float*)adv, (const TD*)d4,
                              (const int8_t*)pk, g.fs, s};
    return axis == 2
               ? launch_tile<3, true, k2dL, k2dR, k2dS>(pol, g, exact, x, sc,
                                                        st)
               : launch_tile<3, false, k2dL, k2dR, k2dS>(pol, g, exact, x,
                                                         sc, st);
  }
  const LineRows<4, TD> pol{(const float*)adv, (const TD*)d4,
                            (const int8_t*)pk, g.fs, s};
  if (axis != 2)
    return launch_tile<4, false, kXyL, kXyR, kXyS>(pol, g, exact, x, sc, st);
  if (z_rows == 0 || z_rows == kZR)
    return launch_tile<4, true, kZL, kZR, kZS>(pol, g, exact, x, sc, st);
  if (z_rows == 8)
    return launch_tile<4, true, kZ8L, 8, kZ8S>(pol, g, exact, x, sc, st);
  if (z_rows == 32)
    return launch_tile<4, true, kZ32L, 32, kZ32S>(pol, g, exact, x, sc, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
