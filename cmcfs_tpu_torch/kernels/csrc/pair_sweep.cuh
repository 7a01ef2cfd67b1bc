// One local ADI iteration of one sweep direction, all variables (u, v, w, T
// in 3D; u, v, T in 2D), for sm_90a.  The pair sweep is two launches of it;
// the stream sweep is one launch with the T forcing supplied by the caller.
// The kernel and its host dispatch; the entry points are pair_sweep.cu's
// (float32 payloads), pair_sweep_bf16.cu's and stream_sweep_bf16.cu's (bf16
// payloads), built as three objects in parallel.
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
//   the plain PyTorch version's order of operations, so the kernel equals
//   that version bit for bit; the 2D solver's v_T dt/(2h) (115 at the 2D
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
// The dual mode (3D pair mode with a flag plane, template kDual) replaces
//   fused_sweep_nl's has_dual path (pallas_sweep_nl.py:193-202, 417-450,
//   491-512, 519-535): on lines where a one-cell wall with a FREE bc ends
//   one fluid run and starts the next, the cell is a BC1 row in pass A and
//   a BC0 row in pass B (flag bit 0), and the solution takes pass B inside
//   the runs that start there (bit 1).  The stream entry never sees duals
//   (odd num_local dual directions take the line sweep, as in cmcfs_tpu).
// The bf16 payload mode (the payload types P) replaces fused_sweep_nl's and
//   fused_sweep_stream's bf16 storage (pallas_sweep_nl.py:172, :225-271,
//   :956-959, :1002-1005; pallas_sweep_stream.py:28, :93-110, :447-452):
//   rhs and out_prev are staged as bf16 in the chunk buffers (the words
//   covering each run, by cp.async: tile.cuh) and upcast where the walks
//   read them, out and tn written as bf16 rounded to nearest even; temp,
//   the masks, the forcing and the scratch stay float32, as all
//   arithmetic does.  A pair is two launches,
//   so its first launch reads bf16 rhs and out_prev and writes float32
//   out1 and tn1 (the TPU kernel keeps them in float32 VMEM), its second
//   reads bf16 rhs and float32 out1 and writes bf16 (PayIn, PayOut); the
//   stream entry reads and writes bf16 (PayBf16).
//
// What bounds it on this card: device-memory traffic, and the latency of
//   each line's serial walk where too few lines share an SM.  A launch must
//   read temp, rhs and out_prev of every variable and the masks and write
//   out and tn (83 B a cell in 3D; the bf16 mode's pair 51 B a cell).
//   Thomas adds its scratch, written on the way forward and read on the way
//   back, and the backward pass reads temp, out_prev and the classes: 148 B
//   a cell moved in the 3D pair mode, 152 in the 3D stream mode, 120 in 2D,
//   by this count (float32 payloads); the pair mode's four
//   planes of cross-line neighbours (16 B a cell, read at each forward row,
//   mostly from cache) are not in it.  The arithmetic is a few operations a
//   byte, far below the card's ratio, but a warp's walk of one row takes
//   hundreds of dependent instructions, so a launch needs many lines on
//   each SM and several rows of loads in flight for each.
//
// What the design does about it:
// * One forward and one backward walk of a line a launch, for all
//   variables.  At each row the forward walk advances six chains at once
//   (c' of the velocity rows, c' of T's rows, d' of each variable; five in
//   2D); the reciprocal (or, exact, the denominator) is used in the same
//   step and never stored.  The scratch holds c'_vel, c'_T and each d',
//   laid out [plane][row][line] so every access to it is coalesced, each
//   value written once and read once.  The backward walk reads it with the
//   classes, temp and out_prev, and writes out and tn.
// * Rows fetched ahead of the chain.  A block of L consecutive lines walks
//   them in chunks of R rows through S chunk buffers in shared memory:
//   while the block computes chunk k, cp.async fills the others with chunks
//   k+1 .. k+S-1, so no load waits on the chain.  The forward walk runs one
//   row behind its loads, so a row's +-1 neighbours along the line come
//   from registers.  Each thread's copies of a chunk lie at offsets linear
//   in the copy's index, and whole chunks skip the edge tests.
// * A coalesced Z sweep.  On X and Y the threads run along the contiguous
//   cross axis: a chunk row of the block's lines is one coalesced run.  On
//   Z (and the 2D Y sweep, the contiguous axis of the view) the line is the
//   contiguous axis: thread t copies row t % R of lines t / R + j L / R, so
//   a chunk is L runs of R contiguous floats, into a [row][line] tile padded
//   against bank conflicts; each thread then walks its own line, writes out
//   and tn of a row into the tile slots of that row's d' and temp once it
//   has read them, and the block stores the tile back as the same runs.
//   The int8 masks are copied as the aligned 4-byte words that cover each
//   contiguous run (a word that holds a byte of the tensor never crosses a
//   page) and read at the run's byte offset.
// * Duals: the forward walk advances six more chains in lockstep, pass B's
//   c' of the velocity and T rows and its d' of each variable, on the same
//   d (a dual cell's d is the same in both roles); their carries part at a
//   dual cell and meet again at the next run's start.  Pass B's planes
//   follow pass A's in the scratch, so a launch moves 48 B a cell more,
//   and the flag plane is read on both walks (84 B a cell compulsory, 198
//   moved).  The backward walk substitutes both passes on their own
//   carries and updates from pass B's value where bit 1 is set, so
//   iteration 2 and its dissipation see the stitched field.
// * Tiles (L x R x S, the constants kXy*, kZ*, k2d*), chosen from H100
//   timings of the alternatives (PERF.md, Findings): 3D X/Y
//   64 x 2 x 2 (15 KB a block, so all 65,536 lines of a 256^3 sweep are
//   resident at once); 3D Z 64 x 8 x 3 (32-byte runs; shorter runs cost
//   more than the occupancy they buy); 2D 32 x 8 x 3 (1,024 lines at
//   1024^2: 32 SMs, a warp each, latency-bound).  The dual mode keeps the
//   X/Y tile and has a Z tile of its own (kZd*).
//
// Why a pair stays two launches: iteration 2 reads tn1 of the velocities on
//   the neighbouring lines (the dissipation's cross derivatives), and a
//   256-row line's out1 and tn1 take 8 KB, so no tile of lines keeps them on
//   chip: a single-launch pair would save one launch of a few microseconds
//   and no bytes.  Outputs go to buffers distinct from temp, as neighbouring
//   lines read temp while this one writes tn.  Lines at the grid edge clamp
//   their +-1 cross-line reads to themselves; those values only feed cells
//   that are never NODE_IN.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "rhs.cuh"
#include "rows.cuh"
#include "tile.cuh"

namespace {

constexpr int kFree = 1;      // core/types.py BCtype.FREE

// Tiles: L lines a block, R rows a chunk, S chunk buffers
constexpr int kXyL = 64, kXyR = 2, kXyS = 2;    // 3D X and Y sweeps
constexpr int kZL = 64, kZR = 8, kZS = 3;       // 3D Z sweep
constexpr int kZdL = 64, kZdR = 8, kZdS = 2;    // 3D Z sweep with duals
constexpr int k2dL = 32, k2dR = 8, k2dS = 3;    // 2D sweeps (X and Y)

struct Mode {
  int nvars;     // 4 (u, v, w, T) or 3 (2D: u, v, T, the 2D FREE rows and
                 // update: writes masked by INTERIOR, copy-then-merge)
  int axis_var;  // the velocity that advects along the sweep
  int exact, gmerge;
  int first;     // 2D: the first local iteration copies x into temp
};

// The lines of one launch: line (i1, i2) starts at i1*s1 + i2*s2, its rows
// p = 0..n-1 lie sp apart; variables lie fs apart.  Strides within a tile
// (R rows, L lines) fit in 32 bits.
struct Geo {
  int n, n1, n2, axis;
  long long sp, s1, s2, fs;
};

// Shared-memory layout of one block (in 4-byte words).  A plane is R rows
// of kS floats, row r of line l at r * kS + l.  On Z, kS pads L so that
// the rows-fast copies (R rows of 32 / R lines a warp) hit distinct banks.
// A mask plane holds kSegs contiguous byte runs (rows on X/Y, lines on Z)
// of kW words each.  Forward buffer: temp and rhs of every variable, the
// forcing (stream) or the 4 cross neighbours of adv (pair), 3 masks.
// Backward buffer: the scratch planes, temp, out_prev, the classes; on Z,
// out and tn of a row go back into the slots of its d' and temp once read.
// The two walks reuse the same memory.  With duals (kDual) the scratch
// holds pass B's planes after pass A's, and both buffers the flag plane
// after the other masks.
template <int NV, bool kForce, bool kZ, int L, int R, int S,
          bool kDual = false>
struct Tile {
  static_assert(L % 4 == 0 && (!kZ || R % 4 == 0),
                "mask runs are copied as whole words");
  static constexpr int kS = tile_stride<kZ, L, R>();
  static constexpr int kPlane = R * kS;
  static constexpr int kSegs = kZ ? L : R;
  static constexpr int kW = (kZ ? R : L) / 4 + 1;
  static constexpr int kMask = kSegs * kW;
  static constexpr int kNsA = NV + 2;                // a pass's planes
  static constexpr int kNs = kNsA * (kDual ? 2 : 1);  // scratch planes
  static constexpr int kNx = kForce ? 1 : 4;         // forcing | neighbours
  static constexpr int kFwdPlanes = 2 * NV + kNx;
  static constexpr int kFwd = kFwdPlanes * kPlane + (kDual ? 4 : 3) * kMask;
  static constexpr int kBwdPlanes = kNs + 2 * NV;
  static constexpr int kBwd = kBwdPlanes * kPlane + (kDual ? 2 : 1) * kMask;
  static constexpr int kWords = S * (kFwd > kBwd ? kFwd : kBwd);
};

// The dual plane's byte of a row (kDual only).
template <bool kDual>
struct RowFlag {};
template <>
struct RowFlag<true> {
  int fl;
};

// One row of a line, as the forward walk reads it from the tile.
template <int NV, bool kForce, bool kDual>
struct Row : RowFlag<kDual> {
  float t[NV];                 // temp
  float rh[NV];                // rhs
  float ex[kForce ? 1 : 4];    // forcing, or adv at o-s1, o+s1, o-s2, o+s2
  int cl;
  bool fv, ft;                 // bcv, bct == FREE
};

template <int NV, bool kForce, bool kZ, bool kExact, int L, int R, int S,
          bool kDual, class P>
__global__ void __launch_bounds__(L, 1)
pair_sweep_iter_kernel(const float* __restrict__ temp,
                       const int8_t* __restrict__ cls,
                       const int8_t* __restrict__ bcv,
                       const int8_t* __restrict__ bct,
                       const typename P::R* __restrict__ rhs,
                       const typename P::O* __restrict__ op,
                       const float* __restrict__ forcing,
                       typename P::W* __restrict__ out,
                       typename P::W* __restrict__ tn,
                       float* __restrict__ scratch, Geo g, Mode m, Scal s,
                       const int8_t* __restrict__ flags) {
  using Tl = Tile<NV, kForce, kZ, L, R, S, kDual>;
  using Rw = Row<NV, kForce, kDual>;
  constexpr int kS = Tl::kS, kPlane = Tl::kPlane, kW = Tl::kW;
  constexpr int tv = NV - 1;                    // T
  constexpr bool two_d = NV == 3;
  extern __shared__ float smem[];
  const int t = threadIdx.x;
  const int i1 = blockIdx.y;
  const int i20 = blockIdx.x * L;
  const int n = g.n;
  const int lines_v = min(L, g.n2 - i20);
  const bool valid = t < lines_v;
  const long long lines = (long long)g.n1 * g.n2;
  const long long line0 = (long long)i1 * g.n2 + i20;   // scratch column
  const long long base0 = i1 * g.s1 + i20 * g.s2;        // line 0's cell 0
  const long long sps = (long long)n * lines;           // scratch plane
  const int sp = (int)g.sp, s2 = (int)g.s2, lines32 = (int)lines;
  const int nch = (n + R - 1) / R;
  // byte runs of a mask chunk: rows (X/Y) or lines (Z), and where the
  // first byte of each lies in its word
  const int rstride = kZ ? s2 : sp;
  const int8_t* const mk[3] = {cls + base0, bcv + base0, bct + base0};
  int moff[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) moff[i] = (int)((uintptr_t)mk[i] & 3);
  auto run_off = [&](int i, int p0, int seg) {   // mod 4: unsigned wraps
    const unsigned row0 = (unsigned)p0 * (kZ ? 1u : (unsigned)sp);
    return (int)((moff[i] + row0 + (unsigned)seg * (unsigned)rstride) & 3u);
  };
  // kDual: the dual plane, copied and read as the masks are
  const int8_t* const mf = flags + base0;
  const int foff = (int)((uintptr_t)mf & 3);
  auto flag_off = [&](int p0, int seg) {
    const unsigned row0 = (unsigned)p0 * (kZ ? 1u : (unsigned)sp);
    return (int)((foff + row0 + (unsigned)seg * (unsigned)rstride) & 3u);
  };

  // ---- the copies: field planes in the tile's mapping, scratch planes
  // lines fast; shared addresses as bytes of the shared window
  const Lane<!kZ, L, R, kS> fld(t, sp, s2);
  const Lane<true, L, R, kS> scl(t, lines32, 1);
  const unsigned sb = (unsigned)__cvta_generic_to_shared(smem);
  auto chunk_rows = [&](int k) { return min(R, n - k * R); };
  auto is_full = [&](int k) { return chunk_rows(k) == R && lines_v == L; };

  // ---- forward buffers: chunk k in buffer k % S
  auto fetch_fwd = [&](int k) {
    const unsigned st = sb + 4u * ((k % S) * Tl::kFwd);
    auto plane = [&](int i) { return st + 4u * (i * kPlane); };
    const int p0 = k * R, rows_v = chunk_rows(k);
    const bool full = is_full(k);
    const long long o0 = base0 + (long long)p0 * g.sp;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      fld.copy(plane(v), temp + v * g.fs + o0, full, rows_v, lines_v,
               NoShift());
      fld.copy(plane(NV + v), rhs + v * g.fs + o0, full, rows_v, lines_v,
               NoShift());
    }
    if constexpr (kForce) {
      fld.copy(plane(2 * NV), forcing + o0, full, rows_v, lines_v,
               NoShift());
    } else {
      const float* adv = temp + m.axis_var * g.fs + o0;
      const int n2 = g.n2;
      fld.copy(plane(2 * NV), adv + (i1 > 0 ? -g.s1 : 0), full, rows_v,
               lines_v, NoShift());
      fld.copy(plane(2 * NV + 1), adv + (i1 < g.n1 - 1 ? g.s1 : 0), full,
               rows_v, lines_v, NoShift());
      fld.copy(plane(2 * NV + 2), adv, full, rows_v, lines_v,
               [=](int l) { return i20 + l > 0 ? -s2 : 0; });
      fld.copy(plane(2 * NV + 3), adv, full, rows_v, lines_v,
               [=](int l) { return i20 + l < n2 - 1 ? s2 : 0; });
    }
    const long long mo = kZ ? p0 : (long long)p0 * g.sp;
#pragma unroll
    for (int i = 0; i < 3; ++i)
      copy_mask<kZ, R, kW>(plane(Tl::kFwdPlanes) + 4u * (i * Tl::kMask), t,
                           rows_v, lines_v, mk[i] + mo, sp, s2);
    if constexpr (kDual)
      copy_mask<kZ, R, kW>(plane(Tl::kFwdPlanes) + 4u * (3 * Tl::kMask), t,
                           rows_v, lines_v, mf + mo, sp, s2);
  };

  // the element offset of a staged bf16 plane's run (row r on X/Y, line
  // t on Z), mod 2^32: bf16_half needs its parity only, which a chunk's
  // first row (k R, R even) leaves alone
  auto run_at = [&](int r) {
    return (unsigned)base0 +
           (unsigned)(kZ ? t : r) * (unsigned)(kZ ? s2 : sp);
  };
  auto read_fwd = [&](int k, int r, Rw& w) {
    const float* st = smem + (k % S) * Tl::kFwd;
    const int i = r * kS + t;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      w.t[v] = st[v * kPlane + i];
      if constexpr (std::is_same<typename P::R, float>::value)
        w.rh[v] = st[(NV + v) * kPlane + i];
      else
        w.rh[v] = staged_bf16<!kZ, L, R>(
            st + (NV + v) * kPlane,
            bf16_half(rhs, (unsigned)(v * g.fs) + run_at(r)), r, t);
    }
#pragma unroll
    for (int j = 0; j < Tl::kNx; ++j) w.ex[j] = st[(2 * NV + j) * kPlane + i];
    const unsigned* mw =
        reinterpret_cast<const unsigned*>(st + Tl::kFwdPlanes * kPlane);
    const int p0 = k * R, seg = kZ ? t : r, idx = kZ ? r : t;
    w.cl = mask_at<kW>(mw, seg, idx, run_off(0, p0, seg));
    w.fv = mask_at<kW>(mw + Tl::kMask, seg, idx, run_off(1, p0, seg)) ==
           kFree;
    w.ft = mask_at<kW>(mw + 2 * Tl::kMask, seg, idx, run_off(2, p0, seg)) ==
           kFree;
    if constexpr (kDual)
      w.fl = mask_at<kW>(mw + 3 * Tl::kMask, seg, idx, flag_off(p0, seg));
  };

  // ---- forward walk: the six (five) chains of row p, whose neighbours
  // along the line are pv and nx (p itself at the line's ends); with duals
  // six more, pass B's, on the rows where a dual cell takes the BC0 start
  // role, with the same d (pallas_sweep_nl.py:417-450, 491-512)
  const float b_int_v = s.inv3dt + 2.0f * s.v_vis_h2;
  const float b_int_t = s.inv3dt + 2.0f * s.t_vis_h2;
  float cpv = 0.f, cpt = 0.f, dp[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) dp[v] = 0.f;
  float cpvB = 0.f, cptB = 0.f, dpB[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) dpB[v] = 0.f;
  float* const sc0 = scratch + line0 + t;

  auto fwd_step = [&](int p, const Rw& pv, const Rw& cu, const Rw& nx) {
    const float adv2h = __fmul_rn(pick(cu.t, m.axis_var), s.inv2h);
    float av, bv, cv, at, bt, ct;
    build_abc(cu.cl, cu.fv, two_d, adv2h, s.v_vis_h2, b_int_v, av, bv, cv);
    build_abc(cu.cl, cu.ft, two_d, adv2h, s.t_vis_h2, b_int_t, at, bt, ct);
    if (p == n - 1) cv = ct = 0.f;
    float qv, qt;  // d' multiplies by them (reciprocal) or divides (exact)
    if (p == 0) {
      cpv = cv / bv;
      qv = bv;
      cpt = ct / bt;
      qt = bt;
    } else {
      const float dv = __fsub_rn(bv, __fmul_rn(av, cpv));
      const float dt = __fsub_rn(bt, __fmul_rn(at, cpt));
      if constexpr (kExact) {
        cpv = cv / dv;
        qv = dv;
        cpt = ct / dt;
        qt = dt;
      } else {
        qv = 1.0f / dv;
        cpv = cv * qv;
        qt = 1.0f / dt;
        cpt = ct * qt;
      }
    }
    // pass B: the rows of a dual cell take the BC0 start role
    float avB, atB, qvB, qtB;
    if constexpr (kDual) {
      const int clB = (cu.fl & 1) ? kBC0 : cu.cl;
      float bvB, cvB, btB, ctB;
      build_abc(clB, cu.fv, two_d, adv2h, s.v_vis_h2, b_int_v, avB, bvB, cvB);
      build_abc(clB, cu.ft, two_d, adv2h, s.t_vis_h2, b_int_t, atB, btB, ctB);
      if (p == n - 1) cvB = ctB = 0.f;
      if (p == 0) {
        cpvB = cvB / bvB;
        qvB = bvB;
        cptB = ctB / btB;
        qtB = btB;
      } else {
        const float dv = __fsub_rn(bvB, __fmul_rn(avB, cpvB));
        const float dt = __fsub_rn(btB, __fmul_rn(atB, cptB));
        if constexpr (kExact) {
          cpvB = cvB / dv;
          qvB = dv;
          cptB = ctB / dt;
          qtB = dt;
        } else {
          qvB = 1.0f / dv;
          cpvB = cvB * qvB;
          qtB = 1.0f / dt;
          cptB = ctB * qtB;
        }
      }
    }
    // T's forcing: the caller's, or t_phi * diss_axis(temp)
    float fT;
    if constexpr (kForce) {
      fT = cu.ex[0];
    } else {
      fT = diss_forcing(g.axis, m.axis_var, pv.t, nx.t, cu.ex, s);
    }
    const float gT = __fmul_rn(nx.t[tv] - pv.t[tv], s.inv2h);
    float* sc = sc0 + (long long)p * lines;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const bool is_t = v == tv;
      const float d = rhs_d(cu.cl, v, m.axis_var, is_t, cu.fv, cu.ft,
                            cu.t[v], cu.rh[v], gT, fT, s);
      const float q = is_t ? qt : qv;
      float dn;
      if (p == 0) {
        dn = d / q;
      } else {
        const float num = __fsub_rn(d, __fmul_rn(dp[v], is_t ? at : av));
        if constexpr (kExact)
          dn = num / q;
        else
          dn = num * q;
      }
      dp[v] = dn;
      sc[(2 + v) * sps] = dn;
      if constexpr (kDual) {
        const float qB = is_t ? qtB : qvB;
        float dnB;
        if (p == 0) {
          dnB = d / qB;
        } else {
          const float num =
              __fsub_rn(d, __fmul_rn(dpB[v], is_t ? atB : avB));
          if constexpr (kExact)
            dnB = num / qB;
          else
            dnB = num * qB;
        }
        dpB[v] = dnB;
        sc[(Tl::kNsA + 2 + v) * sps] = dnB;
      }
    }
    sc[0] = cpv;
    sc[sps] = cpt;
    if constexpr (kDual) {
      sc[Tl::kNsA * sps] = cpvB;
      sc[(Tl::kNsA + 1) * sps] = cptB;
    }
  };

  // S buffers: the copies of chunk k + S - 1 run while chunk k is walked
  Rw pv, cu, nx;
#pragma unroll
  for (int c = 0; c < S - 1; ++c) {
    if (c < nch) fetch_fwd(c);
    cp_async_commit();
  }
  for (int k = 0; k < nch; ++k) {
    if (k + S - 1 < nch) fetch_fwd(k + S - 1);
    cp_async_commit();
    cp_async_wait<S - 1>();
    __syncthreads();
    if (valid) {
      const int rows_v = min(R, n - k * R);
#pragma unroll 1
      for (int r = 0; r < rows_v; ++r) {
        read_fwd(k, r, nx);
        const int q = k * R + r;
        if (q == 0) {
          pv = nx;
          cu = nx;
          continue;
        }
        fwd_step(q - 1, pv, cu, nx);
        pv = cu;
        cu = nx;
      }
    }
    __syncthreads();
  }
  if (valid) fwd_step(n - 1, pv, cu, cu);
  // this thread's scratch stores before its copies of them below
  __threadfence_block();
  __syncthreads();

  // ---- backward buffers: chunk k in buffer b
  auto fetch_bwd = [&](int k, int b) {
    const unsigned st = sb + 4u * (b * Tl::kBwd);
    auto plane = [&](int i) { return st + 4u * (i * kPlane); };
    const int p0 = k * R, rows_v = chunk_rows(k);
    const bool full = is_full(k);
    const long long o0 = base0 + (long long)p0 * g.sp;
#pragma unroll
    for (int j = 0; j < Tl::kNs; ++j)
      scl.copy(plane(j), scratch + j * sps + p0 * lines + line0, full,
               rows_v, lines_v, NoShift());
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      fld.copy(plane(Tl::kNs + v), temp + v * g.fs + o0, full, rows_v,
               lines_v, NoShift());
      fld.copy(plane(Tl::kNs + NV + v), op + v * g.fs + o0, full, rows_v,
               lines_v, NoShift());
    }
    copy_mask<kZ, R, kW>(plane(Tl::kBwdPlanes), t, rows_v, lines_v,
                         mk[0] + (kZ ? p0 : (long long)p0 * g.sp), sp, s2);
    if constexpr (kDual)
      copy_mask<kZ, R, kW>(plane(Tl::kBwdPlanes) + 4u * Tl::kMask, t, rows_v,
                           lines_v, mf + (kZ ? p0 : (long long)p0 * g.sp),
                           sp, s2);
  };

  // ---- backward walk: substitution, UpdateSegment and the NODE_IN merge
  // (3D) or the 2D copy-then-merge.  X/Y write out and tn directly; Z puts
  // them into the row's d' and temp slots, which it has read.  With duals
  // both passes substitute, each on its own carry, and the update takes
  // pass B's value where the take bit is set (pallas_sweep_nl.py:519-535)
  float x[NV];
  float xB[NV];   // kDual: pass B's carries
  typename P::W* const out0 = out + base0 + t * g.s2;
  typename P::W* const tn0 = tn + base0 + t * g.s2;
  auto bwd_row = [&](int b, int k, int r) {
    float* st = smem + b * Tl::kBwd;
    const int i = r * kS + t, p = k * R + r;
    const float cpv_r = st[i], cpt_r = st[kPlane + i];
    const int seg = kZ ? t : r, idx = kZ ? r : t;
    const int cl = mask_at<kW>(
        reinterpret_cast<const unsigned*>(st + Tl::kBwdPlanes * kPlane), seg,
        idx, run_off(0, k * R, seg));
    bool take = false;
    float cpvB_r, cptB_r;
    if constexpr (kDual) {
      take = mask_at<kW>(reinterpret_cast<const unsigned*>(
                             st + Tl::kBwdPlanes * kPlane + Tl::kMask),
                         seg, idx, flag_off(k * R, seg)) & 2;
      cpvB_r = st[Tl::kNsA * kPlane + i];
      cptB_r = st[(Tl::kNsA + 1) * kPlane + i];
    }
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const float dpv = st[(2 + v) * kPlane + i];
      x[v] = p == n - 1 ? dpv
                        : __fsub_rn(dpv, __fmul_rn(v == tv ? cpt_r : cpv_r,
                                                   x[v]));
      float xs = x[v];
      if constexpr (kDual) {
        const float dpB = st[(Tl::kNsA + 2 + v) * kPlane + i];
        xB[v] = p == n - 1
                    ? dpB
                    : __fsub_rn(dpB, __fmul_rn(v == tv ? cptB_r : cpvB_r,
                                               xB[v]));
        if (take) xs = xB[v];
      }
      const float told = st[(Tl::kNs + v) * kPlane + i];
      float oprev;
      if constexpr (std::is_same<typename P::O, float>::value)
        oprev = st[(Tl::kNs + NV + v) * kPlane + i];
      else
        oprev = staged_bf16<!kZ, L, R>(
            st + (Tl::kNs + NV + v) * kPlane,
            bf16_half(op, (unsigned)(v * g.fs) + run_at(r)), r, t);
      float onew, tnew = told;
      if (two_d) {
        onew = cl == kInterior ? x[v] : oprev;
        if (cl == kInterior) tnew = m.first ? x[v] : (told + x[v]) * 0.5f;
      } else {
        onew = cl != 0 ? xs : oprev;
        if (cl == kInterior) {
          tnew = (told + onew) * 0.5f;
          // rounded apart: an FMA of the half and onew parts from the
          // plain version where the half is subnormal
          if (m.gmerge) tnew = __fmul_rn(__fadd_rn(tnew, onew), 0.5f);
        }
      }
      if constexpr (kZ) {
        st[(2 + v) * kPlane + i] = onew;
        st[(Tl::kNs + v) * kPlane + i] = tnew;
      } else {
        store_as(out0, v * g.fs + (long long)p * g.sp, onew);
        store_as(tn0, v * g.fs + (long long)p * g.sp, tnew);
      }
    }
  };

  // Z: out and tn of chunk k from buffer b, as the copies mapped it: L runs
  // of R contiguous floats
  auto store_tile = [&](int b, int k) {
    const float* st = smem + b * Tl::kBwd + fld.s0 / 4;
    const int rows_v = chunk_rows(k);
    const bool full = is_full(k);
    typename P::W* const o_out =
        out + base0 + (long long)k * R * g.sp + fld.g0;
    typename P::W* const o_tn = tn + (o_out - out);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (full || (fld.row(j) < rows_v && fld.line(j) < lines_v)) {
        const int i = j * fld.kStep, o = j * fld.gs;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          store_as(o_out, v * g.fs + o, st[(2 + v) * kPlane + i]);
          store_as(o_tn, v * g.fs + o, st[(Tl::kNs + v) * kPlane + i]);
        }
      }
    }
  };

  // the walk runs from the last chunk down: the kk-th in buffer kk % S
#pragma unroll
  for (int c = 0; c < S - 1; ++c) {
    if (c < nch) fetch_bwd(nch - 1 - c, c);
    cp_async_commit();
  }
  for (int kk = 0; kk < nch; ++kk) {
    const int k = nch - 1 - kk, b = kk % S;
    if (kk + S - 1 < nch) fetch_bwd(k - (S - 1), (kk + S - 1) % S);
    cp_async_commit();
    cp_async_wait<S - 1>();
    __syncthreads();
    if (valid) {
#pragma unroll 1
      for (int r = min(R, n - k * R) - 1; r >= 0; --r) bwd_row(b, k, r);
    }
    if constexpr (kZ) {
      __syncthreads();
      store_tile(b, k);
    }
    __syncthreads();
  }
}

template <class P>
struct Ptrs {
  const float* temp;
  const int8_t *cls, *bcv, *bct;
  const typename P::R* rhs;
  const typename P::O* op;
  const float* forcing;
  const int8_t* flags;
  typename P::W *out, *tn;
  float* scratch;
};

template <class P, int NV, bool kForce, bool kZ, bool kExact, int L, int R,
          int S, bool kDual = false>
int launch_tiles(const Ptrs<P>& a, const Geo& g, const Mode& m,
                 const Scal& s, cudaStream_t stream) {
  using Tl = Tile<NV, kForce, kZ, L, R, S, kDual>;
  const int bytes = Tl::kWords * 4;
  auto kernel =
      pair_sweep_iter_kernel<NV, kForce, kZ, kExact, L, R, S, kDual, P>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((g.n2 + L - 1) / L, g.n1);
  kernel<<<grid, L, bytes, stream>>>(a.temp, a.cls, a.bcv, a.bct, a.rhs, a.op,
                                     a.forcing, a.out, a.tn, a.scratch, g, m,
                                     s, a.flags);
  return (int)cudaGetLastError();
}

template <class P, int NV, bool kForce, bool kZ, int L, int R, int S,
          bool kDual = false>
int launch_exact(const Ptrs<P>& a, const Geo& g, const Mode& m,
                 const Scal& s, cudaStream_t st) {
  return m.exact
             ? launch_tiles<P, NV, kForce, kZ, true, L, R, S, kDual>(a, g, m,
                                                                     s, st)
             : launch_tiles<P, NV, kForce, kZ, false, L, R, S, kDual>(
                   a, g, m, s, st);
}

// Z (axis 2) is the contiguous axis: the rows-fast tiles, in 3D their own
// shape; the 3D pair mode with duals (flags) has its own instantiations
template <class P, int NV, bool kForce>
int launch_mode(const Ptrs<P>& a, const Geo& g, const Mode& m, const Scal& s,
                cudaStream_t st) {
  if constexpr (NV == 3) {
    return g.axis == 2
               ? launch_exact<P, 3, kForce, true, k2dL, k2dR, k2dS>(a, g, m,
                                                                    s, st)
               : launch_exact<P, 3, kForce, false, k2dL, k2dR, k2dS>(a, g, m,
                                                                     s, st);
  } else {
    if constexpr (!kForce) {
      if (a.flags)
        return g.axis == 2
                   ? launch_exact<P, NV, false, true, kZdL, kZdR, kZdS,
                                  true>(a, g, m, s, st)
                   : launch_exact<P, NV, false, false, kXyL, kXyR, kXyS,
                                  true>(a, g, m, s, st);
    }
    return g.axis == 2
               ? launch_exact<P, NV, kForce, true, kZL, kZR, kZS>(a, g, m, s,
                                                                  st)
               : launch_exact<P, NV, kForce, false, kXyL, kXyR, kXyS>(a, g, m,
                                                                      s, st);
  }
}

// Launch one iteration on the lines of ``axis``: the pair mode (no
// forcing) only with kPair, the stream mode (forcing) only with kStream,
// so that an entry instantiates only the modes it serves.
template <class P, bool kPair, bool kStream>
int launch(const Ptrs<P>& a, int nx, int ny, int nz, int axis,
           const Mode& m, const Scal& s, void* stream) {
  const long long sx = (long long)ny * nz, sy = nz, sz = 1;
  Geo g;
  g.axis = axis;
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
  // a chunk's offsets are 32-bit: up to 32 rows of sp and a line count
  if (g.n < 1 || g.n1 < 1 || g.n2 < 1 || g.n1 > 65535 || m.nvars < 3 ||
      m.nvars > 4 || m.axis_var < 0 || m.axis_var >= m.nvars - 1 ||
      g.sp * 32 > 0x7fffffffLL || (long long)g.n1 * g.n2 > 0x7fffffffLL / 32)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (!a.forcing) {                                 // the pair mode: 3D
    if constexpr (kPair) {
      if (m.nvars == 4) return launch_mode<P, 4, false>(a, g, m, s, st);
    }
    return (int)cudaErrorInvalidValue;
  }
  if constexpr (kStream) {
    return m.nvars == 4 ? launch_mode<P, 4, true>(a, g, m, s, st)
                        : launch_mode<P, 3, true>(a, g, m, s, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
