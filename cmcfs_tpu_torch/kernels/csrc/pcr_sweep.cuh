// One local ADI iteration of one 3D sweep direction, u, v, w and T, solved
// by parallel cyclic reduction (PCR), for sm_90a.  The PCR pair sweep is two
// launches of it.  The kernel and its host dispatch; the entry points are
// pcr_sweep.cu's (float32 payloads) and pcr_sweep_bf16.cu's (bf16).
//
// Replaces: the pcr mode of cmcfs_tpu/ops/pallas_sweep_nl.py::fused_sweep_nl
//   (_shift0, _pcr_chain, pcr_solve_all, pallas_sweep_nl.py:538-660, and
//   the ``if pcr:`` branches of its body, :758-1012), which backend
//   ``fused_pcr`` runs on every pair direction under the default xmode
//   layout.  Per iteration it builds the pair kernel's rows, right-hand
//   sides and in-kernel dissipation (rows.cuh, rhs.cuh: pair_sweep.cu's
//   own code), reduces the velocities' shared (a, b, c) chain carrying u, v
//   and w, then T's chain, and writes UpdateSegment, the NODE_IN merge and
//   the gmerge fold.  With the dual plane (kDual) it also reduces pass B's
//   chains, whose rows differ only where a dual cell takes the BC0 start
//   role, on the same d's, and takes pass B's solution where the take bit
//   is set (pcr_solve_all's dual form, :598-660).  Every product is rounded
//   before it is added (__fmul_rn / __fadd_rn / __fdiv_rn / __frcp_rn), in
//   the order of ops/pcr.py, so the kernel equals its plain version
//   (ops/pcr_sweep.pcr_sweep_ref) bit for bit.
// The bf16 payload mode (fused_sweep_nl's bf16 storage under pcr, backend
//   fused_pcr_bf16): rhs and out_prev read as bf16 and upcast where the
//   build and the update read them, out and tn stored as bf16 rounded to
//   nearest even; a pair's first launch writes float32 out1 and tn1 and
//   its second reads out1 as float32 (tile.cuh's payload types PayIn,
//   PayOut).  Everything else stays float32.
//
// What bounds it on this card: device-memory traffic (83 B a cell a pair
//   compulsory, as the Thomas pair; a launch moves 99: temp, rhs and the
//   masks to build, temp and out_prev again to update, out and tn; 100 with
//   the dual plane) against log2(n) levels of about 32 operations a cell
//   (three times Thomas's count, 8 levels at n = 256), whose divisions
//   (IEEE __fdiv_rn, or one __frcp_rn a cell and level) are most of the
//   instructions.  A level needs each cell's +-s neighbours of the level
//   before: where they travel, and how often the block waits for them, is
//   what the design decides.
//
// What the design does about it: one warp owns one line (n <= 256, the
//   pair path's line cap) and keeps its chains in registers.  Lane q holds
//   cells p = q + 32 j, j < kJ = 8: the (a, b, c) row and the K d's of the
//   chain.  At a level s < 32 a cell's neighbours come from lanes q -+ s by
//   __shfl_sync, of cell j or, where the lane index wraps, j -+ 1; at s =
//   32, 64, 128 they are the lane's own cells j -+ s/32.  Every level reads
//   the old values before it writes a cell (ops/pcr.py computes each level
//   new from old): the shuffle levels update cell j once the shuffles of
//   cells j and j + 1 are taken, the register levels from a copy that the
//   compiler renames away.  The reciprocal form shuffles 1/b, not b, so a
//   cell's reciprocal is taken once a level, not twice.  No barrier inside
//   a chain.  Shared memory is only the transpose between the coalesced
//   build and update and the warps' columns: a block of kL = 8 lines (8
//   warps) builds each cell's class code, adv/(2h) and the d's of u, v, w
//   and T into [row][line] planes with an odd row stride (kS = 9), so a
//   warp's column read hits 32 banks; each warp reads its column once a
//   chain, rebuilds the rows from the code in registers (T's and pass B's
//   too) and writes x back once.  On X and Y the build and update threads
//   run along the lines (the contiguous cross axis: 32-byte runs), with a
//   barrier before and after the chains; on Z they run along the rows,
//   which is the warps' own column, so the Z instantiations have no barrier
//   at all.  Pass B (kDual) keeps pass A's x in three more planes and
//   restores nothing: the d's stay in their planes until both passes have
//   read them.  Pass B doubles the chains' work and their code; fully
//   unrolled, the dual kernel took well over twice the dual-free one's
//   time (PERF.md, Findings): its instructions, not its data, missed the
//   caches.  So the dual instantiations take a compact form (kCompact):
//   the build and update loop over a thread's cells, and the levels s >=
//   32 share one loop body (level_reg_any), at about two thirds of the
//   code.  Shared memory: 6
//   planes of n x 9 floats (54 KB at n = 256), 9 with duals.  At most 128
//   registers a thread (two blocks, 16 warps an SM).
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "rhs.cuh"
#include "rows.cuh"
#include "tile.cuh"

namespace {

constexpr int kFree = 1;            // core/types.py BCtype.FREE
constexpr int kL = 8;               // lines a block, one warp each
constexpr int kThreads = 32 * kL;   // threads a block
constexpr int kMinBlocks = 2;       // blocks an SM the registers allow
constexpr int kMaxN = 256;          // the longest line
constexpr int kJ = kMaxN / 32;      // cells a lane: rows lane + 32 j
constexpr int kS = kL + 1;          // a shared row's stride (odd)
constexpr unsigned kAll = 0xffffffffu;

// shared planes: the class code (class | FREE velocity << 2 | FREE T << 3
// | flags << 4, as int), adv/(2h), the d's of u, v, w, T (x once solved);
// with duals pass A's x of a chain
constexpr int kCode = 0, kAdv = 1, kD = 2, kXa = 6;
constexpr int kPlanes = 6, kPlanesDual = 9;

// The lines of one launch: line (i1, i2) starts at i1*s1 + i2*s2, its rows
// p = 0..n-1 lie sp apart; variables lie fs apart (as pair_sweep.cu's).
struct Geo {
  int n, n1, n2, axis;
  long long sp, s1, s2, fs;
};

// A lane's cells of a chain: the rows and the K right-hand sides.
template <int K>
struct Chain {
  static constexpr int kK = K;
  float a[kJ], b[kJ], c[kJ], d[K][kJ];
};

// What a cell takes from a neighbour at one level: a, what alpha or gamma
// divides by (b exact, else 1/b multiplies), c and the d's.
template <int K>
struct Nb {
  float a, q, c, d[K];
};

// The identity row past a line's ends (ops/pcr.shift's fill).
template <int K>
__device__ __forceinline__ Nb<K> fill() {
  Nb<K> f;
  f.a = 0.f;
  f.q = 1.f;      // b = 1, and 1/1 = 1
  f.c = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) f.d[k] = 0.f;
  return f;
}

// Cell j of this lane, whose divisor is q.
template <int K>
__device__ __forceinline__ Nb<K> own(const Chain<K>& x, float q, int j) {
  Nb<K> v;
  v.a = x.a[j];
  v.q = q;
  v.c = x.c[j];
#pragma unroll
  for (int k = 0; k < K; ++k) v.d[k] = x.d[k][j];
  return v;
}

// What lane ``src`` gives: its cell j1 (divisor q1) where ``take1`` holds
// there, else its cell j0 (q0); every lane of the warp takes part.
template <int K>
__device__ __forceinline__ Nb<K> shfl(const Chain<K>& x, bool take1, int j1,
                                      float q1, int j0, float q0, int src) {
  Nb<K> v;
  v.a = __shfl_sync(kAll, take1 ? x.a[j1] : x.a[j0], src);
  v.q = __shfl_sync(kAll, take1 ? q1 : q0, src);
  v.c = __shfl_sync(kAll, take1 ? x.c[j1] : x.c[j0], src);
#pragma unroll
  for (int k = 0; k < K; ++k)
    v.d[k] = __shfl_sync(kAll, take1 ? x.d[k][j1] : x.d[k][j0], src);
  return v;
}

// One level at cell j from its neighbours s below (lo) and above (hi), in
// ops/pcr.pcr_solve's order:
//   alpha = -(a / b[i-s])  or  -a * (1 / b[i-s]);  gamma likewise with c
//   b' = (b + alpha c[i-s]) + gamma a[i+s];  d' = (d + alpha d[i-s]) +
//   gamma d[i+s];  a' = alpha a[i-s];  c' = gamma c[i+s]
// (a' and c' are dead after the last level: kLast skips them).
template <int K, bool kExact, bool kLast = false>
__device__ __forceinline__ void level_cell(Chain<K>& x, int j,
                                           const Nb<K>& lo, const Nb<K>& hi) {
  float alpha, gamma;
  if constexpr (kExact) {
    alpha = -__fdiv_rn(x.a[j], lo.q);
    gamma = -__fdiv_rn(x.c[j], hi.q);
  } else {
    alpha = __fmul_rn(-x.a[j], lo.q);
    gamma = __fmul_rn(-x.c[j], hi.q);
  }
  x.b[j] = __fadd_rn(__fadd_rn(x.b[j], __fmul_rn(alpha, lo.c)),
                     __fmul_rn(gamma, hi.a));
#pragma unroll
  for (int k = 0; k < K; ++k)
    x.d[k][j] = __fadd_rn(__fadd_rn(x.d[k][j], __fmul_rn(alpha, lo.d[k])),
                          __fmul_rn(gamma, hi.d[k]));
  if constexpr (!kLast) {
    x.a[j] = __fmul_rn(alpha, lo.a);
    x.c[j] = __fmul_rn(gamma, hi.c);
  }
}

// The divisor of a cell at a level: b, or its reciprocal.
template <bool kExact>
__device__ __forceinline__ float divisor(float b) {
  return kExact ? b : __frcp_rn(b);
}

// A level s < 32: the cell s below lane q's cell j is cell j of lane q - s,
// or cell j - 1 of lane q - s + 32 where q < s; above, cell j of lane q + s
// or cell j + 1 of lane q + s - 32.  A lane gives the cell its reader
// needs (its reader below wraps where lane + s >= 32, above where lane <
// s), so one shuffle a value brings each neighbour.  Step j takes cell j's
// neighbour above and cell j + 1's below while cells j and j + 1 still
// hold the old values, then writes cell j; each cell's divisor is taken
// once, a step ahead.
template <int K, bool kExact>
__device__ __forceinline__ void level_shfl(Chain<K>& x, int s, int lane,
                                           int n) {
  const int lo_src = (lane - s) & 31, hi_src = (lane + s) & 31;
  const bool give_lo = lane + s >= 32, give_hi = lane < s;
  float q0 = divisor<kExact>(x.b[0]);
  // cell 0's neighbour below: out of range wherever the shuffle wraps
  Nb<K> lo_cur = shfl(x, false, 0, q0, 0, q0, lo_src);
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    constexpr int kLastJ = kJ - 1;
    const int j1 = j < kLastJ ? j + 1 : j;
    const float q1 = j < kLastJ ? divisor<kExact>(x.b[j1]) : q0;
    const Nb<K> hi = shfl(x, give_hi, j1, q1, j, q0, hi_src);
    const Nb<K> lo_next = shfl(x, !give_lo, j1, q1, j, q0, lo_src);
    const int p = lane + 32 * j;
    level_cell<K, kExact>(x, j, p < s ? fill<K>() : lo_cur,
                          p + s >= n ? fill<K>() : hi);
    lo_cur = lo_next;
    q0 = q1;
  }
}

// A level s = 32 M: the neighbours are this lane's cells j -+ M, read from
// the level's old values.  s = 128 is the last level of any line (n <=
// 256).
template <int M, int K, bool kExact>
__device__ __forceinline__ void level_reg(Chain<K>& x, int lane, int n) {
  float q[kJ];
#pragma unroll
  for (int j = 0; j < kJ; ++j) q[j] = divisor<kExact>(x.b[j]);
  const Chain<K> o = x;
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const int p = lane + 32 * j;
    const int jl = j >= M ? j - M : 0, jh = j + M < kJ ? j + M : j;
    const Nb<K> lo = j >= M ? own(o, q[jl], jl) : fill<K>();
    const Nb<K> hi =
        j + M < kJ && p + 32 * M < n ? own(o, q[jh], jh) : fill<K>();
    level_cell<K, kExact, 32 * M * 2 >= kMaxN>(x, j, lo, hi);
  }
}

// The levels s = 32 m, m = 1, 2, 4 at run time, in one loop body: the
// compact form of level_reg (kCompact).
template <int K, bool kExact>
__device__ __forceinline__ void level_reg_any(Chain<K>& x, int m, int lane,
                                              int n) {
  float q[kJ];
#pragma unroll
  for (int j = 0; j < kJ; ++j) q[j] = divisor<kExact>(x.b[j]);
  const Chain<K> o = x;
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const int p = lane + 32 * j;
    Nb<K> lo = fill<K>(), hi = fill<K>();
#pragma unroll
    for (int mm = 1; mm < kJ; mm *= 2) {
      const int jl = j >= mm ? j - mm : 0, jh = j + mm < kJ ? j + mm : j;
      if (m == mm && j >= mm) lo = own(o, q[jl], jl);
      if (m == mm && j + mm < kJ) hi = own(o, q[jh], jh);
    }
    level_cell<K, kExact>(x, j, lo, p + 32 * m < n ? hi : fill<K>());
  }
}

// Reduce a lane's chain (levels s = 1, 2, 4, ... while s < n) and leave x
// in its d's: x = d / b (exact) or d * (1 / b).  Every level runs all kJ
// cells of a lane, branch-free: cells past the line's end are identity
// rows that stay finite, and no cell of the line reads one (a neighbour
// past the end is filled).
template <int K, bool kExact, bool kCompact>
__device__ __forceinline__ void reduce(Chain<K>& x, int lane, int n) {
  for (int s = 1; s < n && s < 32; s *= 2)
    level_shfl<K, kExact>(x, s, lane, n);
  if constexpr (kCompact) {
#pragma unroll 1
    for (int m = 1; m < kJ && 32 * m < n; m *= 2)
      level_reg_any<K, kExact>(x, m, lane, n);
  } else {
    if (n > 32) level_reg<1, K, kExact>(x, lane, n);
    if (n > 64) level_reg<2, K, kExact>(x, lane, n);
    if (n > 128) level_reg<4, K, kExact>(x, lane, n);
  }
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    if constexpr (kExact) {
#pragma unroll
      for (int k = 0; k < K; ++k) x.d[k][j] = __fdiv_rn(x.d[k][j], x.b[j]);
    } else {
      const float r = __frcp_rn(x.b[j]);
#pragma unroll
      for (int k = 0; k < K; ++k) x.d[k][j] = __fmul_rn(x.d[k][j], r);
    }
  }
}

template <bool kZ, bool kExact, bool kDual, class P>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
pcr_sweep_iter_kernel(const float* __restrict__ temp,
                      const int8_t* __restrict__ cls,
                      const int8_t* __restrict__ bcv,
                      const int8_t* __restrict__ bct,
                      const typename P::R* __restrict__ rhs,
                      const typename P::O* __restrict__ op,
                      const int8_t* __restrict__ flags,
                      typename P::W* __restrict__ out,
                      typename P::W* __restrict__ tn, Geo g, int gmerge,
                      Scal s) {
  extern __shared__ float sm[];
  const int t = threadIdx.x, lane = t & 31, wl = t >> 5;   // warp wl: line wl
  const int n = g.n, plane = n * kS;
  const int i1 = blockIdx.y, i20 = blockIdx.x * kL;
  const int lines_v = min(kL, g.n2 - i20);
  const long long base0 = i1 * g.s1 + i20 * g.s2;
  const int ax = g.axis;
  const float b_int_v = s.inv3dt + 2.0f * s.v_vis_h2;
  const float b_int_t = s.inv3dt + 2.0f * s.t_vis_h2;
  int* const code_pl = reinterpret_cast<int*>(sm + kCode * plane);

  // the build's and the update's cells: line l, rows p0 + 32 j below n.
  // X and Y: the threads run along the lines, so a warp's cells of a row
  // are one coalesced run; Z: along the rows, the warp's own column.
  // Lines past the grid's edge are identity rows.
  const int p0 = kZ ? lane : t / kL, l = kZ ? wl : t % kL;
  auto row = [&](int j) { return p0 + 32 * j; };
  auto sidx = [&](int j) { return row(j) * kS + l; };
  auto gidx = [&](int j) { return base0 + row(j) * g.sp + l * g.s2; };

  // ---- build: the class code, adv/(2h) and the d's of u, v, w, T
#pragma unroll (kDual ? 1 : kJ)
  for (int j = 0; j < kJ; ++j) {
    const int i = sidx(j), p = row(j);
    if (p >= n) break;
    int cd = 0;
    float a2 = 0.f, d[4] = {0.f, 0.f, 0.f, 0.f};
    if (l < lines_v) {
      const long long o = gidx(j);
      const int cl = cls[o];
      const bool fv = bcv[o] == kFree, ft = bct[o] == kFree;
      const int fl = kDual ? flags[o] : 0;
      const long long pm = p > 0 ? -g.sp : 0, pn = p < n - 1 ? g.sp : 0;
      // temp here and at the previous and next cells of the line (this
      // cell at the line's ends), rhs; adv across the line (this line at
      // the grid's faces)
      float tc[4], tp[4], tx[4], rh[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float* f = temp + v * g.fs + o;
        tc[v] = f[0];
        tp[v] = f[pm];
        tx[v] = f[pn];
        rh[v] = to_f32(rhs[v * g.fs + o]);
      }
      const float* adv = temp + ax * g.fs + o;
      const int i2 = i20 + l;
      const float ex[4] = {adv[i1 > 0 ? -g.s1 : 0],
                           adv[i1 < g.n1 - 1 ? g.s1 : 0],
                           adv[i2 > 0 ? -g.s2 : 0],
                           adv[i2 < g.n2 - 1 ? g.s2 : 0]};
      const float fT = diss_forcing(ax, ax, tp, tx, ex, s);
      const float gT = __fmul_rn(tx[3] - tp[3], s.inv2h);
      a2 = __fmul_rn(pick(tc, ax), s.inv2h);
#pragma unroll
      for (int v = 0; v < 4; ++v)
        d[v] = rhs_d(cl, v, ax, v == 3, fv, ft, tc[v], rh[v], gT, fT, s);
      cd = cl | (fv << 2) | (ft << 3) | (fl << 4);
    }
    code_pl[i] = cd;
    sm[kAdv * plane + i] = a2;
#pragma unroll
    for (int v = 0; v < 4; ++v) sm[(kD + v) * plane + i] = d[v];
  }
  if constexpr (!kZ) __syncthreads();

  // ---- the chains: warp wl reduces its line's, lane cells lane + 32 j
  if (wl < lines_v) {
    auto cidx = [&](int j) { return (lane + 32 * j) * kS + wl; };
    // the rows of T's (tv) or the velocities' chain, pass A or B (on pass
    // B a dual cell takes the BC0 start role), capped; the K d's from
    // plane d0 on
    auto load = [&](auto& x, bool tv, bool pass_b, int d0) {
      constexpr int K = std::remove_reference_t<decltype(x)>::kK;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int p = lane + 32 * j;
        float a = 0.f, b = 1.f, c = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) x.d[k][j] = 0.f;
        if (p < n) {
          const int i = cidx(j), cd = code_pl[i];
          int cl = cd & 3;
          if (pass_b && (cd & 16)) cl = kBC0;
          build_abc(cl, (cd >> (tv ? 3 : 2)) & 1, false, sm[kAdv * plane + i],
                    tv ? s.t_vis_h2 : s.v_vis_h2, tv ? b_int_t : b_int_v, a,
                    b, c);
          if (p == 0) a = 0.f;
          if (p == n - 1) c = 0.f;
#pragma unroll
          for (int k = 0; k < K; ++k) x.d[k][j] = sm[(d0 + k) * plane + i];
        }
        x.a[j] = a;
        x.b[j] = b;
        x.c[j] = c;
      }
    };
    auto store = [&](const auto& x, int d0) {
      constexpr int K = std::remove_reference_t<decltype(x)>::kK;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        if (lane + 32 * j >= n) continue;
#pragma unroll
        for (int k = 0; k < K; ++k) sm[(d0 + k) * plane + cidx(j)] = x.d[k][j];
      }
    };
    // pass B where the take bit is set, else pass A's x (kXa planes)
    auto stitch = [&](auto& x) {
      constexpr int K = std::remove_reference_t<decltype(x)>::kK;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        if (lane + 32 * j >= n || (code_pl[cidx(j)] & 32)) continue;
#pragma unroll
        for (int k = 0; k < K; ++k) x.d[k][j] = sm[(kXa + k) * plane + cidx(j)];
      }
    };
    {
      Chain<3> x;
      load(x, false, false, kD);
      reduce<3, kExact, kDual>(x, lane, n);
      if constexpr (kDual) {
        store(x, kXa);
        load(x, false, true, kD);
        reduce<3, kExact, kDual>(x, lane, n);
        stitch(x);
      }
      store(x, kD);
    }
    {
      Chain<1> x;
      load(x, true, false, kD + 3);
      reduce<1, kExact, kDual>(x, lane, n);
      if constexpr (kDual) {
        store(x, kXa);
        load(x, true, true, kD + 3);
        reduce<1, kExact, kDual>(x, lane, n);
        stitch(x);
      }
      store(x, kD + 3);
    }
  }
  if constexpr (!kZ) __syncthreads();

  // ---- UpdateSegment, the NODE_IN merge and the gmerge fold
#pragma unroll (kDual ? 1 : kJ)
  for (int j = 0; j < kJ; ++j) {
    if (row(j) >= n) break;
    if (l >= lines_v) continue;
    const long long o = gidx(j);
    const int i = sidx(j), cl = code_pl[i] & 3;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const float x = sm[(kD + v) * plane + i];
      const float told = temp[v * g.fs + o];
      const float onew = cl != 0 ? x : to_f32(op[v * g.fs + o]);
      float tnew = told;
      if (cl == kInterior) {
        tnew = (told + onew) * 0.5f;
        // rounded apart: an FMA of the half and onew parts from the
        // plain version where the half is subnormal
        if (gmerge) tnew = __fmul_rn(__fadd_rn(tnew, onew), 0.5f);
      }
      store_as(out, v * g.fs + o, onew);
      store_as(tn, v * g.fs + o, tnew);
    }
  }
}

// The operands of one launch.
template <class P>
struct Ptrs {
  const float* temp;
  const int8_t *cls, *bcv, *bct;
  const typename P::R* rhs;
  const typename P::O* op;
  const int8_t* flags;
  typename P::W *out, *tn;
};

// Dynamic shared memory of a launch on lines of n cells.
inline int smem_bytes(int n, bool dual) {
  return (dual ? kPlanesDual : kPlanes) * n * kS * 4;
}

// The instantiation's kernel with its dynamic shared memory opted into.
template <bool kZ, bool kExact, bool kDual, class P>
auto kernel_for(int bytes, cudaError_t* e) {
  auto kernel = pcr_sweep_iter_kernel<kZ, kExact, kDual, P>;
  *e = bytes > 48 * 1024
           ? cudaFuncSetAttribute(
                 kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
           : cudaSuccess;
  return kernel;
}

// f(kZ, kExact, kDual) as std::bool_constant arguments, for the run-time
// modes.
template <class F>
int dispatch(bool z, bool exact, bool dual, F&& f) {
  using T = std::true_type;
  using N = std::false_type;
  if (z) {
    if (exact) return dual ? f(T{}, T{}, T{}) : f(T{}, T{}, N{});
    return dual ? f(T{}, N{}, T{}) : f(T{}, N{}, N{});
  }
  if (exact) return dual ? f(N{}, T{}, T{}) : f(N{}, T{}, N{});
  return dual ? f(N{}, N{}, T{}) : f(N{}, N{}, N{});
}

// One launch on the lines of ``axis`` (at most kMaxN cells).
template <class P>
int launch(const Ptrs<P>& a, int nx, int ny, int nz, int axis, int exact,
           int gmerge, const Scal& s, void* stream) {
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
  if (g.n < 1 || g.n > kMaxN || g.n1 < 1 || g.n2 < 1 || g.n1 > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return dispatch(axis == 2, exact, a.flags != nullptr,
                  [&](auto z, auto ex, auto du) {
    const int bytes = smem_bytes(g.n, du);
    cudaError_t e;
    auto kernel = kernel_for<decltype(z)::value, decltype(ex)::value,
                             decltype(du)::value, P>(bytes, &e);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((g.n2 + kL - 1) / kL, g.n1);
    kernel<<<grid, kThreads, bytes, st>>>(a.temp, a.cls, a.bcv, a.bct,
                                              a.rhs, a.op, a.flags, a.out,
                                              a.tn, g, gmerge, s);
    return (int)cudaGetLastError();
  });
}

// The instantiation of (axis, exact, dual) on lines of n cells: out[0] its
// registers a thread, out[1] its local memory a thread in bytes (0: no
// spills), out[2] its blocks an SM, out[3] its dynamic shared memory in
// bytes.  Returns a CUDA error code.
template <class P>
int kernel_info(int n, int axis, int exact, int dual, int* out) {
  if (n < 1 || n > kMaxN || axis < 0 || axis > 2)
    return (int)cudaErrorInvalidValue;
  return dispatch(axis == 2, exact, dual, [&](auto z, auto ex, auto du) {
    const int bytes = smem_bytes(n, du);
    cudaError_t e;
    auto kernel = kernel_for<decltype(z)::value, decltype(ex)::value,
                             decltype(du)::value, P>(bytes, &e);
    cudaFuncAttributes fa;
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
    int blocks = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        kThreads, bytes);
    if (e != cudaSuccess) return (int)e;
    out[0] = fa.numRegs;
    out[1] = (int)fa.localSizeBytes;
    out[2] = blocks;
    out[3] = bytes;
    return 0;
  });
}

}  // namespace
