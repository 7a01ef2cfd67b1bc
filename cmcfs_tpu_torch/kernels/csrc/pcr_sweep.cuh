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
// What bounds it on this card: device-memory traffic in principle (83 B a
//   cell a pair compulsory, as the Thomas pair; a launch moves 99: temp,
//   rhs and the masks to build, temp and out_prev again to update, out
//   and tn; 100 with the dual plane), but PCR does log2(n)
//   levels of about 32 operations a cell (three times Thomas's count) and
//   moves each level's rows through shared memory twice, so at n = 256 the
//   shared-memory traffic and the synchronisations of the levels, not
//   device memory, are what a launch waits on.
//
// What the design does about it, simply: a block of kL = 8 neighbouring
//   lines holds its whole lines in shared memory, laid out [row][line]
//   (n <= 256 rows: the pair path's line cap); 512 threads own the block's
//   cells, up to 4 each, at most 128 registers a thread and no spills (a
//   256-thread block took 165-200 registers, one block an SM, and ran Z
//   1.7x slower: PERF.md).  On X and Y the threads run along the lines
//   (the contiguous cross axis), on Z along the rows (the line is
//   contiguous), so every global access of a block is a coalesced run; the
//   Z tile's rows are padded to 9 floats so that a warp's cells of one line
//   hit distinct banks.  The build phase reads each cell's inputs straight
//   from device memory (the +-1 neighbours along and across the line from
//   cache) and writes the velocity rows and the four d's; each PCR level
//   reads a cell and its +-s neighbours, synchronises, writes, and
//   synchronises; T's rows and pass B's are rebuilt from the classes kept
//   in registers.
//   Shared memory: 7 planes of n x 9 floats (64.5 KB at n = 256), 14 with
//   duals (the saved d's and pass A's solution of a chain).  Making it fast
//   (more lines a block, levels in registers and warp shuffles) is later
//   work.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "rhs.cuh"
#include "rows.cuh"
#include "tile.cuh"

namespace {

constexpr int kFree = 1;            // core/types.py BCtype.FREE
constexpr int kL = 8;               // lines a block
constexpr int kThreads = 512;       // threads a block
constexpr int kMaxN = 256;          // the longest line
constexpr int kRows = kThreads / kL;         // rows a pass of the threads
constexpr int kE = kMaxN / kRows;            // cells a thread, at most

// shared planes: the chain's rows, the d's of u, v, w, T; with duals the
// saved d's and pass A's solution of a chain
constexpr int kA = 0, kB = 1, kC = 2, kD = 3, kSave = 7, kXa = 11;
constexpr int kPlanes = 7, kPlanesDual = 14;

// The lines of one launch: line (i1, i2) starts at i1*s1 + i2*s2, its rows
// p = 0..n-1 lie sp apart; variables lie fs apart (as pair_sweep.cu's).
struct Geo {
  int n, n1, n2, axis;
  long long sp, s1, s2, fs;
};

// Reduce the chain in planes kA, kB, kC carrying the K d planes from d0,
// and leave x in the d planes (ops/pcr.pcr_solve).  Cell j of this thread
// is row p0 + j kRows of its line, at shared index si0 + j kRows kS; the
// cells of rows below n exist.
template <int K, bool kExact>
__device__ __forceinline__ void pcr_chain(float* sm, int plane, int kS, int n,
                                          int p0, int si0, int d0) {
  float* const A = sm + kA * plane;
  float* const B = sm + kB * plane;
  float* const C = sm + kC * plane;
  float* D[K];
#pragma unroll
  for (int k = 0; k < K; ++k) D[k] = sm + (d0 + k) * plane;
  __syncthreads();
  for (int s = 1; s < n; s *= 2) {
    const bool last = 2 * s >= n;
    float na[kE], nb[kE], nc[kE], nd[kE][K];
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      const int p = p0 + j * kRows, i = si0 + j * kRows * kS;
      if (p >= n) continue;
      const bool lo = p >= s, hi = p + s < n;
      const int im = i - s * kS, ip = i + s * kS;
      const float a = A[i], b = B[i], c = C[i];
      const float am = lo ? A[im] : 0.f, bm = lo ? B[im] : 1.f;
      const float cm = lo ? C[im] : 0.f;
      const float ap = hi ? A[ip] : 0.f, bp = hi ? B[ip] : 1.f;
      const float cp = hi ? C[ip] : 0.f;
      float alpha, gamma;
      if constexpr (kExact) {
        alpha = -__fdiv_rn(a, bm);
        gamma = -__fdiv_rn(c, bp);
      } else {
        alpha = __fmul_rn(-a, __frcp_rn(bm));
        gamma = __fmul_rn(-c, __frcp_rn(bp));
      }
      nb[j] = __fadd_rn(__fadd_rn(b, __fmul_rn(alpha, cm)),
                        __fmul_rn(gamma, ap));
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float dm = lo ? D[k][im] : 0.f, dp = hi ? D[k][ip] : 0.f;
        nd[j][k] = __fadd_rn(__fadd_rn(D[k][i], __fmul_rn(alpha, dm)),
                             __fmul_rn(gamma, dp));
      }
      na[j] = __fmul_rn(alpha, am);
      nc[j] = __fmul_rn(gamma, cp);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      if (p0 + j * kRows >= n) continue;
      const int i = si0 + j * kRows * kS;
      B[i] = nb[j];
#pragma unroll
      for (int k = 0; k < K; ++k) D[k][i] = nd[j][k];
      if (!last) {     // after the last level a and c are dead
        A[i] = na[j];
        C[i] = nc[j];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kE; ++j) {
    if (p0 + j * kRows >= n) continue;
    const int i = si0 + j * kRows * kS;
    const float b = B[i];
    if constexpr (kExact) {
#pragma unroll
      for (int k = 0; k < K; ++k) D[k][i] = __fdiv_rn(D[k][i], b);
    } else {
      const float r = __frcp_rn(b);
#pragma unroll
      for (int k = 0; k < K; ++k) D[k][i] = __fmul_rn(D[k][i], r);
    }
  }
  __syncthreads();
}

template <bool kZ, bool kExact, bool kDual, class P>
__global__ void __launch_bounds__(kThreads, 1)
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
  constexpr int kS = kZ ? kL + 1 : kL;   // a shared row's stride
  extern __shared__ float sm[];
  const int t = threadIdx.x;
  const int n = g.n, plane = n * kS;
  const int i1 = blockIdx.y, i20 = blockIdx.x * kL;
  const int lines_v = min(kL, g.n2 - i20);
  const long long base0 = i1 * g.s1 + i20 * g.s2;
  const int ax = g.axis;
  const float b_int_v = s.inv3dt + 2.0f * s.v_vis_h2;
  const float b_int_t = s.inv3dt + 2.0f * s.t_vis_h2;

  // this thread's line l and cells: rows p0 + j kRows (j < kE) below n;
  // the threads run along the lines on X and Y, along the rows on Z, so
  // a warp's cells of a row, or of a line, are one coalesced run.  Kept
  // for the rebuilds of the rows: the class code (class | FREE velocity
  // << 2 | FREE T << 3 | flags << 4) and adv/(2h).  Lines past the grid's
  // edge are identity rows.
  const int p0 = kZ ? t % kRows : t / kL, l = kZ ? t / kRows : t % kL;
  const int si0 = p0 * kS + l;
  int code[kE];
  float adv2h[kE];
#pragma unroll
  for (int j = 0; j < kE; ++j) {
    code[j] = 0;
    adv2h[j] = 0.f;
  }
  auto row = [&](int j) { return p0 + j * kRows; };
  auto sidx = [&](int j) { return si0 + j * kRows * kS; };
  auto gidx = [&](int j) { return base0 + row(j) * g.sp + l * g.s2; };
  auto live = [&](int j) { return row(j) < n && l < lines_v; };

  // ---- build: the velocity rows and the d's of u, v, w, T
#pragma unroll
  for (int j = 0; j < kE; ++j) {
    const int i = sidx(j), p = row(j);
    if (p >= n) continue;
    float a = 0.f, b = 1.f, c = 0.f, d[4] = {0.f, 0.f, 0.f, 0.f};
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
      adv2h[j] = __fmul_rn(pick(tc, ax), s.inv2h);
      build_abc(cl, fv, false, adv2h[j], s.v_vis_h2, b_int_v, a, b, c);
#pragma unroll
      for (int v = 0; v < 4; ++v)
        d[v] = rhs_d(cl, v, ax, v == 3, fv, ft, tc[v], rh[v], gT, fT, s);
      code[j] = cl | (fv << 2) | (ft << 3) | (fl << 4);
    }
    sm[kA * plane + i] = p == 0 ? 0.f : a;
    sm[kB * plane + i] = b;
    sm[kC * plane + i] = p == n - 1 ? 0.f : c;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      sm[(kD + v) * plane + i] = d[v];
      if constexpr (kDual) sm[(kSave + v) * plane + i] = d[v];
    }
  }

  // the rows of the velocity (tv false) or T chain, pass A or B (on pass B
  // a dual cell takes the BC0 start role), capped
  auto rebuild = [&](bool tv, bool pass_b) {
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      const int i = sidx(j), p = row(j);
      if (p >= n) continue;
      float a = 0.f, b = 1.f, c = 0.f;
      if (l < lines_v) {
        int cl = code[j] & 3;
        if (pass_b && (code[j] & 16)) cl = kBC0;
        const bool free = (code[j] >> (tv ? 3 : 2)) & 1;
        build_abc(cl, free, false, adv2h[j], tv ? s.t_vis_h2 : s.v_vis_h2,
                  tv ? b_int_t : b_int_v, a, b, c);
      }
      sm[kA * plane + i] = p == 0 ? 0.f : a;
      sm[kB * plane + i] = b;
      sm[kC * plane + i] = p == n - 1 ? 0.f : c;
    }
  };

  // pass B of a chain whose pass A left x in the d planes v0 .. v0+K-1:
  // keep x_A, restore the d's, reduce pass B's rows, stitch
  auto pass_b = [&](auto reduce, bool tv, int v0, int K) {
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      if (row(j) >= n) continue;
      const int i = sidx(j);
      for (int k = 0; k < K; ++k) {
        sm[(kXa + k) * plane + i] = sm[(kD + v0 + k) * plane + i];
        sm[(kD + v0 + k) * plane + i] = sm[(kSave + v0 + k) * plane + i];
      }
    }
    rebuild(tv, true);
    reduce();
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      if (row(j) >= n || (code[j] & 32)) continue;
      const int i = sidx(j);
      for (int k = 0; k < K; ++k)
        sm[(kD + v0 + k) * plane + i] = sm[(kXa + k) * plane + i];
    }
  };

  // UpdateSegment, the NODE_IN merge and the gmerge fold of variables
  // v0 .. v1-1
  auto update = [&](int v0, int v1) {
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      if (!live(j)) continue;
      const long long o = gidx(j);
      const int cl = code[j] & 3;
      for (int v = v0; v < v1; ++v) {
        const float x = sm[(kD + v) * plane + sidx(j)];
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
  };

  auto reduce_v = [&] {
    pcr_chain<3, kExact>(sm, plane, kS, n, p0, si0, kD);
  };
  auto reduce_t = [&] {
    pcr_chain<1, kExact>(sm, plane, kS, n, p0, si0, kD + 3);
  };
  reduce_v();
  if constexpr (kDual) pass_b(reduce_v, false, 0, 3);
  update(0, 3);
  rebuild(true, false);
  reduce_t();
  if constexpr (kDual) pass_b(reduce_t, true, 3, 1);
  update(3, 4);
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

template <bool kZ, bool kExact, bool kDual, class P>
int launch_kernel(const Ptrs<P>& a, const Geo& g, int gmerge, const Scal& s,
                  cudaStream_t stream) {
  constexpr int kS = kZ ? kL + 1 : kL;
  const int bytes = (kDual ? kPlanesDual : kPlanes) * g.n * kS * 4;
  auto kernel = pcr_sweep_iter_kernel<kZ, kExact, kDual, P>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((g.n2 + kL - 1) / kL, g.n1);
  kernel<<<grid, kThreads, bytes, stream>>>(a.temp, a.cls, a.bcv, a.bct,
                                            a.rhs, a.op, a.flags, a.out,
                                            a.tn, g, gmerge, s);
  return (int)cudaGetLastError();
}

template <bool kZ, bool kExact, class P>
int launch_dual(const Ptrs<P>& a, const Geo& g, int gmerge, const Scal& s,
                cudaStream_t st) {
  return a.flags ? launch_kernel<kZ, kExact, true>(a, g, gmerge, s, st)
                 : launch_kernel<kZ, kExact, false>(a, g, gmerge, s, st);
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
  if (axis == 2)
    return exact ? launch_dual<true, true>(a, g, gmerge, s, st)
                 : launch_dual<true, false>(a, g, gmerge, s, st);
  return exact ? launch_dual<false, true>(a, g, gmerge, s, st)
               : launch_dual<false, false>(a, g, gmerge, s, st);
}

}  // namespace
