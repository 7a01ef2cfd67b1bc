// The Thomas walk that line_sweep.cu and tridiag_rows.cu share: one block
// of L consecutive lines walks them forward once and backward once, each
// thread one line with every system of it.  A row policy P says what a
// row stages and how it becomes tridiagonal rows:
//
//   kNF           float planes staged a row (fields, at stride fs apart
//                 where they are variables of one tensor)
//   kMask         an int8 code plane staged beside them
//   kNC, kND      the c' chains (one per distinct set of rows) and the d'
//                 chains (one per right-hand side)
//   chain(v)      the c' chain whose rows system v solves
//   fetch(lane, i, sa, o, full, rows_v, lines_v)   copy the chunk of plane
//                 i whose first cell lies o past the plane's first cell
//                 into the tile plane at sa (Lane::copy: cp.async of the
//                 float32 elements, or of the words covering bf16 runs);
//                 mask() the code plane's first cell
//   kStaged       some planes are staged bf16: read(...) reads a row's
//                 values from the tile (else each plane's float slot)
//   rows(f, code, a, b, c, d)   the rows of every chain and the right-hand
//                 side of every system, from a row's staged values
//
// The solution x is stored as the type of the x pointer: float32, or bf16
// rounded to nearest even (store_as).
//
// Forward: at each row the walk advances every chain, in the plain
// version's order (ops/tridiag_rows.tridiag_rows_ref): a = 0 on row 0, c =
// 0 on row n-1, denom = b - a*c', c' = c/denom and d' = (d - d'*a)/denom
// (exact, or row 0 unless recip_row0) or both times one IEEE reciprocal;
// products rounded before the subtraction (__fmul_rn / __fsub_rn).  The
// reciprocal (or the denominator) is used in the same step and never
// stored.  c' of every chain and d' of every system go to the scratch,
// laid out [plane][row][column] (column = i1 pad_lines(n2) + i2), so every
// store and load of it is coalesced; each value is written once and read
// once.
// Backward: x = d' - c' x_next (x = d' on row n-1).
//
// Rows fetched ahead of the chain: the block walks its lines in chunks of
// R rows through S chunk buffers in shared memory; while it computes chunk
// k, cp.async fills the others with chunks k+1 .. k+S-1 (tile.cuh's Lane
// and copy_mask).  The forward walk reads a row from the tile one row
// ahead of the step that uses it.  The backward walk fetches its scratch
// rows the same way.  kZ (lines along the contiguous axis): the chunk is
// copied as L runs of R contiguous floats into a padded [row][line] tile,
// and x of a row goes back into its d' slot once read, so the block stores
// the tile as the same runs; otherwise x is stored from registers, one
// coalesced row of the block's lines at a time.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

// The lines of one launch: line (i1, i2) starts at i1*s1 + i2*s2, its rows
// p = 0..n-1 lie sp apart; systems (variables, right-hand sides) lie fs
// apart.  Offsets within a chunk (R rows, L lines) fit in 32 bits.
struct Lines {
  int n, n1, n2;
  long long sp, s1, s2, fs;
};

// Scratch columns: line (i1, i2) is column i1 * pad_lines(n2) + i2 of a
// [plane][row][column] scratch.  n2 padded to a multiple of 64 puts every
// block's columns of a row on a 256-byte boundary; unpadded, the blocks of
// an odd n2 (383^3) straddle 32-byte sectors on every scratch row.
constexpr int kLinePad = 64;
__host__ __device__ inline long long pad_lines(int n2) {
  return (n2 + kLinePad - 1) / kLinePad * (long long)kLinePad;
}
__host__ __device__ inline long long scratch_lines(const Lines& g) {
  return g.n1 * pad_lines(g.n2);
}

// Shared-memory layout of one block (in 4-byte words).  A plane is R rows
// of kS floats, row r of line l at r * kS + l; a mask plane holds kSegs
// contiguous byte runs (rows, or lines when kZ) of kW words each.  Forward
// buffer: the kNF field planes and the mask; backward buffer: the scratch
// planes (c' of each chain, then d' of each system).  The two walks reuse
// the same memory.
template <class P, bool kZ, int L, int R, int S>
struct WalkTile {
  static_assert(L % 4 == 0 && (!kZ || R % 4 == 0),
                "mask runs are copied as whole words");
  static constexpr int kS = tile_stride<kZ, L, R>();
  static constexpr int kPlane = R * kS;
  static constexpr int kW = (kZ ? R : L) / 4 + 1;
  static constexpr int kMask = P::kMask ? (kZ ? L : R) * kW : 0;
  static constexpr int kNs = P::kNC + P::kND;        // scratch planes
  static constexpr int kFwd = P::kNF * kPlane + kMask;
  static constexpr int kBwd = kNs * kPlane;
  static constexpr int kWords = S * (kFwd > kBwd ? kFwd : kBwd);
};

template <class P, bool kZ, bool kExact, int L, int R, int S, class TX>
__device__ __forceinline__ void walk(const P& pol, const Lines& g,
                                     bool recip_row0, TX* __restrict__ x,
                                     float* __restrict__ scratch) {
  using Tl = WalkTile<P, kZ, L, R, S>;
  constexpr int kS = Tl::kS, kPlane = Tl::kPlane, kW = Tl::kW;
  constexpr int NC = P::kNC, ND = P::kND, NF = P::kNF;
  extern __shared__ float smem[];
  const int t = threadIdx.x;
  const int nb2 = (g.n2 + L - 1) / L;
  const int i1 = blockIdx.x / nb2;
  const int i20 = (blockIdx.x - i1 * nb2) * L;
  const int n = g.n;
  const int lines_v = min(L, g.n2 - i20);
  const bool valid = t < lines_v;
  const long long lines = scratch_lines(g);
  const long long line0 = (long long)i1 * pad_lines(g.n2) + i20;
  const long long base0 = i1 * g.s1 + i20 * g.s2;        // line 0's cell 0
  const long long sps = (long long)n * lines;           // scratch plane
  const int sp = (int)g.sp, s2 = (int)g.s2;
  const int nch = (n + R - 1) / R;
  const int8_t* const mk = P::kMask ? pol.mask() + base0 : nullptr;
  const int moff = (int)((uintptr_t)mk & 3);
  // where the first byte of mask run seg (a row, or a line when kZ) of the
  // chunk at row p0 lies in its word; mod 4, so unsigned wraps
  auto run_off = [&](int p0, int seg) {
    const unsigned row0 = (unsigned)p0 * (kZ ? 1u : (unsigned)sp);
    return (int)((moff + row0 + (unsigned)seg * (unsigned)(kZ ? s2 : sp)) &
                 3u);
  };

  // ---- the copies: field planes in the tile's mapping, scratch planes
  // lines fast; shared addresses as bytes of the shared window
  const Lane<!kZ, L, R, kS> fld(t, sp, s2);
  const Lane<true, L, R, kS> scl(t, (int)lines, 1);
  const unsigned sb = (unsigned)__cvta_generic_to_shared(smem);
  auto chunk_rows = [&](int k) { return min(R, n - k * R); };
  auto is_full = [&](int k) { return chunk_rows(k) == R && lines_v == L; };

  // ---- forward buffers: chunk k in buffer k % S
  auto fetch_fwd = [&](int k) {
    const unsigned st = sb + 4u * ((k % S) * Tl::kFwd);
    const int p0 = k * R, rows_v = chunk_rows(k);
    const bool full = is_full(k);
    const long long o0 = base0 + (long long)p0 * g.sp;
#pragma unroll
    for (int i = 0; i < NF; ++i)
      pol.fetch(fld, i, st + 4u * (i * kPlane), o0, full, rows_v, lines_v);
    if constexpr (P::kMask)
      copy_mask<kZ, R, kW>(st + 4u * (NF * kPlane), t, rows_v, lines_v,
                           mk + (kZ ? p0 : (long long)p0 * g.sp), sp, s2);
  };

  struct Row {
    float f[NF];
    int code;
  };
  auto read_fwd = [&](int k, int r, Row& w) {
    const float* st = smem + (k % S) * Tl::kFwd;
    const int i = r * kS + t;
    if constexpr (P::kStaged) {
      pol.template read<!kZ, L, R, kS, kPlane>(st, base0, kZ ? s2 : sp, r,
                                               t, w.f);
    } else {
#pragma unroll
      for (int j = 0; j < NF; ++j) w.f[j] = st[j * kPlane + i];
    }
    w.code = 0;
    if constexpr (P::kMask)
      w.code = mask_at<kW>(
          reinterpret_cast<const unsigned*>(st + NF * kPlane), kZ ? t : r,
          kZ ? r : t, run_off(k * R, kZ ? t : r));
  };

  // ---- forward walk: every chain one row on
  float cp[NC], dp[ND];
#pragma unroll
  for (int j = 0; j < NC; ++j) cp[j] = 0.f;
#pragma unroll
  for (int v = 0; v < ND; ++v) dp[v] = 0.f;
  float* const sc0 = scratch + line0 + t;

  auto fwd_step = [&](int p, const Row& w) {
    float a[NC], b[NC], c[NC], d[ND], q[NC];
    pol.rows(w.f, w.code, a, b, c, d);
    // q divides (exact, or row 0 unless recip_row0) or multiplies
    const bool divide = kExact || (p == 0 && !recip_row0);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      if (p == 0) a[j] = 0.f;
      if (p == n - 1) c[j] = 0.f;
      const float den = __fsub_rn(b[j], __fmul_rn(a[j], cp[j]));
      if (divide) {
        cp[j] = c[j] / den;
        q[j] = den;
      } else {
        q[j] = 1.0f / den;
        cp[j] = __fmul_rn(c[j], q[j]);
      }
    }
    float* sc = sc0 + (long long)p * lines;
#pragma unroll
    for (int v = 0; v < ND; ++v) {
      const int j = P::chain(v);
      const float num = __fsub_rn(d[v], __fmul_rn(dp[v], a[j]));
      dp[v] = divide ? num / q[j] : __fmul_rn(num, q[j]);
      sc[(NC + v) * sps] = dp[v];
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) sc[j * sps] = cp[j];
  };

  // S buffers: the copies of chunk k + S - 1 run while chunk k is walked
  Row cu, nx;
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
      const int rows_v = chunk_rows(k);
#pragma unroll 1
      for (int r = 0; r < rows_v; ++r) {
        read_fwd(k, r, nx);
        const int q = k * R + r;
        if (q > 0) fwd_step(q - 1, cu);
        cu = nx;
      }
    }
    __syncthreads();
  }
  if (valid) fwd_step(n - 1, cu);
  // this thread's scratch stores before its copies of them below
  __threadfence_block();
  __syncthreads();

  // ---- backward buffers: chunk k in buffer b
  auto fetch_bwd = [&](int k, int b) {
    const unsigned st = sb + 4u * (b * Tl::kBwd);
    const int p0 = k * R, rows_v = chunk_rows(k);
    const bool full = is_full(k);
#pragma unroll
    for (int j = 0; j < Tl::kNs; ++j)
      scl.copy(st + 4u * (j * kPlane),
               scratch + j * sps + (long long)p0 * lines + line0, full,
               rows_v, lines_v, NoShift());
  };

  // ---- backward walk: X/Y store x of a row directly; Z puts it into the
  // row's d' slot, which it has read
  float xn[ND];
  TX* const x0 = x + base0 + t * g.s2;
  auto bwd_row = [&](int b, int k, int r) {
    float* st = smem + b * Tl::kBwd;
    const int i = r * kS + t, p = k * R + r;
    float c[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) c[j] = st[j * kPlane + i];
#pragma unroll
    for (int v = 0; v < ND; ++v) {
      const float dv = st[(NC + v) * kPlane + i];
      xn[v] = p == n - 1 ? dv
                         : __fsub_rn(dv, __fmul_rn(c[P::chain(v)], xn[v]));
      if constexpr (kZ)
        st[(NC + v) * kPlane + i] = xn[v];
      else
        store_as(x0, v * g.fs + (long long)p * g.sp, xn[v]);
    }
  };

  // Z: x of chunk k from buffer b, as the copies mapped it: L runs of R
  // contiguous floats
  auto store_tile = [&](int b, int k) {
    const float* st = smem + b * Tl::kBwd + fld.s0 / 4;
    const int rows_v = chunk_rows(k);
    const bool full = is_full(k);
    TX* const o = x + base0 + (long long)k * R * g.sp + fld.g0;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (full || (fld.row(j) < rows_v && fld.line(j) < lines_v)) {
        const int i = j * fld.kStep, oj = j * fld.gs;
#pragma unroll
        for (int v = 0; v < ND; ++v)
          store_as(o, v * g.fs + oj, st[(NC + v) * kPlane + i]);
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
      for (int r = chunk_rows(k) - 1; r >= 0; --r) bwd_row(b, k, r);
    }
    if constexpr (kZ) {
      __syncthreads();
      store_tile(b, k);
    }
    __syncthreads();
  }
}

// The launch of a walk kernel over g's lines: one block of L threads per
// L lines, blocks numbered i1-major; dynamic shared memory past 48 KB is
// opted into.  Returns cudaGetLastError().
template <class P, bool kZ, int L, int R, int S, class Kernel, class TX>
int launch_walk(Kernel kernel, const P& pol, const Lines& g, int recip_row0,
                TX* x, float* scratch, cudaStream_t stream) {
  const int bytes = WalkTile<P, kZ, L, R, S>::kWords * 4;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (long long)g.n1 * ((g.n2 + L - 1) / L);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, L, bytes, stream>>>(pol, g, recip_row0, x,
                                                 scratch);
  return (int)cudaGetLastError();
}

// Lines g a launch can address: a chunk's offsets (32 rows of sp, 64
// lines of s2, 32 rows of the scratch's columns) in 32 bits.
inline bool lines_ok(const Lines& g) {
  return g.n >= 1 && g.n1 >= 1 && g.n2 >= 1 &&
         g.sp * 32 <= 0x7fffffffLL && g.s2 * 64 <= 0x7fffffffLL &&
         scratch_lines(g) <= 0x7fffffffLL / 32;
}

}  // namespace
