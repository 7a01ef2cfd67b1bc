// The chunk copies that pair_sweep.cu, line_sweep.cu and tridiag_rows.cu
// share: cp.async of 4-byte elements into [row][line] tile planes in
// shared memory, lines fast (a chunk row of the block's lines is one
// coalesced run) or rows fast (each line's rows are one contiguous run:
// the transposing tile of a sweep along the contiguous axis), and the
// int8 mask runs copied as the aligned words that cover them.  bf16
// payload planes (the bf16 mode) are staged the way the masks are:
// cp.async copies 4, 8 or 16 bytes, not a 2-byte element, and a bf16 row
// of an odd grid starts on a 2-byte boundary, so the aligned 4-byte words
// that cover each contiguous bf16 run go into the plane's tile slot as raw
// bf16 (half a float plane's bytes), in flight like any chunk copy;
// staged_bf16 reads an element back at its run's offset and upcasts it
// (exact) where the walk reads the tile.  Outputs are stored through
// store_as, which rounds to bf16 to nearest even (torch's
// .to(torch.bfloat16) and XLA's convert round so).
#pragma once

#include <cstdint>

#include <cuda_bf16.h>

namespace {

// Row stride (floats) of a tile plane of L lines and R rows.  Rows fast
// (kZ), L is padded so that a warp's copies (R rows of 32 / R lines) hit
// distinct banks.
template <bool kZ, int L, int R>
__host__ __device__ constexpr int tile_stride() {
  return kZ ? L + (R >= 32 ? 1 : 32 / R) : L;
}

// cp.async of 4 bytes to the shared-window byte address ``sa``.
__device__ __forceinline__ void cp_async4(unsigned sa, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sa),
               "l"(gmem)
               : "memory");
}

// A payload element as float (bf16 upcasts exactly), and a float stored
// as element i of a payload (bf16 rounds to nearest even).
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, long long i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_as(__nv_bfloat16* p, long long i,
                                         float v) {
  p[i] = __float2bfloat16_rn(v);
}

// The payload types of a sweep launch: what it reads for rhs (R) and for
// out_prev (O), and what it writes for out and tn (W) (pair_sweep.cuh,
// pcr_sweep.cuh).  A bf16 pair is two launches: the first reads bf16 and
// writes float32 out1 and tn1, as the TPU kernel keeps them in float32
// VMEM; the second reads float32 out1 and writes bf16.
template <class TR, class TO, class TW>
struct Payload {
  using R = TR;
  using O = TO;
  using W = TW;
};
using bf16 = __nv_bfloat16;
using PayF32 = Payload<float, float, float>;
using PayIn = Payload<bf16, bf16, float>;    // a bf16 pair's first launch
using PayOut = Payload<bf16, float, bf16>;   // a bf16 pair's second launch
using PayBf16 = Payload<bf16, bf16, bf16>;   // the bf16 stream iteration

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A thread's share of a chunk's copy: the R elements it copies of each
// plane.  Lines fast: element j is row j of line l0 = t (one coalesced run
// a row when lines are contiguous).  Rows fast: element j is row r0 = t % R
// of line l0 + j L / R, l0 = t / R (runs of R floats along contiguous
// lines).  Element j lies g0 + j gs elements past the chunk's first cell
// (rows rs, lines ls apart) and s0 + 4 j kStep bytes into the plane.
template <bool kLinesFast, int L, int R, int kS>
struct Lane {
  static_assert(kLinesFast || L % R == 0, "rows-fast tiles need R | L");
  static constexpr int kStep = kLinesFast ? kS : L / R;
  int r0, l0, g0, gs;
  unsigned s0;
  __device__ Lane(int t, int rs, int ls)
      : r0(kLinesFast ? 0 : t % R), l0(kLinesFast ? t : t / R),
        g0(r0 * rs + l0 * ls), gs(kLinesFast ? rs : (L / R) * ls),
        s0(4u * (r0 * kS + l0)) {}
  __device__ int row(int j) const { return kLinesFast ? j : r0; }
  __device__ int line(int j) const {
    return kLinesFast ? l0 : l0 + j * (L / R);
  }
  // Copy the chunk of a plane whose first cell is src into the shared
  // plane at sa; ``full`` when every element lies inside the grid, else
  // rows [0, rows_v) of lines [0, lines_v); dl(l) shifts line l's reads.
  template <class Dl>
  __device__ __forceinline__ void copy(unsigned sa, const float* src,
                                       bool full, int rows_v, int lines_v,
                                       Dl dl) const {
    if (full) {
#pragma unroll
      for (int j = 0; j < R; ++j)
        cp_async4(sa + s0 + 4u * (j * kStep),
                  src + (g0 + j * gs + dl(line(j))));
    } else {
#pragma unroll
      for (int j = 0; j < R; ++j)
        if (row(j) < rows_v && line(j) < lines_v)
          cp_async4(sa + s0 + 4u * (j * kStep),
                    src + (g0 + j * gs + dl(line(j))));
    }
  }
  // The same for a bf16 plane, staged: the aligned words that cover each
  // contiguous run of the chunk go to the slot at sa, kW words a run (a
  // word that holds a byte of the tensor never crosses a page).  Lines
  // fast (the lines contiguous): run r is row r, its word w copied by
  // thread w.  Rows fast: run l is line l, the block's L kW words spread
  // over its L threads in order, so a warp copies whole runs.  Read back
  // with staged_bf16.
  static constexpr int kW = (kLinesFast ? L : R) / 2 + 1;
  template <class Dl>
  __device__ __forceinline__ void copy(unsigned sa,
                                       const __nv_bfloat16* src, bool full,
                                       int rows_v, int lines_v, Dl) const {
    if constexpr (kLinesFast) {
      if (l0 >= kW) return;
      const int len = 2 * (full ? L : lines_v);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const uintptr_t a = (uintptr_t)(src + (long long)r * gs);
        if ((full || r < rows_v) && l0 < (((int)(a & 3) + len + 3) >> 2))
          cp_async4(sa + 4u * (r * kW + l0),
                    (const void*)((a & ~(uintptr_t)3) + 4 * l0));
      }
    } else {
      const int t = l0 * R + r0, ls = gs / (L / R);
      const int len = 2 * (full ? R : rows_v);
#pragma unroll
      for (int k = 0; k < kW; ++k) {
        const int f = t + k * L, l = f / kW, w = f - l * kW;
        const uintptr_t a = (uintptr_t)(src + (long long)l * ls);
        if ((full || l < lines_v) && w < (((int)(a & 3) + len + 3) >> 2))
          cp_async4(sa + 4u * f, (const void*)((a & ~(uintptr_t)3) + 4 * w));
      }
    }
  }
};

struct NoShift {
  __device__ int operator()(int) const { return 0; }
};

// Which half of its 4-byte word holds element e of the bf16 plane at
// ``plane`` (0 or 1): the parity of the element's address in 2-byte
// units, so only the low bits of the address and of e matter.
__device__ __forceinline__ int bf16_half(const __nv_bfloat16* plane,
                                         unsigned e) {
  return (int)((((unsigned)(uintptr_t)plane >> 1) + e) & 1u);
}

// Element (r, l) of a chunk's bf16 plane staged by Lane::copy into the
// slot at ``slot``, upcast; ``half`` is bf16_half of the run's first
// element (row r's first line lines fast, line l's first row rows fast),
// the same in every chunk of the plane (a chunk's R rows are even).
template <bool kLinesFast, int L, int R>
__device__ __forceinline__ float staged_bf16(const float* slot, int half,
                                             int r, int l) {
  static_assert(R % 2 == 0, "a chunk's first row keeps a run's half");
  constexpr int kW = (kLinesFast ? L : R) / 2 + 1;
  const int i = (kLinesFast ? 2 * kW * r + l : 2 * kW * l + r) + half;
  return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(slot)[i]);
}

// Copy the aligned words that cover each contiguous byte run of a mask
// chunk into the shared plane at sa, kW words a run (a word that holds a
// byte of the tensor never crosses a page).  X/Y: run r is row r, lines_v
// bytes from first + r sp, its word t copied by thread t.  Z: run l is
// line l, rows_v bytes from first + l s2, all its words by thread l.
template <bool kZ, int R, int kW>
__device__ __forceinline__ void copy_mask(unsigned sa, int t, int rows_v,
                                          int lines_v, const int8_t* first,
                                          int sp, int s2) {
  if constexpr (kZ) {
    if (t >= lines_v) return;
    const uintptr_t a = (uintptr_t)(first + t * s2);
    const int nw = ((int)(a & 3) + rows_v + 3) >> 2;
#pragma unroll
    for (int w = 0; w < kW; ++w)
      if (w < nw)
        cp_async4(sa + 4u * (t * kW + w),
                  (const void*)((a & ~(uintptr_t)3) + 4 * w));
  } else {
    if (t >= kW) return;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uintptr_t a = (uintptr_t)(first + (long long)r * sp);
      if (r < rows_v && t < (((int)(a & 3) + lines_v + 3) >> 2))
        cp_async4(sa + 4u * (r * kW + t),
                  (const void*)((a & ~(uintptr_t)3) + 4 * t));
    }
  }
}

// Byte idx of run seg, whose first byte lies ``off`` (0..3) into its word.
template <int kW>
__device__ __forceinline__ int mask_at(const unsigned* pl, int seg, int idx,
                                       int off) {
  return reinterpret_cast<const int8_t*>(pl + seg * kW)[off + idx];
}

}  // namespace
