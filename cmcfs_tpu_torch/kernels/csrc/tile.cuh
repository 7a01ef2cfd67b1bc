// The chunk copies that pair_sweep.cu, line_sweep.cu and tridiag_rows.cu
// share: cp.async of 4-byte elements into [row][line] tile planes in
// shared memory, lines fast (a chunk row of the block's lines is one
// coalesced run) or rows fast (each line's rows are one contiguous run:
// the transposing tile of a sweep along the contiguous axis), and the
// int8 mask runs copied as the aligned words that cover them.  bf16
// payload planes (the bf16 mode) take their own loader: cp.async copies 4,
// 8 or 16 bytes, not a 2-byte element, and a bf16 row of an odd grid
// starts on a 2-byte boundary; their elements are loaded, upcast (exact)
// and stored to the same float tile planes.  Outputs are stored through
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

// st.shared of one float at the shared-window byte address ``sa``.
__device__ __forceinline__ void st_shared_f32(unsigned sa, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(sa), "f"(v) : "memory");
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
  // The same for a bf16 plane: each element loaded and upcast by this
  // thread and stored to the float tile (all loads first).  It is in the
  // tile once this thread's stores are done, so after the block's next
  // barrier, like the cp.async copies after their wait.
  template <class Dl>
  __device__ __forceinline__ void copy(unsigned sa,
                                       const __nv_bfloat16* src, bool full,
                                       int rows_v, int lines_v, Dl dl) const {
    float v[R];
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (full || (row(j) < rows_v && line(j) < lines_v))
        v[j] = __bfloat162float(src[g0 + j * gs + dl(line(j))]);
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (full || (row(j) < rows_v && line(j) < lines_v))
        st_shared_f32(sa + s0 + 4u * (j * kStep), v[j]);
  }
};

struct NoShift {
  __device__ int operator()(int) const { return 0; }
};

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
