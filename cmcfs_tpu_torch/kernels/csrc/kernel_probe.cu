// Stream-kernel probe: the copy floor, the compute floor and the real solve
// of one 4-variable direction on this card, for sm_90a.
//
// Replaces: scripts/kernel_probe.py::make_probe (kernel), the TPU probe
//   that isolates the stream kernel's bottleneck on its slab geometry.
//   Fields as the script's: temp, rhs (4, n, n, n) and forc (n, n, n)
//   float32, rows along axis 1 of a field; adv = temp[1], pk = forc,
//   a = -adv*0.5 - 1, b = 3 + pk, c = adv*0.5 - 1, d = rhs[v]; the
//   reciprocal form r = 1/denom, c' = c*r, d' = (d - d'_prev*a)*r,
//   x = d' - c'*x_next.  Every product is rounded before it is added
//   (__fmul_rn / __fsub_rn) and 1/denom is the IEEE reciprocal, as the
//   plain PyTorch version computes them, so the Thomas modes equal it bit
//   for bit.  Modes (``mode``):
//   0 dma: out = rhs, tn = temp, reading adv, T and pk on the way as the
//     script's DMAs do (asm volatile loads, never dropped): the copy floor.
//   1 full: the solve, out[v] = d', tn[v] = x, the coefficients rebuilt for
//     each variable as the script's compute() does; c' in global scratch.
//   2 comp: full's work on inputs that stay on chip.  Every block reads
//     the same tile, the lines (0, p, k < 32), resident in L2 / L1 after
//     the first touch; c', d' and x go to shared memory ([row][line], no
//     bank conflicts), one warp a block.  Each thread publishes x[v] of one
//     row (pub[v, g] = x_v(line g % 32, row (g / 32) % n)), so the work is
//     not dead and the tile is covered: the compute-plus-latency floor.
//   3 comp2: comp with the loads of 8 rows issued ahead of the dependent
//     chain (the script's 8-row tile group; prefetching rows ahead).
//   4 comps, 5 compi: one coefficient chain storing c' and 1/denom, then
//     the 4 d-chains one after another (comps) or interleaved (compi).
//   6 pcr: parallel cyclic reduction of the shared (a, b, c) and the 4 d's
//     in shared memory over ceil(log2 n) levels, one block of n threads a
//     line (the script's compute_pcr; within 1e-5 of Thomas, not bitwise).
//
// What bounds it on this card: dma and full are bound by bytes and
//   latency.  dma moves 17 fields of 4 bytes a cell (temp, rhs, forc read;
//   out, tn written: 1.14 GB at 256^3, 0.34 ms at 3.35 TB/s); full's
//   compulsory traffic is 14 fields (adv, pk, rhs read; out, tn written),
//   and its scratch and re-reads add more.  Each thread carries one line's
//   serial chain (65,536 lines at 256^3), a warp's row step one coalesced
//   128-byte row.  The comp modes bound the same chains without device
//   memory; their shared-memory scratch (2 to 6 floats a row per line)
//   limits a block to one warp and an SM to 1-3 blocks at n = 256.
#include <cuda_runtime.h>

namespace {

constexpr int kLineThreads = 128;   // dma / full
constexpr int kTile = 32;           // tile lines = threads of a comp block

__device__ __forceinline__ float ld_keep(const float* p) {
  float v;
  asm volatile("ld.global.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}

struct Abc {
  float a, b, c;
};

__device__ __forceinline__ float a_of(float adv) {
  return __fsub_rn(__fmul_rn(-adv, 0.5f), 1.f);
}

__device__ __forceinline__ Abc abc_of(float adv, float pk) {
  return {a_of(adv), __fadd_rn(3.f, pk), __fsub_rn(__fmul_rn(adv, 0.5f), 1.f)};
}

// One forward step: c_prev, d_prev become the row's c', d'.
__device__ __forceinline__ void fwd_step(float adv, float pk, float d,
                                         float& c_prev, float& d_prev) {
  const Abc k = abc_of(adv, pk);
  const float r = 1.0f / __fsub_rn(k.b, __fmul_rn(k.a, c_prev));
  c_prev = __fmul_rn(k.c, r);
  d_prev = __fmul_rn(__fsub_rn(d, __fmul_rn(d_prev, k.a)), r);
}

__device__ __forceinline__ float bwd_step(float dp, float cp, float x_next) {
  return __fsub_rn(dp, __fmul_rn(cp, x_next));
}

__global__ void __launch_bounds__(kLineThreads)
dma_kernel(const float* __restrict__ temp, const float* __restrict__ rhs,
           const float* __restrict__ forc, float* __restrict__ out,
           float* __restrict__ tn, int n, long long vs, long long lines) {
  const long long t = (long long)blockIdx.x * kLineThreads + threadIdx.x;
  if (t >= lines) return;
  const long long i = t / n;
  const long long base = i * n * n + (t - i * n);
  for (int p = 0; p < n; ++p) {
    const long long o = base + (long long)p * n;
    (void)ld_keep(temp + vs + o);        // adv
    (void)ld_keep(temp + 3 * vs + o);    // T
    (void)ld_keep(forc + o);             // pk
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      out[v * vs + o] = rhs[v * vs + o];
      tn[v * vs + o] = temp[v * vs + o];
    }
  }
}

__global__ void __launch_bounds__(kLineThreads)
full_kernel(const float* __restrict__ temp, const float* __restrict__ rhs,
            const float* __restrict__ forc, float* __restrict__ out,
            float* __restrict__ tn, float* __restrict__ cp, int n,
            long long vs, long long lines) {
  const long long t = (long long)blockIdx.x * kLineThreads + threadIdx.x;
  if (t >= lines) return;
  const long long i = t / n;
  const long long base = i * n * n + (t - i * n);
  const float* adv = temp + vs;
  for (int v = 0; v < 4; ++v) {
    const float* d = rhs + v * vs;
    float* dv = out + v * vs;
    float c_prev = 0.f, d_prev = 0.f;
    for (int p = 0; p < n; ++p) {
      const long long o = base + (long long)p * n;
      fwd_step(adv[o], forc[o], d[o], c_prev, d_prev);
      cp[o] = c_prev;
      dv[o] = d_prev;
    }
    float* xv = tn + v * vs;
    float x = 0.f;
    for (int p = n - 1; p >= 0; --p) {
      const long long o = base + (long long)p * n;
      x = bwd_step(dv[o], cp[o], x);
      xv[o] = x;
    }
  }
}

// comp / comp2: tile line t = threadIdx.x (cells p * n + t), scratch
// cps, ds of [row][kTile] floats.
template <bool kAhead>
__global__ void __launch_bounds__(kTile)
comp_kernel(const float* __restrict__ temp, const float* __restrict__ rhs,
            const float* __restrict__ forc, float* __restrict__ pub, int n,
            long long vs, long long lines) {
  extern __shared__ float sm[];
  float* cps = sm;
  float* ds = sm + n * kTile;
  const int t = threadIdx.x;
  const long long g = (long long)blockIdx.x * kTile + t;
  const int row = (int)(blockIdx.x % n);
  const float* adv = temp + vs;
  for (int v = 0; v < 4; ++v) {
    const float* d = rhs + v * vs;
    float c_prev = 0.f, d_prev = 0.f;
    if (kAhead) {
      for (int p0 = 0; p0 < n; p0 += 8) {
        float av[8], pv[8], dv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const long long o = (long long)(p0 + j) * n + t;
          av[j] = adv[o];
          pv[j] = forc[o];
          dv[j] = d[o];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          fwd_step(av[j], pv[j], dv[j], c_prev, d_prev);
          cps[(p0 + j) * kTile + t] = c_prev;
          ds[(p0 + j) * kTile + t] = d_prev;
        }
      }
      float x = 0.f;
      for (int p0 = n - 8; p0 >= 0; p0 -= 8) {
        float dv[8], cv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          dv[j] = ds[(p0 + j) * kTile + t];
          cv[j] = cps[(p0 + j) * kTile + t];
        }
#pragma unroll
        for (int j = 7; j >= 0; --j) {
          x = bwd_step(dv[j], cv[j], x);
          ds[(p0 + j) * kTile + t] = x;
        }
      }
    } else {
      for (int p = 0; p < n; ++p) {
        const long long o = (long long)p * n + t;
        fwd_step(adv[o], forc[o], d[o], c_prev, d_prev);
        cps[p * kTile + t] = c_prev;
        ds[p * kTile + t] = d_prev;
      }
      float x = 0.f;
      for (int p = n - 1; p >= 0; --p) {
        x = bwd_step(ds[p * kTile + t], cps[p * kTile + t], x);
        ds[p * kTile + t] = x;
      }
    }
    pub[v * lines + g] = ds[row * kTile + t];
  }
}

// comps / compi: c' and 1/denom once, then the 4 d-chains; scratch cps,
// rs and one (comps) or four (compi) ds of [row][kTile] floats.
template <bool kInter>
__global__ void __launch_bounds__(kTile)
comps_kernel(const float* __restrict__ temp, const float* __restrict__ rhs,
             const float* __restrict__ forc, float* __restrict__ pub, int n,
             long long vs, long long lines) {
  extern __shared__ float sm[];
  const int nt = n * kTile;
  float* cps = sm;
  float* rs = sm + nt;
  float* ds = sm + 2 * nt;
  const int t = threadIdx.x;
  const long long g = (long long)blockIdx.x * kTile + t;
  const int row = (int)(blockIdx.x % n);
  const float* adv = temp + vs;
  float c_prev = 0.f;
  for (int p = 0; p < n; ++p) {
    const long long o = (long long)p * n + t;
    const Abc k = abc_of(adv[o], forc[o]);
    const float r = 1.0f / __fsub_rn(k.b, __fmul_rn(k.a, c_prev));
    c_prev = __fmul_rn(k.c, r);
    cps[p * kTile + t] = c_prev;
    rs[p * kTile + t] = r;
  }
  if (kInter) {
    float dp[4] = {0.f, 0.f, 0.f, 0.f};
    for (int p = 0; p < n; ++p) {
      const long long o = (long long)p * n + t;
      const float a = a_of(adv[o]);
      const float r = rs[p * kTile + t];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        dp[q] = __fmul_rn(__fsub_rn(rhs[q * vs + o], __fmul_rn(dp[q], a)), r);
        ds[q * nt + p * kTile + t] = dp[q];
      }
    }
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    for (int p = n - 1; p >= 0; --p) {
      const float cpr = cps[p * kTile + t];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        x[q] = bwd_step(ds[q * nt + p * kTile + t], cpr, x[q]);
        ds[q * nt + p * kTile + t] = x[q];
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      pub[q * lines + g] = ds[q * nt + row * kTile + t];
  } else {
    for (int q = 0; q < 4; ++q) {
      float dp = 0.f;
      for (int p = 0; p < n; ++p) {
        const long long o = (long long)p * n + t;
        const float a = a_of(adv[o]);
        dp = __fmul_rn(__fsub_rn(rhs[q * vs + o], __fmul_rn(dp, a)),
                       rs[p * kTile + t]);
        ds[p * kTile + t] = dp;
      }
      float x = 0.f;
      for (int p = n - 1; p >= 0; --p) {
        x = bwd_step(ds[p * kTile + t], cps[p * kTile + t], x);
        ds[p * kTile + t] = x;
      }
      pub[q * lines + g] = ds[row * kTile + t];
    }
  }
}

// pcr: block g solves tile line g % kTile, thread i holds row i; the
// published row is (g / kTile) % n.  Shifted rows past either end read
// (a, b, c, d) = (0, 1, 0, 0), as the script's shift() fills them.
__global__ void pcr_kernel(const float* __restrict__ temp,
                           const float* __restrict__ rhs,
                           const float* __restrict__ forc,
                           float* __restrict__ pub, int n, long long vs,
                           long long lines) {
  extern __shared__ float sm[];
  float* sa = sm;
  float* sb = sm + n;
  float* sc = sm + 2 * n;
  float* sd = sm + 3 * n;             // 4 x n
  const long long g = blockIdx.x;
  const int t = (int)(g % kTile);
  const int row = (int)((g / kTile) % n);
  const int i = threadIdx.x;
  const long long o = (long long)i * n + t;
  const Abc k = abc_of(temp[vs + o], forc[o]);
  float a = k.a, b = k.b, c = k.c, d[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) d[q] = rhs[q * vs + o];
  for (int s = 1; s < n; s *= 2) {
    sa[i] = a;
    sb[i] = b;
    sc[i] = c;
#pragma unroll
    for (int q = 0; q < 4; ++q) sd[q * n + i] = d[q];
    __syncthreads();
    const int im = i - s, ip = i + s;
    const bool hm = im >= 0, hp = ip < n;
    const float am = hm ? sa[im] : 0.f, bm = hm ? sb[im] : 1.f,
                cm = hm ? sc[im] : 0.f;
    const float ap = hp ? sa[ip] : 0.f, bp = hp ? sb[ip] : 1.f,
                cpp = hp ? sc[ip] : 0.f;
    float dm[4], dq[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      dm[q] = hm ? sd[q * n + im] : 0.f;
      dq[q] = hp ? sd[q * n + ip] : 0.f;
    }
    __syncthreads();
    const float alpha = __fmul_rn(-a, 1.0f / bm);
    const float gamma = __fmul_rn(-c, 1.0f / bp);
    b = __fadd_rn(__fadd_rn(b, __fmul_rn(alpha, cm)), __fmul_rn(gamma, ap));
#pragma unroll
    for (int q = 0; q < 4; ++q)
      d[q] = __fadd_rn(__fadd_rn(d[q], __fmul_rn(alpha, dm[q])),
                       __fmul_rn(gamma, dq[q]));
    a = __fmul_rn(alpha, am);
    c = __fmul_rn(gamma, cpp);
  }
  if (i == row) {
    const float rb = 1.0f / b;
#pragma unroll
    for (int q = 0; q < 4; ++q) pub[q * lines + g] = __fmul_rn(d[q], rb);
  }
}

template <typename K>
int launch_smem(K kernel, unsigned blocks, unsigned threads, size_t bytes,
                cudaStream_t s, const float* temp, const float* rhs,
                const float* forc, float* pub, int n, long long vs,
                long long lines) {
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<blocks, threads, bytes, s>>>(temp, rhs, forc, pub, n, vs, lines);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch of the stream-kernel probe on ``stream``.  temp, rhs:
// contiguous float32 (4, n, n, n); forc (n, n, n); n a multiple of 8, from
// 32 to 1024.  Modes 0 and 1 write out and tn (4, n, n, n), mode 1 also
// the scratch cp (n, n, n); modes 2-6 write pub (4, n * n).  Returns
// cudaGetLastError().
extern "C" int cmcfs_kernel_probe(const void* temp, const void* rhs,
                                  const void* forc, void* out, void* tn,
                                  void* cp, void* pub, int n, int mode,
                                  void* stream) {
  if (n < kTile || n > 1024 || n % 8 != 0 || mode < 0 || mode > 6)
    return (int)cudaErrorInvalidValue;
  const long long vs = (long long)n * n * n;
  const long long lines = (long long)n * n;
  cudaStream_t s = (cudaStream_t)stream;
  const float* ft = (const float*)temp;
  const float* fr = (const float*)rhs;
  const float* ff = (const float*)forc;
  const unsigned line_blocks =
      (unsigned)((lines + kLineThreads - 1) / kLineThreads);
  const unsigned tile_blocks = (unsigned)(lines / kTile);
  const size_t tile_floats = (size_t)n * kTile * sizeof(float);
  float* fp = (float*)pub;
  switch (mode) {
    case 0:
      dma_kernel<<<line_blocks, kLineThreads, 0, s>>>(
          ft, fr, ff, (float*)out, (float*)tn, n, vs, lines);
      return (int)cudaGetLastError();
    case 1:
      full_kernel<<<line_blocks, kLineThreads, 0, s>>>(
          ft, fr, ff, (float*)out, (float*)tn, (float*)cp, n, vs, lines);
      return (int)cudaGetLastError();
    case 2:
      return launch_smem(comp_kernel<false>, tile_blocks, kTile,
                         2 * tile_floats, s, ft, fr, ff, fp, n, vs, lines);
    case 3:
      return launch_smem(comp_kernel<true>, tile_blocks, kTile,
                         2 * tile_floats, s, ft, fr, ff, fp, n, vs, lines);
    case 4:
      return launch_smem(comps_kernel<false>, tile_blocks, kTile,
                         3 * tile_floats, s, ft, fr, ff, fp, n, vs, lines);
    case 5:
      return launch_smem(comps_kernel<true>, tile_blocks, kTile,
                         6 * tile_floats, s, ft, fr, ff, fp, n, vs, lines);
    default:
      return launch_smem(pcr_kernel, (unsigned)lines, (unsigned)n,
                         (size_t)7 * n * sizeof(float), s, ft, fr, ff, fp, n,
                         vs, lines);
  }
}
