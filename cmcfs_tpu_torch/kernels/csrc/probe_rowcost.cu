// Row-cost probe: what one serial row step of a Thomas-like carried chain
// costs on this card, for sm_90a.
//
// Replaces: scripts/probe_rowcost.py::make_kernel (body, nested in main),
//   the TPU probe that times o[p] = (d[p] - o[p-1]*a[p]) * r[p] along the
//   n rows of (n*nb, sub, lanes) float32 slabs at several slab widths.  On
//   the TPU each grid step DMAs one block's n rows into VMEM and walks them;
//   here one thread carries one chain (b, s, l) of block b, so the serial
//   row loop is each thread's own and all chains run at once.
//
// Variants (the ``mode`` and ``K`` of cmcfs_probe_rowcost):
//   rounded (K = 1, 2, 4): base (8, 128), wide_j (16, 128), wide_l
//     (8, 256), wide4 (8, 512).  A thread carries K chains of one block,
//     interleaved in one row loop: chain c0 + k * (row / K), so the 32
//     threads of a warp read 32 neighbouring floats, one 128-byte row
//     piece, for each chain of a row step (the X sweeps' layout).
//   fma: base with nvcc's mul-sub contraction, d - prev*a as one FMA; the
//     others round the product first (__fmul_rn / __fsub_rn), as the
//     production kernels and the plain PyTorch version do, and equal that
//     version bit for bit.  fma prices the explicit rounding.
//   noload: a, r, d read once from row 0, then n dependent steps on them
//     and only row 0 written: the serial floor of a step.
//   strided: base's chains on a chain-major copy (nb, row, n), so each
//     thread walks contiguous memory and a warp's row step touches 32
//     separate 32-byte sectors, each serving 8 rows from L1 (the Y and Z
//     sweeps' layout).
//
// What bounds it on this card: latency.  Compulsory traffic is a, r, d read
//   and o written, 16 bytes a cell (16.8 M cells at the script's defaults:
//   0.080 ms at 3.35 TB/s), but every row step waits on the previous one,
//   so a thread issues one dependent step per memory round trip; the card
//   hides that only with enough chains in flight.  The launch has one
//   thread per K chains, so the number of threads is the experiment's
//   variable (``--chains`` sweeps it).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

// K chains per thread; ``row`` floats per row (sub * lanes) and ``per``
// threads per block of rows (row / K).
template <int K, bool kFma>
__global__ void __launch_bounds__(kThreads)
rowcost_kernel(const float* __restrict__ a, const float* __restrict__ r,
               const float* __restrict__ d, float* __restrict__ o, int n,
               int row, int per, long long threads) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= threads) return;
  const long long b = t / per;
  const long long base = b * n * (long long)row + (t - b * per);
  float prev[K];
#pragma unroll
  for (int k = 0; k < K; ++k) prev[k] = 0.f;
  for (int p = 0; p < n; ++p) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const long long i = base + (long long)p * row + k * per;
      float nw;
      if (kFma) {
        nw = (d[i] - prev[k] * a[i]) * r[i];
      } else {
        nw = __fmul_rn(__fsub_rn(d[i], __fmul_rn(prev[k], a[i])), r[i]);
      }
      o[i] = nw;
      prev[k] = nw;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
rowcost_noload_kernel(const float* __restrict__ a, const float* __restrict__ r,
                      const float* __restrict__ d, float* __restrict__ o,
                      int n, int row, long long threads) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= threads) return;
  const long long b = t / row;
  const long long i = b * n * (long long)row + (t - b * row);
  const float a0 = a[i], r0 = r[i], d0 = d[i];
  float prev = 0.f;
  for (int p = 0; p < n; ++p) {
    prev = __fmul_rn(__fsub_rn(d0, __fmul_rn(prev, a0)), r0);
  }
  o[i] = prev;
}

// Chain-major layout: chain t's rows at t * n + p.
__global__ void __launch_bounds__(kThreads)
rowcost_strided_kernel(const float* __restrict__ a,
                       const float* __restrict__ r,
                       const float* __restrict__ d, float* __restrict__ o,
                       int n, long long threads) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= threads) return;
  const long long base = t * n;
  float prev = 0.f;
  for (int p = 0; p < n; ++p) {
    const long long i = base + p;
    prev = __fmul_rn(__fsub_rn(d[i], __fmul_rn(prev, a[i])), r[i]);
    o[i] = prev;
  }
}

}  // namespace

// One launch of the row-cost probe on ``stream``.  a, r, d, o: contiguous
// float32, (n * nb, row) for modes 0 (rounded), 1 (fma) and 2 (noload),
// (nb * row, n) chain-major for mode 3 (strided).  ``k`` chains per thread:
// 1, 2 or 4 for modes 0 and 1 (row % k == 0), 1 otherwise.  Returns
// cudaGetLastError().
extern "C" int cmcfs_probe_rowcost(const void* a, const void* r,
                                   const void* d, void* o, int n, int nb,
                                   int row, int k, int mode, void* stream) {
  if (n < 1 || nb < 1 || row < 1 || k < 1 || row % k != 0 || mode < 0 ||
      mode > 3 || (mode >= 2 && k != 1))
    return (int)cudaErrorInvalidValue;
  const long long threads = (long long)nb * row / k;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  cudaStream_t s = (cudaStream_t)stream;
  const float* fa = (const float*)a;
  const float* fr = (const float*)r;
  const float* fd = (const float*)d;
  float* fo = (float*)o;
  const int per = row / k;
  if (mode == 2) {
    rowcost_noload_kernel<<<grid, kThreads, 0, s>>>(fa, fr, fd, fo, n, row,
                                                    threads);
  } else if (mode == 3) {
    rowcost_strided_kernel<<<grid, kThreads, 0, s>>>(fa, fr, fd, fo, n,
                                                     threads);
  } else if (mode == 1) {
    if (k != 1) return (int)cudaErrorInvalidValue;
    rowcost_kernel<1, true><<<grid, kThreads, 0, s>>>(fa, fr, fd, fo, n, row,
                                                      per, threads);
  } else if (k == 1) {
    rowcost_kernel<1, false><<<grid, kThreads, 0, s>>>(fa, fr, fd, fo, n,
                                                       row, per, threads);
  } else if (k == 2) {
    rowcost_kernel<2, false><<<grid, kThreads, 0, s>>>(fa, fr, fd, fo, n,
                                                       row, per, threads);
  } else if (k == 4) {
    rowcost_kernel<4, false><<<grid, kThreads, 0, s>>>(fa, fr, fd, fo, n,
                                                       row, per, threads);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
