// ILP probe: do independent carried chains in one thread pipeline on this
// card, or does each chain cost its own serial loop?  For sm_90a.
//
// Replaces: scripts/probe_ilp.py::make_kernel (body, nested in main), the
//   TPU probe that runs K Thomas-like chains new = (d_q[p] - prev*a[p]) *
//   r[p] over (n*nb, 8, 128) slabs either one after another (seq: K row
//   loops) or carried together in one row loop (ilp), both sharing a and r.
//   Here one thread owns one (b, s, l) position of block b and carries its
//   K chains: seq runs K loops of n rows, ilp one loop whose K steps of a
//   row are independent and can overlap their load latency.  The products
//   are rounded before the subtraction (__fmul_rn / __fsub_rn), so both
//   equal the plain PyTorch version, and each other, bit for bit.
//
// What bounds it on this card: latency, unless many threads are in
//   flight.  Compulsory traffic is a and r read once a row and each chain's
//   d read and o written, 8 + 8 K bytes per (row, position): 40 bytes at
//   K = 4 (0.20 ms at 3.35 TB/s for the script's 64 blocks).  seq re-reads
//   a and r for every chain (from L2 once the first chain has passed).  The
//   launch has one thread per position (1,024 per block of rows), so the
//   number of blocks sets the threads in flight: the script's 64 gives
//   65,536, a 2D sweep's launch 1-6 thousand.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <int K, bool kIlp>
__global__ void __launch_bounds__(kThreads)
ilp_kernel(const float* __restrict__ a, const float* __restrict__ r,
           const float* __restrict__ d, float* __restrict__ o, int n,
           int row, long long vs, long long threads) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= threads) return;
  const long long b = t / row;
  const long long base = b * n * (long long)row + (t - b * row);
  if (kIlp) {
    float prev[K];
#pragma unroll
    for (int q = 0; q < K; ++q) prev[q] = 0.f;
    for (int p = 0; p < n; ++p) {
      const long long i = base + (long long)p * row;
      const float av = a[i], rv = r[i];
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const float nw =
            __fmul_rn(__fsub_rn(d[q * vs + i], __fmul_rn(prev[q], av)), rv);
        o[q * vs + i] = nw;
        prev[q] = nw;
      }
    }
  } else {
    for (int q = 0; q < K; ++q) {
      float prev = 0.f;
      for (int p = 0; p < n; ++p) {
        const long long i = base + (long long)p * row;
        prev = __fmul_rn(__fsub_rn(d[q * vs + i], __fmul_rn(prev, a[i])),
                         r[i]);
        o[q * vs + i] = prev;
      }
    }
  }
}

template <int K>
void launch(dim3 grid, cudaStream_t s, int ilp, const float* a,
            const float* r, const float* d, float* o, int n, int row,
            long long vs, long long threads) {
  if (ilp)
    ilp_kernel<K, true><<<grid, kThreads, 0, s>>>(a, r, d, o, n, row, vs,
                                                  threads);
  else
    ilp_kernel<K, false><<<grid, kThreads, 0, s>>>(a, r, d, o, n, row, vs,
                                                   threads);
}

}  // namespace

// One launch of the ILP probe on ``stream``.  a, r: contiguous float32
// (n * nb, row); d, o: (k, n * nb, row); k chains (1, 2, 4 or 8); ``ilp``
// nonzero carries them in one row loop.  Returns cudaGetLastError().
extern "C" int cmcfs_probe_ilp(const void* a, const void* r, const void* d,
                               void* o, int n, int nb, int row, int k,
                               int ilp, void* stream) {
  if (n < 1 || nb < 1 || row < 1) return (int)cudaErrorInvalidValue;
  const long long threads = (long long)nb * row;
  const long long vs = threads * n;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  cudaStream_t s = (cudaStream_t)stream;
  const float* fa = (const float*)a;
  const float* fr = (const float*)r;
  const float* fd = (const float*)d;
  float* fo = (float*)o;
  switch (k) {
    case 1: launch<1>(grid, s, ilp, fa, fr, fd, fo, n, row, vs, threads); break;
    case 2: launch<2>(grid, s, ilp, fa, fr, fd, fo, n, row, vs, threads); break;
    case 4: launch<4>(grid, s, ilp, fa, fr, fd, fo, n, row, vs, threads); break;
    case 8: launch<8>(grid, s, ilp, fa, fr, fd, fo, n, row, vs, threads); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
