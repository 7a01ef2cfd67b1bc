// In-kernel dissipation probe: does a CUDA kernel's diss_x equal the plain
// PyTorch stencil bit for bit, with and without nvcc's FMA contraction?
// For sm_90a.
//
// Replaces: scripts/probe_diss_bitwise.py (kernel, called through
//   pallas_call at :77), the TPU probe that computes
//   2*ux*ux + vx*vx + wx*wx + vx*uy + wx*uz on one slab in-kernel, with
//   central differences (f[i+1] - f[i-1]) * inv2h whose edge neighbours are
//   clamped, and diffs its bit patterns against stencil.diss_x_3d.  Here one
//   thread computes one cell of an (n0, n1, n2) field (derivatives along
//   axes 0, 1, 2 with the spacings' 1/(2h)), in two builds:
//   ``rounded`` rounds every product and sum in the plain order
//   (__fmul_rn / __fadd_rn, as pair_sweep.cu does), so it equals the plain
//   PyTorch version bit for bit; ``contracted`` is the plain C++
//   expression, which nvcc turns into FMAs.
//
// What bounds it on this card: bytes.  u, v, w read and out written, 16
//   bytes a cell (0.0006 ms at (128, 8, 128), 0.080 ms at 256^3, at
//   3.35 TB/s); the neighbours come from L1 / L2.  Threads run along the
//   contiguous axis, so every load of a warp is one coalesced row.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
diss_kernel(const float* __restrict__ u, const float* __restrict__ v,
            const float* __restrict__ w, float* __restrict__ out, int n0,
            int n1, int n2, float inv2hx, float inv2hy, float inv2hz,
            int rounded) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long cells = (long long)n0 * n1 * n2;
  if (t >= cells) return;
  const int k = (int)(t % n2);
  const int j = (int)((t / n2) % n1);
  const int i = (int)(t / ((long long)n1 * n2));
  const long long s0 = (long long)n1 * n2;
  const long long ip = t + (i < n0 - 1 ? s0 : 0), im = t - (i > 0 ? s0 : 0);
  const long long jp = t + (j < n1 - 1 ? n2 : 0), jm = t - (j > 0 ? n2 : 0);
  const long long kp = t + (k < n2 - 1 ? 1 : 0), km = t - (k > 0 ? 1 : 0);
  float r;
  if (rounded) {
    const float ux = __fmul_rn(__fsub_rn(u[ip], u[im]), inv2hx);
    const float vx = __fmul_rn(__fsub_rn(v[ip], v[im]), inv2hx);
    const float wx = __fmul_rn(__fsub_rn(w[ip], w[im]), inv2hx);
    const float uy = __fmul_rn(__fsub_rn(u[jp], u[jm]), inv2hy);
    const float uz = __fmul_rn(__fsub_rn(u[kp], u[km]), inv2hz);
    r = __fmul_rn(__fmul_rn(2.f, ux), ux);
    r = __fadd_rn(r, __fmul_rn(vx, vx));
    r = __fadd_rn(r, __fmul_rn(wx, wx));
    r = __fadd_rn(r, __fmul_rn(vx, uy));
    r = __fadd_rn(r, __fmul_rn(wx, uz));
  } else {
    const float ux = (u[ip] - u[im]) * inv2hx;
    const float vx = (v[ip] - v[im]) * inv2hx;
    const float wx = (w[ip] - w[im]) * inv2hx;
    const float uy = (u[jp] - u[jm]) * inv2hy;
    const float uz = (u[kp] - u[km]) * inv2hz;
    r = 2.f * ux * ux + vx * vx + wx * wx + vx * uy + wx * uz;
  }
  out[t] = r;
}

}  // namespace

// One launch of the dissipation probe on ``stream``.  u, v, w, out:
// contiguous float32 (n0, n1, n2).  Returns cudaGetLastError().
extern "C" int cmcfs_probe_diss(const void* u, const void* v, const void* w,
                                void* out, int n0, int n1, int n2,
                                float inv2hx, float inv2hy, float inv2hz,
                                int rounded, void* stream) {
  if (n0 < 1 || n1 < 1 || n2 < 1) return (int)cudaErrorInvalidValue;
  const long long cells = (long long)n0 * n1 * n2;
  const long long blocks = (cells + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  diss_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)u, (const float*)v, (const float*)w, (float*)out, n0, n1,
      n2, inv2hx, inv2hy, inv2hz, rounded);
  return (int)cudaGetLastError();
}
