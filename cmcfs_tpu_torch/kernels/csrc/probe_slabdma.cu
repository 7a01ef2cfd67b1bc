// Slab-copy probe: how fast this card brings a 256^3 float32 array on chip
// in the access patterns the sweep kernels use, for sm_90a.
//
// Replaces: scripts/probe_slabdma.py::make_kernel (body, nested in main),
//   the TPU probe that DMAs the 64 slabs (256, 8, 128) of one array into
//   VMEM, ``depth`` slabs in flight, read three ways: ``strided`` (slab =
//   dense[:, 8jj:8jj+8, 128cc:128cc+128], 2,048 pieces of 512 B),
//   ``fullc`` (dense[:, 8jj:8jj+8, :], 256 pieces of 8 KB, each slab read
//   for both cc) and ``blocked`` (one contiguous 1-MB slab of a
//   (32, 2, 256, 8, 128) copy), and sums acc += slab[0, :, :128] so the
//   copies are not dead.  On the TPU the grid walks the slabs in order on
//   one core.  Here block g of the grid owns plane g of every slab and walks
//   the slabs in the same order, a ring of ``depth`` plane stages (4 KB, or
//   8 KB for fullc) in flight through shared memory with cp.async (16 bytes
//   a thread, L2 only): every byte of every slab passes through shared
//   memory, and the copies are asm volatile, so none can be dropped.  Block
//   g sums out[g] += slab[g, :, :128] in slab order, so every staged plane
//   reaches the output, out[0] is the script's acc, and out equals the
//   plain version bit for bit.
//
//   ``lines`` / ``lines_tiled`` (cmcfs_probe_lines) ask the same question in
//   the card's own terms: one thread per 256-cell line along the contiguous
//   axis (the Z sweeps' access) sums its line, first with direct loads (a
//   warp's load touches 32 lines 1 KB apart), then through a shared-memory
//   transpose of 128 lines x 32 cells loaded as coalesced 128-byte pieces.
//   Same bytes, same sums bit for bit.
//
// What bounds it on this card: bytes.  Every mode reads the 67 MB array
//   once from device memory (0.020 ms at 3.35 TB/s); fullc reads each
//   8-row band again for the next slab, from L2.  Enough
//   bytes must be in flight to cover the memory latency: a block has
//   ``depth`` stages outstanding, and two blocks share an SM.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kS = 8, kL = 128;        // the slab's (sublanes, lanes)
constexpr int kAcc = kS * kL;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Plane p of slab b into ``stage`` (row-major [kS][w]); each thread copies
// chunks tid, tid + kThreads, ... of 4 floats.
__device__ __forceinline__ void issue_stage(const float* __restrict__ x,
                                            float* stage, int n, int mode,
                                            int b, int p, int f4) {
  const int nc = n / kL;
  const int jj = b / nc, cc = b - jj * nc;
  for (int c = threadIdx.x; c < f4; c += kThreads) {
    const float* src;
    if (mode == 0) {
      const int s = c / (kL / 4), l = (c - s * (kL / 4)) * 4;
      src = x + ((long long)p * n + jj * kS + s) * n + cc * kL + l;
    } else if (mode == 1) {
      src = x + ((long long)p * n + jj * kS) * n + 4 * c;
    } else {
      src = x + ((long long)b * n + p) * kAcc + 4 * c;
    }
    cp_async16(stage + 4 * c, src);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
slab_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
            int mode) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  const int w = mode == 1 ? n : kL;          // a stage row's floats
  const int f = kS * w;                      // a stage's floats
  float* acc = ring + D * f;
  const int p = blockIdx.x;
  const int slabs = (n / kS) * (n / kL);
  for (int e = threadIdx.x; e < kAcc; e += kThreads) acc[e] = 0.f;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < D; ++i) {
    if (i < slabs) issue_stage(x, ring + i * f, n, mode, i, p, f / 4);
    cp_async_commit();
  }
  for (int i = 0; i < slabs; ++i) {
    cp_async_wait<D - 1>();
    float* stage = ring + (i % D) * f;
    // a thread reads back only the chunks it copied itself, and owns the
    // acc cells they land on
    for (int c = threadIdx.x; c < f / 4; c += kThreads) {
      const int s = (4 * c) / w, l = 4 * c - s * w;
      if (l < kL) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float* a = acc + s * kL + l + e;
          *a = __fadd_rn(*a, stage[4 * c + e]);
        }
      }
    }
    if (i + D < slabs) issue_stage(x, stage, n, mode, i + D, p, f / 4);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();
  float* o = out + (long long)p * kAcc;
  for (int e = threadIdx.x; e < kAcc; e += kThreads) o[e] = acc[e];
}

template <int D>
int launch_slab(const float* x, float* acc, int n, int mode,
                cudaStream_t s) {
  const int f = kS * (mode == 1 ? n : kL);
  const size_t bytes = (size_t)(D * f + kAcc) * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        slab_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  slab_kernel<D><<<n, kThreads, bytes, s>>>(x, acc, n, mode);
  return (int)cudaGetLastError();
}

constexpr int kTileLines = 128, kTileCells = 32;

__global__ void __launch_bounds__(kTileLines)
lines_kernel(const float* __restrict__ x, float* __restrict__ sums, int n,
             long long lines) {
  const long long t = (long long)blockIdx.x * kTileLines + threadIdx.x;
  if (t >= lines) return;
  const float* line = x + t * n;
  float s = 0.f;
  for (int k = 0; k < n; ++k) s = __fadd_rn(s, line[k]);
  sums[t] = s;
}

__global__ void __launch_bounds__(kTileLines)
lines_tiled_kernel(const float* __restrict__ x, float* __restrict__ sums,
                   int n, long long lines) {
  // [line][cell], padded to 33 so that both the row-wise fill and the
  // column-wise walk hit 32 distinct banks
  __shared__ float tile[kTileLines * (kTileCells + 1)];
  const long long l0 = (long long)blockIdx.x * kTileLines;
  const int tid = threadIdx.x;
  constexpr int kChunks = kTileCells / 4;     // float4 pieces of a line
  float s = 0.f;
  for (int k0 = 0; k0 < n; k0 += kTileCells) {
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {     // 128 lines x 8 pieces
      const int idx = tid + j * kTileLines;
      const int ln = idx / kChunks, ch = idx - ln * kChunks;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (l0 + ln < lines)
        v = *reinterpret_cast<const float4*>(x + (l0 + ln) * n + k0 +
                                             ch * 4);
      float* dst = tile + ln * (kTileCells + 1) + ch * 4;
      dst[0] = v.x;
      dst[1] = v.y;
      dst[2] = v.z;
      dst[3] = v.w;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTileCells; ++k)
      s = __fadd_rn(s, tile[tid * (kTileCells + 1) + k]);
    __syncthreads();
  }
  if (l0 + tid < lines) sums[l0 + tid] = s;
}

}  // namespace

// One launch of the slab-copy probe on ``stream``.  x: contiguous float32,
// dense (n, n, n) for modes 0 (strided) and 1 (fullc), blocked
// (n/8, n/128, n, 8, 128) for mode 2; n a multiple of 128; ``depth`` 1, 2,
// 4 or 8.  out: (n, 8, 128), out[p] the plane-p sum.  Returns
// cudaGetLastError().
extern "C" int cmcfs_probe_slabdma(const void* x, void* out, int n, int mode,
                                   int depth, void* stream) {
  if (n < kL || n % kL != 0 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  const float* fx = (const float*)x;
  float* fa = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (depth) {
    case 1: return launch_slab<1>(fx, fa, n, mode, s);
    case 2: return launch_slab<2>(fx, fa, n, mode, s);
    case 4: return launch_slab<4>(fx, fa, n, mode, s);
    case 8: return launch_slab<8>(fx, fa, n, mode, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One launch of the line-sum probe: sums[t] = sum of x[t*n : t*n + n] in
// order, for ``lines`` contiguous lines of n cells (n a multiple of 32 when
// ``tiled``).  Returns cudaGetLastError().
extern "C" int cmcfs_probe_lines(const void* x, void* sums, int n,
                                 long long lines, int tiled, void* stream) {
  if (n < 1 || lines < 1 || (tiled && n % kTileCells != 0))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (lines + kTileLines - 1) / kTileLines;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (tiled)
    lines_tiled_kernel<<<(unsigned)blocks, kTileLines, 0, s>>>(
        (const float*)x, (float*)sums, n, lines);
  else
    lines_kernel<<<(unsigned)blocks, kTileLines, 0, s>>>(
        (const float*)x, (float*)sums, n, lines);
  return (int)cudaGetLastError();
}
