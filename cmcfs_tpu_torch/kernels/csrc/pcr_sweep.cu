// The float32 entry point of the PCR pair sweep: the kernel of
// pcr_sweep.cuh with float32 payloads; pcr_sweep_bf16.cu has the bf16 one.
#include "pcr_sweep.cuh"

// Launch one PCR pair-sweep iteration on ``stream``.  Fields are contiguous
// (4, nx, ny, nz) float32, masks (nx, ny, nz) int8, ``flags`` the dual
// plane (nx, ny, nz) int8 (bit 0: the cell takes the BC0 start role in pass
// B; bit 1: the solution takes pass B) or null; the sweep runs along
// ``axis`` (lines of at most 256 cells).  Returns cudaGetLastError().
extern "C" int cmcfs_pcr_sweep_iter(
    const void* temp, const void* cls, const void* bcv, const void* bct,
    const void* rhs, const void* op, const void* flags, void* out, void* tn,
    int nx, int ny, int nz, int axis, int exact, int gmerge, float v_vis_h2,
    float t_vis_h2, float inv3dt, float inv2h, float v_T, float t_phi,
    float inv2h_1, float inv2h_2, void* stream) {
  const Scal s{v_vis_h2, t_vis_h2, inv3dt, inv2h, v_T, t_phi, inv2h_1,
               inv2h_2};
  const Ptrs<PayF32> a{(const float*)temp, (const int8_t*)cls,
                       (const int8_t*)bcv, (const int8_t*)bct,
                       (const float*)rhs, (const float*)op,
                       (const int8_t*)flags, (float*)out, (float*)tn};
  return launch(a, nx, ny, nz, axis, exact, gmerge, s, stream);
}

// The float32 instantiation of (axis, exact, dual) on lines of n cells:
// registers, local memory, blocks an SM and shared memory into out[0..3]
// (ints).  Returns a CUDA error code.
extern "C" int cmcfs_pcr_sweep_info(int n, int axis, int exact, int dual,
                                    void* out) {
  return kernel_info<PayF32>(n, axis, exact, dual, (int*)out);
}
