// The bf16 entry point of the PCR pair sweep: the kernel of pcr_sweep.cuh
// with bf16 payloads (backend fused_pcr_bf16), built apart from the float32
// entry of pcr_sweep.cu so that the two compile in parallel.
#include "pcr_sweep.cuh"

// Launch one bf16 PCR pair-sweep iteration on ``stream``: as
// cmcfs_pcr_sweep_iter, with rhs (4, nx, ny, nz) bf16; out_prev ``op``
// bf16 and out, tn float32 (op_bf16 1, out_bf16 0: a pair's first
// launch), or op float32 and out, tn bf16 (op_bf16 0, out_bf16 1: its
// second).  Returns cudaGetLastError().
extern "C" int cmcfs_pcr_sweep_iter_bf16(
    const void* temp, const void* cls, const void* bcv, const void* bct,
    const void* rhs, const void* op, const void* flags, void* out, void* tn,
    int nx, int ny, int nz, int axis, int exact, int gmerge, float v_vis_h2,
    float t_vis_h2, float inv3dt, float inv2h, float v_T, float t_phi,
    float inv2h_1, float inv2h_2, int op_bf16, int out_bf16, void* stream) {
  const Scal s{v_vis_h2, t_vis_h2, inv3dt, inv2h, v_T, t_phi, inv2h_1,
               inv2h_2};
  if (op_bf16 && !out_bf16) {
    const Ptrs<PayIn> a{(const float*)temp, (const int8_t*)cls,
                        (const int8_t*)bcv, (const int8_t*)bct,
                        (const bf16*)rhs, (const bf16*)op,
                        (const int8_t*)flags, (float*)out, (float*)tn};
    return launch(a, nx, ny, nz, axis, exact, gmerge, s, stream);
  }
  if (!op_bf16 && out_bf16) {
    const Ptrs<PayOut> a{(const float*)temp, (const int8_t*)cls,
                         (const int8_t*)bcv, (const int8_t*)bct,
                         (const bf16*)rhs, (const float*)op,
                         (const int8_t*)flags, (bf16*)out, (bf16*)tn};
    return launch(a, nx, ny, nz, axis, exact, gmerge, s, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// The bf16 instantiation of (axis, exact, dual) with the payloads of
// (op_bf16, out_bf16), as cmcfs_pcr_sweep_info.  Returns a CUDA error code.
extern "C" int cmcfs_pcr_sweep_info_bf16(int n, int axis, int exact,
                                         int dual, int op_bf16, int out_bf16,
                                         void* out) {
  if (op_bf16 && !out_bf16)
    return kernel_info<PayIn>(n, axis, exact, dual, (int*)out);
  if (!op_bf16 && out_bf16)
    return kernel_info<PayOut>(n, axis, exact, dual, (int*)out);
  return (int)cudaErrorInvalidValue;
}
