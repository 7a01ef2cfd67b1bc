// The bf16 entry point of the pair sweep: the kernel of pair_sweep.cuh with
// bf16 payloads (its bf16 mode), built apart from the float32 entries of
// pair_sweep.cu and the bf16 stream entry of stream_sweep_bf16.cu so that
// the three compile in parallel.
#include "pair_sweep.cuh"

// Launch one bf16 pair-sweep iteration on ``stream``: as
// cmcfs_pair_sweep_iter, with rhs (4, nx, ny, nz) bf16; out_prev ``op``
// bf16 and out, tn float32 (op_bf16 1, out_bf16 0: a pair's first
// launch), or op float32 and out, tn bf16 (op_bf16 0, out_bf16 1: its
// second).  temp, the masks, flags and scratch as there.  Returns
// cudaGetLastError().
extern "C" int cmcfs_pair_sweep_iter_bf16(
    const void* temp, const void* cls, const void* bcv, const void* bct,
    const void* rhs, const void* op, const void* flags, void* out, void* tn,
    void* scratch, int nx, int ny, int nz, int axis, int exact, int gmerge,
    float v_vis_h2, float t_vis_h2, float inv3dt, float inv2h, float v_T,
    float t_phi, float inv2h_1, float inv2h_2, int op_bf16, int out_bf16,
    void* stream) {
  const Scal s{v_vis_h2, t_vis_h2, inv3dt, inv2h, v_T, t_phi, inv2h_1,
               inv2h_2};
  const Mode m{4, axis, exact, gmerge, 0};
  if (op_bf16 && !out_bf16) {
    const Ptrs<PayIn> a{(const float*)temp, (const int8_t*)cls,
                        (const int8_t*)bcv, (const int8_t*)bct,
                        (const bf16*)rhs, (const bf16*)op, nullptr,
                        (const int8_t*)flags, (float*)out, (float*)tn,
                        (float*)scratch};
    return launch<PayIn, true, false>(a, nx, ny, nz, axis, m, s, stream);
  }
  if (!op_bf16 && out_bf16) {
    const Ptrs<PayOut> a{(const float*)temp, (const int8_t*)cls,
                         (const int8_t*)bcv, (const int8_t*)bct,
                         (const bf16*)rhs, (const float*)op, nullptr,
                         (const int8_t*)flags, (bf16*)out, (bf16*)tn,
                         (float*)scratch};
    return launch<PayOut, true, false>(a, nx, ny, nz, axis, m, s, stream);
  }
  return (int)cudaErrorInvalidValue;
}
