// The bf16 entry point of the stream sweep (3D and 2D): the stream mode of
// pair_sweep.cuh's kernel with bf16 payloads, built apart from the other
// entries of that kernel so that they compile in parallel.
#include "pair_sweep.cuh"

// Launch one bf16 stream-sweep iteration: as cmcfs_stream_sweep_iter, with
// rhs, op, out and tn bf16; temp, forcing and scratch float32.  Returns
// cudaGetLastError().
extern "C" int cmcfs_stream_sweep_iter_bf16(
    const void* temp, const void* cls, const void* bcv, const void* bct,
    const void* rhs, const void* op, const void* forcing, void* out,
    void* tn, void* scratch, int nx, int ny, int nz, int axis, int exact,
    int nvars, int axis_var, int first,
    float v_vis_h2, float t_vis_h2, float inv3dt, float inv2h, float v_T,
    void* stream) {
  if (!forcing) return (int)cudaErrorInvalidValue;
  const Scal s{v_vis_h2, t_vis_h2, inv3dt, inv2h, v_T, 0.f, 0.f, 0.f};
  const Mode m{nvars, axis_var, exact, 0, first};
  const Ptrs<PayBf16> a{(const float*)temp, (const int8_t*)cls,
                        (const int8_t*)bcv, (const int8_t*)bct,
                        (const bf16*)rhs, (const bf16*)op,
                        (const float*)forcing, nullptr, (bf16*)out,
                        (bf16*)tn, (float*)scratch};
  return launch<PayBf16, false, true>(a, nx, ny, nz, axis, m, s, stream);
}
