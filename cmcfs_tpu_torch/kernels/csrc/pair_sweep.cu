// The float32 entry points of the pair and stream sweeps: the kernel of
// pair_sweep.cuh with float32 payloads (PayF32); pair_sweep_bf16.cu and
// stream_sweep_bf16.cu have the bf16 ones.
#include "pair_sweep.cuh"

// Launch one pair-sweep iteration on ``stream``.  All fields are
// contiguous (4, nx, ny, nz) float32; masks (nx, ny, nz) int8; ``flags``
// the dual plane (nx, ny, nz) int8 (bit 0: the cell takes the BC0 start
// role in pass B; bit 1: the stitch takes pass B), or null on dual-free
// lines; scratch holds 6 * n * (lines) floats, n the sweep length, twice
// that with flags.  Returns cudaGetLastError().
extern "C" int cmcfs_pair_sweep_iter(
    const void* temp, const void* cls, const void* bcv, const void* bct,
    const void* rhs, const void* op, const void* flags, void* out, void* tn,
    void* scratch, int nx, int ny, int nz, int axis, int exact, int gmerge,
    float v_vis_h2, float t_vis_h2, float inv3dt, float inv2h, float v_T,
    float t_phi, float inv2h_1, float inv2h_2, void* stream) {
  const Scal s{v_vis_h2, t_vis_h2, inv3dt, inv2h, v_T, t_phi, inv2h_1,
               inv2h_2};
  const Mode m{4, axis, exact, gmerge, 0};
  const Ptrs<PayF32> a{(const float*)temp, (const int8_t*)cls,
                       (const int8_t*)bcv, (const int8_t*)bct,
                       (const float*)rhs, (const float*)op, nullptr,
                       (const int8_t*)flags, (float*)out, (float*)tn,
                       (float*)scratch};
  return launch<PayF32, true, false>(a, nx, ny, nz, axis, m, s, stream);
}

// Launch one stream-sweep iteration: as above with the T forcing
// ``forcing`` (nx, ny, nz) float32 = t_phi * diss_axis(temp) and no
// global-merge fold; fields (nvars, nx, ny, nz), scratch (nvars + 2) * n *
// (lines) floats.  3D: nvars 4, axis_var = axis.  2D: nvars 3 on the view
// (1, nx, ny) (the 2D rows and update, ``first``), inv3dt = 1/dt.  Returns
// cudaGetLastError().
extern "C" int cmcfs_stream_sweep_iter(
    const void* temp, const void* cls, const void* bcv, const void* bct,
    const void* rhs, const void* op, const void* forcing, void* out,
    void* tn, void* scratch, int nx, int ny, int nz, int axis, int exact,
    int nvars, int axis_var, int first,
    float v_vis_h2, float t_vis_h2, float inv3dt, float inv2h, float v_T,
    void* stream) {
  if (!forcing) return (int)cudaErrorInvalidValue;
  const Scal s{v_vis_h2, t_vis_h2, inv3dt, inv2h, v_T, 0.f, 0.f, 0.f};
  const Mode m{nvars, axis_var, exact, 0, first};
  const Ptrs<PayF32> a{(const float*)temp, (const int8_t*)cls,
                       (const int8_t*)bcv, (const int8_t*)bct,
                       (const float*)rhs, (const float*)op,
                       (const float*)forcing, nullptr, (float*)out,
                       (float*)tn, (float*)scratch};
  return launch<PayF32, false, true>(a, nx, ny, nz, axis, m, s, stream);
}
