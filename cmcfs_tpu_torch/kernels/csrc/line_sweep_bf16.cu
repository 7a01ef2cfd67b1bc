// The bf16 entry point of the line sweep: the kernel of line_sweep.cuh with
// bf16 d and x (the bf16 payload mode), built apart from the float32 entry
// of line_sweep.cu so that the two compile in parallel.
#include "line_sweep.cuh"

// Launch one line sweep on ``stream``: as cmcfs_line_sweep, with d4 and x4
// contiguous (nvars, nx, ny, nz) bf16.  Returns cudaGetLastError().
extern "C" int cmcfs_line_sweep_bf16(const void* adv, const void* pk,
                                     const void* d4, void* x4, void* scratch,
                                     int nx, int ny, int nz, int axis,
                                     int exact, int nvars, int z_rows,
                                     float v_vis_h2, float t_vis_h2,
                                     float inv3dt, float inv2h,
                                     void* stream) {
  return launch_lines<__nv_bfloat16>(adv, pk, d4, x4, scratch, nx, ny, nz,
                                     axis, exact, nvars, z_rows,
                                     {v_vis_h2, t_vis_h2, inv3dt, inv2h},
                                     stream);
}
