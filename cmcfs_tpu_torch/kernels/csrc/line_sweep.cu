// The float32 entry point of the line sweep: the kernel of line_sweep.cuh
// with float32 d and x; line_sweep_bf16.cu has the bf16 one.
#include "line_sweep.cuh"

// Launch one line sweep on ``stream``.  adv (nx, ny, nz) float32, pk
// (nx, ny, nz) int8, d4 and x4 contiguous (nvars, nx, ny, nz) float32;
// scratch holds (nvars + 2) * n * scratch_lines floats (walk.cuh), n the
// sweep length, the lines (i1, i2) over the other two axes in order; the
// last variable (T) takes t_vis and the bc_temp bit, the others v_vis and
// the bc_vel bit; nvars 3 (2D, on the view (1, nx, ny)) selects the 2D
// FREE rows and the 2D tile.  z_rows names the 3D Z tile by its rows (0:
// kZR's); other axes and 2D take 0.  Returns cudaGetLastError().
extern "C" int cmcfs_line_sweep(const void* adv, const void* pk,
                                const void* d4, void* x4, void* scratch,
                                int nx, int ny, int nz, int axis, int exact,
                                int nvars, int z_rows, float v_vis_h2,
                                float t_vis_h2, float inv3dt, float inv2h,
                                void* stream) {
  return launch_lines<float>(adv, pk, d4, x4, scratch, nx, ny, nz, axis,
                             exact, nvars, z_rows,
                             {v_vis_h2, t_vis_h2, inv3dt, inv2h}, stream);
}
