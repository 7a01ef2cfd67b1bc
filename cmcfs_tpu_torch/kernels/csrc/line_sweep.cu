// The float32 entry points of the line sweep: the kernel of line_sweep.cuh
// with float32 d and x, and on the fallback iteration's rows;
// line_sweep_bf16.cu has the bf16 one.
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

// Launch one dual-free fallback iteration on ``stream``: temp, rhs,
// out_prev, out and tn contiguous (4, nx, ny, nz) float32 (out and tn
// apart from the inputs), pk the packed code of the sweep's line classes
// and types the node types, (nx, ny, nz) int8, val_* the grid's boundary
// values (nx, ny, nz) float32; scratch as cmcfs_line_sweep's at nvars 4.
// Scalars: the line sweep's four, then v_T, t_phi and 2h of the sweep
// axis and of the two cross axes in axis order.  Returns
// cudaGetLastError().
extern "C" int cmcfs_line_fallback(
    const void* temp, const void* rhs, const void* op, const void* pk,
    const void* types, const void* val_u, const void* val_v,
    const void* val_w, const void* val_T, void* out, void* tn, void* scratch,
    int nx, int ny, int nz, int axis, int exact, float v_vis_h2,
    float t_vis_h2, float inv3dt, float inv2h, float v_T, float t_phi,
    float two_h, float two_h1, float two_h2, void* stream) {
  FallbackRows pol;
  pol.temp = (const float*)temp;
  pol.rhs = (const float*)rhs;
  pol.op = (const float*)op;
  pol.val[0] = (const float*)val_u;
  pol.val[1] = (const float*)val_v;
  pol.val[2] = (const float*)val_w;
  pol.val[3] = (const float*)val_T;
  pol.pk = (const int8_t*)pk;
  pol.types = (const int8_t*)types;
  pol.tn = (float*)tn;
  pol.s = {v_vis_h2, t_vis_h2, inv3dt, inv2h};
  pol.fb = {v_T, t_phi, two_h, two_h1, two_h2};
  return launch_fallback(pol, out, scratch, nx, ny, nz, axis, exact,
                         stream);
}
