// Native geometry engine: the host-side hot path (per-step scene
// rasterization and mask analysis for animated geometry).
//
// Semantics mirror the validated NumPy implementations in
// cmcfs_tpu/geom/raster2d.py and ops/masks.py (which themselves replicate
// the reference rasterizers, Grid2D.cpp:109-195 / Grid3D.cpp:47-127);
// float32 step arithmetic is kept identical.  Exposed via ctypes
// (cmcfs_tpu/geom/native.py).
#include <cstdint>
#include <cstring>
#include <vector>

namespace {
constexpr int8_t NODE_IN = 0, NODE_OUT = 1, NODE_BOUND = 2, NODE_VALVE = 3;
constexpr int8_t CLS_ID = 0, CLS_BC0 = 1, CLS_BC1 = 2, CLS_INT = 3;
}

extern "C" {

// Rasterize one polyline segment chain with per-vertex velocity
// interpolation (reference RasterLine, Grid2D.cpp:109-141).
// pts/vels: (npts, 2) f32 grid coords; bv_field: (dimx, dimy, 2) or null.
void raster_polyline_2d(int dimx, int dimy, const float* pts, const float* vels,
                        int npts, int8_t color, int bc_noslip, float bc_strength,
                        float start_T, const float* bv_field, int8_t* types,
                        int8_t* bct, float* vel, float* T) {
    for (int seg = 0; seg + 1 < npts; seg++) {
        float p1x = pts[2 * seg], p1y = pts[2 * seg + 1];
        float p2x = pts[2 * seg + 2], p2y = pts[2 * seg + 3];
        float v1x = vels[2 * seg], v1y = vels[2 * seg + 1];
        float v2x = vels[2 * seg + 2], v2y = vels[2 * seg + 3];
        float ox = p2x - p1x, oy = p2y - p1y;
        float aox = ox < 0 ? -ox : ox, aoy = oy < 0 ? -oy : oy;
        int steps = (int)(aox > aoy ? aox : aoy) + 1;
        float dpx = ox / steps, dpy = oy / steps;
        float dvx = (v2x - v1x) / steps, dvy = (v2y - v1y) / steps;
        float px = p1x, py = p1y, vx = v1x, vy = v1y;
        float oo = ox * ox + oy * oy;
        for (int i = 0; i <= steps; i++) {
            int x = (int)px, y = (int)py;
            if (x >= 0 && x < dimx && y >= 0 && y < dimy) {
                long id = (long)x * dimy + y;
                float outx = vx, outy = vy;
                if (!bc_noslip && bv_field && oo != 0.0f) {
                    // tangent/normal blend (Grid2D.cpp:75-81, 131-134)
                    float lv = (vx * ox + vy * oy) / oo;
                    float vtx = ox * lv, vty = oy * lv;
                    float vnx = vx - vtx, vny = vy - vty;
                    float bx = bv_field[2 * id], by = bv_field[2 * id + 1];
                    float lb = (bx * ox + by * oy) / oo;
                    float btx = ox * lb, bty = oy * lb;
                    outx = vnx + btx * bc_strength + vtx * (1.0f - bc_strength);
                    outy = vny + bty * bc_strength + vty * (1.0f - bc_strength);
                }
                types[id] = color;
                bct[id] = 0;  // BC_NOSLIP
                vel[2 * id] = outx;
                vel[2 * id + 1] = outy;
                T[id] = start_T;
            }
            px += dpx; py += dpy; vx += dvx; vy += dvy;
        }
    }
}

// BFS flood fill of the IN-connected component containing (0,0) -> OUT
// (reference Grid2D::FloodFill, Grid2D.cpp:156-195).
void flood_fill_2d(int dimx, int dimy, int8_t* types) {
    std::vector<int> queue;
    queue.reserve((size_t)dimx * dimy);
    types[0] = NODE_OUT;
    if (true) queue.push_back(0);
    const int di[4] = {-1, 1, 0, 0};
    const int dj[4] = {0, 0, -1, 1};
    size_t head = 0;
    // seed only expands if it was IN originally — the reference marks (0,0)
    // unconditionally but expands from it regardless; with padding (0,0) is
    // IN so behaviour matches
    while (head < queue.size()) {
        int id = queue[head++];
        int i = id / dimy, j = id % dimy;
        for (int k = 0; k < 4; k++) {
            int ni = i + di[k], nj = j + dj[k];
            if (ni < 0 || ni >= dimx || nj < 0 || nj >= dimy) continue;
            long nid = (long)ni * dimy + nj;
            if (types[nid] == NODE_IN) {
                types[nid] = NODE_OUT;
                queue.push_back((int)nid);
            }
        }
    }
}

void flood_fill_3d(int dimx, int dimy, int dimz, int8_t* types) {
    std::vector<long> queue;
    queue.reserve((size_t)dimx * dimy * dimz / 4);
    types[0] = NODE_OUT;
    queue.push_back(0);
    const long strides[3] = {(long)dimy * dimz, (long)dimz, 1};
    size_t head = 0;
    while (head < queue.size()) {
        long id = queue[head++];
        int i = (int)(id / strides[0]);
        int j = (int)((id / strides[1]) % dimy);
        int k = (int)(id % dimz);
        const int off[6][3] = {{-1,0,0},{1,0,0},{0,-1,0},{0,1,0},{0,0,-1},{0,0,1}};
        for (int t = 0; t < 6; t++) {
            int ni = i + off[t][0], nj = j + off[t][1], nk = k + off[t][2];
            if (ni < 0 || ni >= dimx || nj < 0 || nj >= dimy || nk < 0 || nk >= dimz)
                continue;
            long nid = ni * strides[0] + nj * strides[1] + nk;
            if (types[nid] == NODE_IN) {
                types[nid] = NODE_OUT;
                queue.push_back(nid);
            }
        }
    }
}

// 2D single-segment-per-line classification (reference
// AdiSolver2D::CreateSegments, AdiSolver2D.cpp:228-277).
// axis: 0 = lines along dim0, 1 = lines along dim1. types/cls: (dimx, dimy).
void line_class_2d(int dimx, int dimy, const int8_t* types, int axis,
                   int8_t* cls) {
    long n_lines = axis == 0 ? dimy : dimx;
    long N = axis == 0 ? dimx : dimy;
    long stride = axis == 0 ? dimy : 1;
    long lstride = axis == 0 ? 1 : dimy;
    std::memset(cls, CLS_ID, (size_t)dimx * dimy);
    for (long l = 0; l < n_lines; l++) {
        const int8_t* t = types + l * lstride;
        int8_t* c = cls + l * lstride;
        long j = 0;
        while (j < N && t[j * stride] == NODE_OUT) j++;
        while (j + 1 < N && t[(j + 1) * stride] != NODE_IN) j++;
        if (j + 1 >= N) continue;
        long start = j;
        j = N - 1;
        while (j >= 0 && t[j * stride] == NODE_OUT) j--;
        while (j - 1 >= 0 && t[(j - 1) * stride] != NODE_IN) j--;
        long end = j;
        if (end < start) continue;
        for (long p = start + 1; p < end; p++) c[p * stride] = CLS_INT;
        c[start * stride] = CLS_BC0;
        c[end * stride] = CLS_BC1;   // start==end -> BC1 wins
    }
}

// 3D multi-run classification (reference Grid3D::GenerateListSegments,
// Grid3D.cpp:47-127).  Writes pass-A classes (END role at dual cells) and,
// when duals exist, pass-B classes + the take-B ownership mask.
// Arrays are contiguous with the sweep running at `stride` within each of
// `n_lines` lines spaced by iterating the other two dims via base offsets.
// To stay layout-agnostic the caller passes explicit line base offsets.
int line_class_3d_lines(long n_lines, long N, long stride,
                        const long* line_base, const int8_t* types,
                        int8_t* cls_a, int8_t* cls_b, int8_t* take_b) {
    int has_dual = 0;
    for (long l = 0; l < n_lines; l++) {
        const int8_t* t = types + line_base[l];
        int8_t* ca = cls_a + line_base[l];
        int8_t* cb = cls_b + line_base[l];
        int8_t* tb = take_b + line_base[l];
        int state = 0;
        long seg_start = -1;
        long prev_end = -2;
        for (long q = 1; q < N; q++) {
            if (t[q * stride] == NODE_IN) {
                if (state == 0) { seg_start = q - 1; state = 1; }
            } else if (state == 1) {
                // close segment [seg_start, q]
                for (long p = seg_start + 1; p < q; p++)
                    ca[p * stride] = cb[p * stride] = CLS_INT;
                bool dual_start = (seg_start == prev_end);
                ca[seg_start * stride] = dual_start ? CLS_BC1 : CLS_BC0;
                cb[seg_start * stride] = CLS_BC0;
                ca[q * stride] = CLS_BC1;
                cb[q * stride] = CLS_BC1;
                if (dual_start) {
                    has_dual = 1;
                    for (long p = seg_start; p <= q; p++) tb[p * stride] = 1;
                }
                prev_end = q;
                state = 0;
            }
        }
    }
    return has_dual;
}

}  // extern "C"
