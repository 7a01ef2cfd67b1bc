"""Result writers matching the reference output formats.

* 3D: real NetCDF with the reference's COARDS header layout
  (src/Common/IO.h:136-276) and per-record variable appends (:350-388),
  written via our from-scratch classic-NetCDF backend (io/netcdf3.py).
* 2D: textual NetCDF-CDL stream (:278-348, 390-408) and the legacy MultiVox
  format (:89-117).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .netcdf3 import NetCDF3Writer, NC_FLOAT, NC_DOUBLE, NC_CHAR
from ..core.types import MISSING_VALUE

_VAR_SHORT = ["u", "v", "w", "T", "d"]
_VAR_LONG = ["x-velocity", "y-velocity", "z-velocity", "temperature", "depth"]


class NetCDF3DOutput:
    """COARDS NetCDF result file: header once, per-frame appends."""

    def __init__(self, path: str, bbox_min, bbox_max, timestep: float,
                 total_time: float, outdimx: int, outdimy: int, outdimz: int,
                 out_vars: Sequence[str], xy_degree_units: bool = False,
                 depths: Optional[np.ndarray] = None, append: bool = False):
        self.path = path
        self.out_vars = list(out_vars)
        self.dims = (outdimx, outdimy, outdimz)
        use = [v in self.out_vars for v in _VAR_SHORT]

        w = NetCDF3Writer(path, {"x": outdimx, "y": outdimy, "z": outdimz, "t": None},
                          gattrs={
                              "Conventions": (NC_CHAR, "COARDS"),
                              "title": (NC_CHAR, "cmc-fluid-solver results"),
                              "history": (NC_CHAR, "created by using cmc-fluid-solver"),
                              "description": (NC_CHAR, "Test data"),
                              "platform": (NC_CHAR, "Model"),
                          })
        units = ("degree_north", "degree_east") if xy_degree_units else ("metres", "metres")
        w.def_var("x", NC_FLOAT, ["x"], {
            "actual_range": (NC_FLOAT, [bbox_min[0], bbox_max[0]]),
            "long_name": (NC_CHAR, "x coord"),
            "units": (NC_CHAR, units[0])})
        w.def_var("y", NC_FLOAT, ["y"], {
            "actual_range": (NC_FLOAT, [bbox_min[1], bbox_max[1]]),
            "long_name": (NC_CHAR, "y coord"),
            "units": (NC_CHAR, units[1])})
        w.def_var("z", NC_FLOAT, ["z"], {
            "units": (NC_CHAR, "metres"),
            "actual_range": (NC_FLOAT, [bbox_min[2], bbox_max[2]]),
            "long_name": (NC_CHAR, "z coord")})
        w.def_var("time", NC_DOUBLE, ["t"], {
            "units": (NC_CHAR, "s"),
            "actual_range": (NC_DOUBLE, [0.0, total_time]),
            "long_name": (NC_CHAR, "time")})
        for i, short in enumerate(_VAR_SHORT):
            if not use[i]:
                continue
            attrs = {
                "units": (NC_CHAR, {"T": "tmp", "d": "m"}.get(short, "m/s")),
                "actual_range": (NC_DOUBLE, [-1.0, 1.0]),
                "valid_range": (NC_DOUBLE, [-1.0, 1.0]),
                "missing_value": (NC_FLOAT, [MISSING_VALUE]),
                "long_name": (NC_CHAR, _VAR_LONG[i]),
                "var_desc": (NC_CHAR, short),
            }
            if short == "d":
                w.def_var("d", NC_FLOAT, ["x", "y"], attrs)
            else:
                w.def_var(short, NC_DOUBLE, ["t", "x", "y", "z"], attrs)
        if append:
            # resume: reopen the partially-written file and keep its records
            w.open_append()
            self.w = w
            return
        w.create()
        self.w = w

        ddx = (bbox_max[0] - bbox_min[0]) / outdimx
        ddy = (bbox_max[1] - bbox_min[1]) / outdimy
        ddz = (bbox_max[2] - bbox_min[2]) / outdimz
        w.put_var("x", bbox_min[0] + ddx * np.arange(outdimx))
        w.put_var("y", bbox_min[1] + ddy * np.arange(outdimy))
        w.put_var("z", bbox_min[2] + ddz * np.arange(outdimz))
        n_t = int(total_time / timestep)
        for i in range(n_t):
            w.put_record("time", i, np.array([i * timestep]))
        if "d" in self.out_vars and depths is not None:
            # resample depths to the output grid (DepthInfo3D filter ctor,
            # Geometry.h:429-441)
            dx_in, dy_in = depths.shape
            xi = (np.arange(outdimx) * dx_in) // outdimx
            yi = (np.arange(outdimy) * dy_in) // outdimy
            w.put_var("d", depths[np.ix_(xi, yi)])

    def write_layer(self, rec: int, u, v, wv, T) -> None:
        """Append one output frame (reference OutputNetCDF3D_layer)."""
        data = {"u": u, "v": v, "w": wv, "T": T}
        for var in self.out_vars:
            if var == "d":
                continue
            self.w.put_record(var, rec, np.asarray(data[var], dtype=np.float64))


# ------------------------------------------------------------------ 2D CDL
def output_netcdf_header_2d(path: str, bbox_min, bbox_max, timestep: float,
                            total_time: float, outdimx: int, outdimy: int) -> None:
    """Textual CDL header (reference OutputNetCDFHeader2D, IO.h:278-348)."""
    with open(path, "w") as f:
        f.write("netcdf 2d_scalar_time_array {\n")
        f.write("dimensions:\n")
        f.write("\tx = %i ;\n" % outdimx)
        f.write("\ty = %i ;\n" % outdimy)
        f.write("\ttime = UNLIMITED ;\n")
        f.write("variables:\n")
        f.write("\tfloat x(x) ;\n")
        f.write('\t\tx:units = "metres" ;\n')
        f.write("\t\tx:actual_range = %.2ff, %.2ff ;\n" % (bbox_min[0], bbox_max[0]))
        f.write('\t\tx:long_name = "X coordinate" ;\n')
        f.write("\tfloat y(y) ;\n")
        f.write('\t\ty:units = "metres" ;\n')
        f.write("\t\ty:actual_range = %.2ff, %.2ff ;\n" % (bbox_min[1], bbox_max[1]))
        f.write('\t\ty:long_name = "Y coordinate" ;\n')
        f.write("\tdouble time(time) ;\n")
        f.write('\t\ttime:units = "s" ;\n')
        f.write("\t\ttime:actual_range = 0.f, %.2ff ;\n" % total_time)
        f.write('\t\ttime:long_name = "Time" ;\n')
        f.write("\tdouble u(time, x, y) ;\n")
        f.write('\t\tu:units = "m/s" ;\n')
        f.write("\t\tu:actual_range = 0.f, 1.f ;\n")
        f.write("\t\tu:valid_range = 0.f, 1.f ;\n")
        f.write('\t\tu:long_name = "U velocity" ;\n')
        f.write("\t\tu:scale_factor =  1.f ;\n")
        f.write('\t\tu:var_desc = "U velocity",\n\t\t\t"U" ; \n')
        f.write("\t// global attributes\n")
        f.write('\t:Conventions = "COARDS" ;\n')
        f.write('\t:title = "2D Time U velocity data from FluidSolver2D'
                ' (http://code.google.com/p/cmc-fluid-solver/)" ;\n')
        f.write('\t:history = "created by using FluidSolver2D library" ;\n')
        f.write('\t:description = "Test data" ;\n')
        f.write('\t:platform = "Model" ;\n')
        f.write("data:\n")
        ddx = (bbox_max[0] - bbox_min[0]) / outdimx
        ddy = (bbox_max[1] - bbox_min[1]) / outdimy
        f.write("x = ")
        for i in range(outdimx - 1):
            f.write("%.2f, " % (bbox_min[0] + ddx * i))
        f.write("%.2f ;\n" % (bbox_min[0] + ddx * outdimx))
        f.write("y = ")
        for i in range(outdimy - 1):
            f.write("%.2f, " % (bbox_min[1] + ddy * i))
        f.write("%.2f ;\n" % (bbox_min[1] + ddy * outdimy))
        f.write("time = ")
        cur = 0.0
        while cur < total_time:
            f.write("%.2f, " % cur)
            cur += timestep
        f.write("%.2f ;\n" % total_time)
        f.write("u = \n")


def output_netcdf_2d_u(path: str, u: np.ndarray, finish: bool) -> None:
    """Append one u frame to the CDL stream (IO.h:390-408)."""
    dimx, dimy = u.shape
    with open(path, "a") as f:
        for i in range(dimx):
            row = []
            for j in range(dimy):
                val = "%.3f" % u[i, j]
                if finish and i == dimx - 1 and j == dimy - 1:
                    row.append(val + " ; ")
                else:
                    row.append(val + ", ")
            f.write("".join(row) + "\n")
        if finish:
            f.write("}")


# --------------------------------------------------------------- MultiVox
def output_multivox_header(path: str, bbox_min, bbox_max, outdimx: int,
                           outdimy: int) -> None:
    """Legacy MultiVox text header (IO.h:89-101), millimetre units."""
    with open(path, "w") as f:
        f.write("%.2f %.2f %.2f %.2f\n" % (bbox_min[0] * 1000, bbox_min[1] * 1000,
                                           bbox_max[0] * 1000, bbox_max[1] * 1000))
        ddx = (bbox_max[0] - bbox_min[0]) / outdimx
        ddy = (bbox_max[1] - bbox_min[1]) / outdimy
        f.write("%.2f %.2f %i %i\n" % (ddx * 1000, ddy * 1000, outdimx, outdimy))


def output_multivox_frame_marker(path: str, frame: int) -> None:
    with open(path, "a") as f:
        f.write("Frame %i\n" % frame)


def output_multivox(path: str, u: np.ndarray, v: np.ndarray, time_value: float) -> None:
    """Velocity frame, x10 scaling, y-major rows (IO.h:103-117)."""
    dimx, dimy = u.shape
    with open(path, "a") as f:
        f.write("%.5f\n" % time_value)
        for j in range(dimy):
            f.write("".join("%.2f %.2f " % (u[i, j] * 10, v[i, j] * 10)
                            for i in range(dimx)) + "\n")


def output_slice_result(path: str, z: int, u3, v3, time_value: float) -> None:
    """Z-slice of the 3D velocity projected onto XY, MultiVox-style text
    (reference OutputSliceResult, IO.h:120-134)."""
    import numpy as np
    u = np.asarray(u3)
    v = np.asarray(v3)
    dimx, dimy = u.shape[0], u.shape[1]
    with open(path, "a") as f:
        f.write("%.5f\n" % time_value)
        for j in range(dimy):
            f.write("".join("%.2f %.2f " % (u[i, j, z] * 10, v[i, j, z] * 10)
                            for i in range(dimx)) + "\n")
