"""The lid-driven cubic cavity, run by the 3D ADI solver.

The port's grid is the port's own synthetic cavity
(``geom/synthetic.lid_cavity_3d``: an OUT border, a no-slip wall shell,
the top wall plane a valve moving along X), with the lid's temperature
set to the configuration's and, where the configuration asks for it, the
FREE-temperature baffle of ``geom/baffle.py`` placed as that module
places it.  The wall planes' nodes lie ``side`` apart, so a cavity of
n^3 cells has the spacing ``side / (n - 3)`` and its Reynolds number is
``lid_velocity * side * Re`` in the port's normalized units (viscosity
1 / Re).  The reference builds the same cavity with NumPy
(``reference/grid.lid_cavity_grid``).
"""
from __future__ import annotations

import numpy as np

from portbench.kinds import _adi3d
from portbench.reference import grid as rgrid


def build(cfg: dict, traffic: dict, device, seed: int, shape=None,
          control: bool = False, devices=None) -> _adi3d.Case:
    """The cell's case at the traffic's ``grid_n`` cells a side, or at
    ``shape`` (a rehearsal), on ``devices`` (the cell's cards; ``device``
    alone where none are given), X split into the traffic's ``shards``
    (default 1) with its ``nblockz`` (default 0)."""
    from cmcfs_tpu_torch.core.params import FluidParams
    from cmcfs_tpu_torch.core.types import BCtype, NodeType
    from cmcfs_tpu_torch.geom.synthetic import lid_cavity_3d

    shape = tuple(shape or (traffic["grid_n"],) * 3)
    nx, ny, nz = shape
    dx = cfg["side"] / (nz - 3)
    grid = lid_cavity_3d(nx, ny, nz, dx, cfg["lid_velocity"],
                         cfg["base_T"])
    grid.T[grid.types == NodeType.VALVE] = np.float32(cfg["lid_T"])
    if cfg["baffle"]:
        mid = nx // 2
        grid.types[mid, 2:-2, 2:-2] = NodeType.BOUND
        grid.types[mid, ny // 2 - 1:ny // 2 + 1, 2:-2] = NodeType.IN
        wall = np.zeros(shape, dtype=bool)
        wall[mid, 2:-2, 2:-2] = True
        grid.bc_temp[wall & (grid.types == NodeType.BOUND)] = BCtype.FREE
    params = FluidParams.normalized(cfg["Re"], cfg["Pr"], cfg["lambda"])

    def reference():
        g = rgrid.lid_cavity_grid(shape, cfg["side"] / (shape[2] - 3),
                                  cfg["lid_velocity"], cfg["base_T"],
                                  cfg["lid_T"], cfg["baffle"])
        return (g, rgrid.normalized(cfg["Re"], cfg["Pr"], cfg["lambda"]),
                cfg["dt"], cfg["num_global"], cfg["num_local"])

    return _adi3d.Case(grid, params, cfg["dt"], cfg["num_global"],
                       cfg["num_local"], traffic["backend"],
                       devices or [device], seed, control, reference,
                       traffic.get("shards", 1), traffic.get("nblockz", 0))
