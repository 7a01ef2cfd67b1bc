"""The FREE-bc baffle geometry: a lid cavity with a pierced wall.

A one-cell wall of BOUND cells at mid-X with FREE temperature BC, pierced
by a two-cell hole of IN cells along Y, splits every X line through it
into two fluid runs that share the wall cell as an endpoint: a FREE dual
endpoint, which survives the inert-dual elision (models/common3d.py).
The geometry of cmcfs_tpu's ``tests/test_duals.py::_free_baffled``, the
class of the reference's own baffle cases (``__graft_entry__.py:24-36``);
the port's CPU tests, GPU tests, ``chip_smoke.py`` and ``profile3d``
build it here.
"""
from __future__ import annotations

import numpy as np

from ..core.types import BCtype, NodeType
from .synthetic import lid_cavity_3d


def free_baffled(nx: int, ny: int, nz: int):
    """``lid_cavity_3d(nx, ny, nz)`` with the FREE baffle at x = nx // 2."""
    grid = lid_cavity_3d(nx, ny, nz)
    mid = nx // 2
    grid.types[mid, 2:-2, 2:-2] = NodeType.BOUND
    grid.types[mid, ny // 2 - 1:ny // 2 + 1, 2:-2] = NodeType.IN
    baffle = np.zeros(grid.types.shape, dtype=bool)
    baffle[mid, 2:-2, 2:-2] = True
    baffle &= np.asarray(grid.types) == NodeType.BOUND
    grid.bc_temp[baffle] = BCtype.FREE
    return grid
