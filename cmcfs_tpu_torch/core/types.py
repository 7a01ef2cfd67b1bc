"""Core enums and constants.

Mirrors the reference's cell/BC taxonomy (reference: src/Common/Geometry.h:29-43)
with integer codes suitable for dense device arrays.
"""
from __future__ import annotations

import enum

# reference: src/Common/Geometry.h:21-25
FTYPE = "float32"
INF = 1e10
COMP_EPS = 1e-8
BBOX_PADDING = 0.02
MISSING_VALUE = 99999.0

# reference: src/FluidSolver2D/Grid2D.h:31
GRID_SCALE_FACTOR = 0.001


class NodeType(enum.IntEnum):
    """Cell classification (reference: Geometry.h:31-36)."""

    IN = 0
    OUT = 1
    BOUND = 2
    VALVE = 3


class BCtype(enum.IntEnum):
    """Boundary-condition type (reference: Geometry.h:38-41)."""

    NOSLIP = 0  # Dirichlet
    FREE = 1    # linear-extrapolation / symmetry


class Axis(enum.IntEnum):
    """Sweep direction (reference DirType, Geometry.h:43)."""

    X = 0
    Y = 1
    Z = 2


def align_by_32(num: int) -> int:
    """Round up to a multiple of 32 (reference: Geometry.h:564-568)."""
    if (num & 31) == 0:
        return num
    return ((num >> 5) + 1) << 5
