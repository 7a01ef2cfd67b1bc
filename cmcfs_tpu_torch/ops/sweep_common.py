"""Tridiagonal row build from the line-class and BC masks.

Port of ``cmcfs_tpu/ops/sweep_common.py``: ``build_abc``/``build_a`` with
the 3D boundary rows and the 2D (``bc2d``) ones, and the packed-mask
encoding.  The dual encoding is the pair kernels' own int8 plane
(``models/common3d.dual_flags``); pass B's classes are their own array,
``models/common3d.GridArrays3D.cls_b``.
"""
from __future__ import annotations

import torch

from .masks import BC0, BC1, INTERIOR


def pack_masks(cls, bcv, bct) -> torch.Tensor:
    """One int8 code per cell: cls + 4*bc_vel + 8*bc_temp (0..15), the
    values cmcfs_tpu packs into float32.  Built once per grid and axis
    (``models/common3d.grid_arrays``), read by the line-sweep kernel."""
    return cls + 4 * bcv + 8 * bct


def decode_pk(pk):
    """Invert ``pack_masks`` with floor arithmetic: (cls, bcv, bct) as
    float32, as cmcfs_tpu decodes its float codes."""
    pk = pk.to(torch.float32)
    bct = torch.floor(pk * 0.125)
    r8 = pk - 8.0 * bct
    bcv = torch.floor(r8 * 0.25)
    cls = r8 - 4.0 * bcv
    return cls, bcv, bct


def build_abc(cls, free, adv_2h, vis, b_int, bc2d: bool = False):
    """Row coefficients (a, b, c).

    Interior rows: a = -q/(2h) - nu/h^2, b = b_int, c = q/(2h) - nu/h^2
    (BuildMatrix, AdiSolver3D.cpp:732-802 / AdiSolver2D.cpp:118-178).
    Boundary rows: Dirichlet identity, or the FREE forms: 3D linear
    extrapolation (2, -1 | -1, 2) rows (ApplyBC0/1, AdiSolver3D.cpp:804-852),
    2D difference rows x0 - x1 = 0 (1, -1 | +1, -1; ``bc2d``,
    AdiSolver2D.cpp:74-116).  Identity rows elsewhere."""
    interior = cls == INTERIOR
    is_bc0 = cls == BC0
    is_bc1 = cls == BC1
    zero = torch.zeros((), dtype=adv_2h.dtype, device=adv_2h.device)
    a = build_a(cls, free, adv_2h, vis, bc2d)
    if bc2d:
        b = torch.where(interior, b_int,
                        torch.where(is_bc1, torch.where(free, -1.0, 1.0),
                                    1.0 + zero))
    else:
        b = torch.where(interior, b_int,
                        torch.where(is_bc0 | is_bc1,
                                    torch.where(free, 2.0, 1.0), 1.0 + zero))
    c = torch.where(interior, adv_2h - vis,
                    torch.where(is_bc0, torch.where(free, -1.0, 0.0), zero))
    return a, b, c


def build_a(cls, free, adv_2h, vis, bc2d: bool = False):
    """Just the sub-diagonal."""
    zero = torch.zeros((), dtype=adv_2h.dtype, device=adv_2h.device)
    a_free = 1.0 if bc2d else -1.0
    return torch.where(cls == INTERIOR, -adv_2h - vis,
                       torch.where(cls == BC1,
                                   torch.where(free, a_free, 0.0), zero))
