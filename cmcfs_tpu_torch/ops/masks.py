"""Dense per-line row classification — the TPU-native replacement for the
reference's segment machinery.

The reference extracts 1-D "segments" (maximal NODE_IN runs plus their two
boundary endpoints) and solves one small tridiagonal system per segment
(2D: AdiSolver2D.cpp:228-277; 3D: Grid3D.cpp:47-127).  On TPU we instead
solve one full-width tridiagonal system per grid line and classify every cell
into a row type:

  IDENTITY  — not covered by any segment: a=0, b=1, c=0 (decouples blocks,
              the solve returns a don't-care value that is masked out),
  BC0       — segment start endpoint (boundary row, a forced to 0),
  BC1       — segment end endpoint (boundary row, c forced to 0),
  INTERIOR  — PDE coefficient row.

Because a BC0 row has a=0 and a BC1 row has c=0, the Thomas recurrences on a
full line factor into independent per-segment recurrences — the dense solve
is algebraically identical to the reference's per-segment solves, with the
same operation order inside each block.

2D semantics (quirk preserved): exactly one segment per line spanning the
first to the last boundary scan hit; interior rows apply to *all* cells in
between regardless of type (AdiSolver2D.cpp:228-277 builds PDE rows for every
p in [1, n-2]).

3D semantics: proper multi-run extraction; runs touching the domain end are
dropped (the reference's scan never closes them); a single non-IN cell
between two runs serves as BOTH the end of the left segment and the start of
the right segment — we resolve this with a two-pass scheme (cls_a / cls_b)
matching the reference's write order (start-role value wins).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core.types import NodeType

IDENTITY = 0
BC0 = 1
BC1 = 2
INTERIOR = 3


def _move_axis_last(a: np.ndarray, axis: int) -> np.ndarray:
    return np.moveaxis(a, axis, -1)


def line_class_2d(types: np.ndarray, axis: int) -> np.ndarray:
    """Row classes for the 2D single-segment-per-line scan.

    Replicates AdiSolver2D::CreateSegments (AdiSolver2D.cpp:228-277): skip OUT
    from each side, then advance while the next cell is not IN; a line is
    skipped when the low scan runs off the end.
    """
    if types.ndim == 2:
        from ..geom import native
        nat = native.line_class_2d(np.ascontiguousarray(types), axis)
        if nat is not None:
            return nat
    t = _move_axis_last(types, axis)          # (..., N)
    N = t.shape[-1]
    is_in = t == NodeType.IN
    not_out = t != NodeType.OUT

    any_not_out = not_out.any(axis=-1)
    j0 = np.argmax(not_out, axis=-1)          # first non-OUT

    nxt_in = np.zeros_like(is_in)
    nxt_in[..., :-1] = is_in[..., 1:]
    idx = np.arange(N)
    cond_a = nxt_in & (idx >= j0[..., None]) & any_not_out[..., None]
    has_start = cond_a.any(axis=-1)
    start = np.argmax(cond_a, axis=-1)

    j1 = N - 1 - np.argmax(not_out[..., ::-1], axis=-1)
    prv_in = np.zeros_like(is_in)
    prv_in[..., 1:] = is_in[..., :-1]
    cond_b = prv_in & (idx <= j1[..., None]) & any_not_out[..., None]
    has_end = cond_b.any(axis=-1)
    end = N - 1 - np.argmax(cond_b[..., ::-1], axis=-1)

    valid = has_start & has_end & any_not_out & (end >= start)

    cls = np.zeros(t.shape, dtype=np.int8)
    inside = (idx > start[..., None]) & (idx < end[..., None]) & valid[..., None]
    cls[inside] = INTERIOR
    is_start = (idx == start[..., None]) & valid[..., None]
    is_end = (idx == end[..., None]) & valid[..., None]
    cls[is_start] = BC0
    cls[is_end] = BC1          # start==end -> BC1 wins (reference overwrite order)
    return np.moveaxis(cls, -1, axis)


@dataclasses.dataclass
class LineClass3D:
    """3D row classes for one sweep axis (two-pass dual-cell resolution)."""
    cls_a: np.ndarray                 # END role at dual cells
    cls_b: Optional[np.ndarray]       # START role at dual cells (None if no duals)
    take_b: Optional[np.ndarray]      # bool: cells whose value comes from pass B


def line_class_3d(types: np.ndarray, axis: int) -> LineClass3D:
    """Row classes for the 3D multi-run scan (Grid3D.cpp:47-127)."""
    if types.ndim == 3:
        from ..geom import native
        nat = native.line_class_3d(np.ascontiguousarray(types), axis)
        if nat is not None:
            return LineClass3D(cls_a=nat[0], cls_b=nat[1], take_b=nat[2])
    t = _move_axis_last(types, axis)
    N = t.shape[-1]
    is_in = t == NodeType.IN

    # IN runs touching the domain end are never closed by the scan -> dropped
    suffix_all_in = np.zeros_like(is_in)
    suffix_all_in[..., -1] = is_in[..., -1]
    for p in range(N - 2, -1, -1):
        suffix_all_in[..., p] = is_in[..., p] & suffix_all_in[..., p + 1]
    valid_in = is_in & ~suffix_all_in

    nxt_vin = np.zeros_like(valid_in)
    nxt_vin[..., :-1] = valid_in[..., 1:]
    prv_in = np.zeros_like(is_in)
    prv_in[..., 1:] = is_in[..., :-1]

    idx_ge1 = np.ones(N, dtype=bool)
    # start endpoint: next cell begins a (valid) run and this cell is not
    # inside a run itself (or is cell 0)
    not_in_or_first = ~is_in.copy()
    not_in_or_first[..., 0] = True
    start_bc = nxt_vin & not_in_or_first

    # end endpoint: first non-IN after an open run (needs p >= 2: a run at
    # cell 0 alone is never opened by the scan)
    end_bc = (~is_in) & prv_in
    end_bc[..., :2] &= False
    end_bc[..., 2:] &= True
    # run [.., p-1] must have been opened: it was, whenever p-1 >= 1
    del idx_ge1

    dual = start_bc & end_bc
    has_dual = bool(dual.any())

    cls_a = np.zeros(t.shape, dtype=np.int8)
    cls_a[valid_in] = INTERIOR
    # an IN cell at position 0 is never a run interior: the scan opens runs
    # at q>=1, so cell 0 participates only as a BC0 endpoint (Grid3D.cpp:87)
    cls_a[..., 0] = 0
    cls_a[start_bc] = BC0
    cls_a[end_bc] = BC1        # duals take END role in pass A

    cls_b = None
    take_b = None
    if has_dual:
        cls_b = cls_a.copy()
        cls_b[dual] = BC0      # duals take START role in pass B
        # cells whose final value comes from pass B: the dual cells themselves
        # plus every cell of a segment that STARTS at a dual cell
        take = dual.copy()
        for p in range(1, N):
            # propagate along the following run: interiors after a dual start
            take[..., p] = take[..., p] | (take[..., p - 1] & valid_in[..., p])
        # ... and that segment's end endpoint
        take_end = np.zeros_like(take)
        take_end[..., 1:] = take[..., :-1] & end_bc[..., 1:]
        take = take | take_end
        take_b = np.moveaxis(take, -1, axis)
        cls_b = np.moveaxis(cls_b, -1, axis)

    return LineClass3D(cls_a=np.moveaxis(cls_a, -1, axis), cls_b=cls_b, take_b=take_b)
