"""Debug mask dumps: BMP slices and ASCII art.

Visual-observability parity with the reference (Grid2D::OutputImage
Grid2D.cpp:548-590, Grid3D::OutputImage Grid3D.cpp:1112-1173,
Grid3D::TestPrint :1077-1110).  We write standard well-formed 24-bit BMPs.
"""
from __future__ import annotations

import os
import struct

import numpy as np

from ..core.types import NodeType

# BGR colors per node type (reference palette)
_COLORS = {
    int(NodeType.IN): (245, 73, 69),
    int(NodeType.OUT): (0, 0, 0),
    int(NodeType.BOUND): (255, 255, 255),
    int(NodeType.VALVE): (241, 41, 212),
}

_CHARS = {int(NodeType.IN): " ", int(NodeType.OUT): ".",
          int(NodeType.BOUND): "#", int(NodeType.VALVE): "+"}


def mask_to_bmp(types2d: np.ndarray, path: str, flip_rows: bool = False) -> None:
    """Write a (dimx, dimy) type mask as a 24-bit BMP (one pixel per cell)."""
    h, w = types2d.shape
    img = np.zeros((h, w, 3), dtype=np.uint8)
    for code, bgr in _COLORS.items():
        img[types2d == code] = bgr
    if flip_rows:
        img = img[::-1]
    row_bytes = w * 3
    pad = (4 - row_bytes % 4) % 4
    data_size = (row_bytes + pad) * h
    off = 14 + 40
    with open(path, "wb") as f:
        f.write(struct.pack("<2sIHHI", b"BM", off + data_size, 0, 0, off))
        f.write(struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, data_size,
                            2835, 2835, 0, 0))
        padding = b"\x00" * pad
        for r in range(h - 1, -1, -1):   # BMP stores bottom-up
            f.write(img[r].tobytes() + padding)


def mask_to_bmp_stack(types3d: np.ndarray, dirname: str) -> None:
    """Per-Z-slice BMP stack (reference Grid3D::OutputImage)."""
    os.makedirs(dirname, exist_ok=True)
    for k in range(types3d.shape[2]):
        mask_to_bmp(types3d[:, :, k], os.path.join(dirname, f"{k}.bmp"),
                    flip_rows=True)


def mask_to_ascii_3d(types3d: np.ndarray) -> str:
    """Z-slice ASCII stack (reference Grid3D::TestPrint)."""
    dimx, dimy, dimz = types3d.shape
    out = ["grid (z-slices):", f"{dimx} {dimy} {dimz}"]
    for k in range(dimz):
        out.append(str(k))
        for i in range(dimx):
            out.append("".join(_CHARS[int(t)] for t in types3d[i, :, k]))
    return "\n".join(out) + "\n"
