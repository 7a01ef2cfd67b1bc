"""Checkpoint / resume (port of cmcfs_tpu/io/checkpoint.py, two of its
three tiers, their functions verbatim):

* legacy text layer dumps compatible with the reference's 2D
  SaveLastLayer/LoadLastLayer (src/Common/IO.h:410-453),
* full-state .npz checkpoints (u, v, [w], T + step/time metadata) for both
  2D and 3D, byte-compatible with cmcfs_tpu's: a checkpoint written by
  either package resumes in the other.

cmcfs_tpu's third tier, orbax snapshots of sharded device arrays, arrives
with the multi-GPU slice (ROADMAP A8).
"""
from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np


# -------------------------------------------------- legacy 2D text format
def save_last_layer_txt(path: str, frame: int, u: np.ndarray, v: np.ndarray,
                        T: np.ndarray) -> None:
    dimx, dimy = u.shape
    with open(path, "w") as f:
        f.write("%i\n" % frame)
        f.write("%i %i\n" % (dimx, dimy))
        for j in range(dimy):
            f.write("".join("%f %f %f " % (u[i, j], v[i, j], T[i, j])
                            for i in range(dimx)) + "\n")


def load_last_layer_txt(path: str, dimx: int, dimy: int,
                        frames: int) -> Optional[Tuple[int, np.ndarray, np.ndarray, np.ndarray]]:
    """Returns (frame, u, v, T) or None on mismatch (reference returns 0)."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        toks = f.read().split()
    frame, indimx, indimy = int(toks[0]), int(toks[1]), int(toks[2])
    if indimx != dimx or indimy != dimy or frame <= 0 or frame > frames:
        return None
    vals = np.asarray(toks[3:3 + dimx * dimy * 3], dtype=np.float32)
    vals = vals.reshape(dimy, dimx, 3)
    u = np.ascontiguousarray(vals[:, :, 0].T)
    v = np.ascontiguousarray(vals[:, :, 1].T)
    T = np.ascontiguousarray(vals[:, :, 2].T)
    return frame, u, v, T


# ----------------------------------------------------- full-state npz tier
def _norm(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_checkpoint(path: str, step: int, time: float, **fields) -> None:
    meta = dict(step=int(step), time=float(time),
                fields=sorted(fields.keys()))
    np.savez(_norm(path), __meta__=np.frombuffer(json.dumps(meta).encode(),
                                                 dtype=np.uint8),
             **{k: np.asarray(val) for k, val in fields.items()})


def load_checkpoint(path: str):
    data = np.load(_norm(path))
    meta = json.loads(bytes(data["__meta__"]).decode())
    fields = {k: data[k] for k in meta["fields"]}
    return meta["step"], meta["time"], fields
