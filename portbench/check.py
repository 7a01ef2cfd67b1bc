"""The numbers the comparison with the reference reads, each held to its
limit.

* ``grid_cells_differing``: cells where the port's grid arrays (node
  types, boundary conditions, boundary values, the line classes of each
  axis, pass B's classes and stitch) differ from the reference's, plus
  one for each axis whose path differs; limit 0.
* ``start_state_gap``: the largest |difference| between the state the
  port was handed and the reference's own initial state with the seed's
  perturbation; limit 0.
* ``*_step_gap``: after one step from the same state, the largest over
  u, v, w and T of max|port - reference| / max(1, max|reference|).
* ``*_err_gap``: that step's divergence error, |port - reference| /
  |reference|.
* ``steps_failed``: window steps that tripped the divergence gate;
  limit 0.
"""
from __future__ import annotations

import numpy as np
import torch


def grid_differing(ga, dirs_port: dict, g, classes: list,
                   dirs_ref: list) -> int:
    """Cells that differ between the port's ``GridArrays3D`` ``ga`` and
    the reference grid ``g`` with its line classes, plus differing
    paths."""
    def host(t):
        return None if t is None else t.detach().cpu().numpy()

    vals = np.stack([g.vel[..., 0], g.vel[..., 1], g.vel[..., 2], g.T])
    pairs = [(host(ga.types), g.types), (host(ga.bc_vel), g.bc_vel),
             (host(ga.bc_temp), g.bc_temp)]
    pairs += [(host(v), vals[k]) for k, v in enumerate(
        (ga.val_u, ga.val_v, ga.val_w, ga.val_T))]
    for ax, (a, b, tb) in enumerate(classes):
        pairs += [(host(ga.cls_a[ax]), a), (host(ga.cls_b[ax]), b),
                  (host(ga.take_b[ax]), tb)]
    n = 0
    for p, r in pairs:
        if (p is None) != (r is None):
            n += 1 if p is None else int(r.size)
        elif p is not None:
            if p.shape != r.shape:
                n += int(r.size)
            else:
                n += int(np.count_nonzero(p != r))
    n += sum(dirs_port[name] != d for name, d in zip("XYZ", dirs_ref))
    return n


def state_gap(port4, ref4) -> float:
    """max over fields of max|port - ref| / max(1, max|ref|)."""
    worst = 0.0
    for p, r in zip(port4, ref4):
        p = p.to(r.device, torch.float32)
        scale = max(1.0, float(r.abs().max()))
        d = float((p - r).abs().max())
        if not np.isfinite(d):
            return float("inf")
        worst = max(worst, d / scale)
    return worst


def abs_gap(port4, ref4) -> float:
    return max(float((p.to(r.device) - r).abs().max())
               for p, r in zip(port4, ref4))


def err_gap(port_err: float, ref_err: float) -> float:
    if not (np.isfinite(port_err) and np.isfinite(ref_err)):
        return float("inf")
    if ref_err == 0.0:
        return 0.0 if port_err == 0.0 else float("inf")
    return abs(port_err - ref_err) / abs(ref_err)


def verdict(checks: dict) -> bool:
    """Every number read and within its limit."""
    return all(c["value"] is not None and c["value"] <= c["limit"]
               for c in checks.values())
