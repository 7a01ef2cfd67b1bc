"""Central-difference stencils, dissipation and the divergence metrics.

Port of ``cmcfs_tpu/ops/stencil.py`` (2D and 3D forms).  Shifted values at the
array border wrap (``torch.roll``), as in the reference port: every
consumer masks border cells, which are never NODE_IN.  Grid spacings are
float32 scalars (``np.float32``) so scalar arithmetic rounds as JAX's
float32 does.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.types import NodeType

_F = np.float32


def shift(f: torch.Tensor, offset: int, axis: int) -> torch.Tensor:
    """f shifted so that result[i] = f[i + offset] (wrapping)."""
    return torch.roll(f, -offset, dims=axis)


@functools.lru_cache(maxsize=64)
def _divisor(s: float, dtype: torch.dtype, device: torch.device):
    """A 0-d tensor holding s, made once for each (s, dtype, device); it
    is only ever read."""
    return torch.full((), s, dtype=dtype, device=device)


def over(x: torch.Tensor, s) -> torch.Tensor:
    """x / s for a float32 scalar s, the quotient correctly rounded on every
    device, as cmcfs_tpu divides: PyTorch's CUDA division by a host scalar
    multiplies by the scalar's rounded reciprocal instead, which parts from
    the quotient by an ulp wherever s is not a power of two.  The divisor
    is a cached device tensor, so a call costs one division kernel."""
    return x / _divisor(float(_F(s)), x.dtype, x.device)


def d1(f: torch.Tensor, h, axis: int) -> torch.Tensor:
    """(f[i+1] - f[i-1]) / (2h)"""
    return over(shift(f, 1, axis) - shift(f, -1, axis), _F(2.0) * _F(h))


def d2(f: torch.Tensor, h, axis: int) -> torch.Tensor:
    """(f[i+1] - 2 f[i] + f[i-1]) / h^2"""
    return over(shift(f, 1, axis) - 2 * f + shift(f, -1, axis),
                _F(h) * _F(h))


def diss_x_2d(u, v, dx, dy):
    """2 ux^2 + vx^2 + uy*vx (TimeLayer2D.h:63-71)."""
    ux = d1(u, dx, 0); vx = d1(v, dx, 0); uy = d1(u, dy, 1)
    return 2 * ux * ux + vx * vx + uy * vx


def diss_y_2d(u, v, dx, dy):
    """uy^2 + 2 vy^2 + vx*uy (TimeLayer2D.h:73-81)."""
    vx = d1(v, dx, 0); uy = d1(u, dy, 1); vy = d1(v, dy, 1)
    return uy * uy + 2 * vy * vy + vx * uy


def div_error_2d(u, v, types, dx, dy) -> torch.Tensor:
    """Mean |div| over all-IN 2x2 quads (TimeLayer2D.h:88-102), with the
    reference's operator-precedence quirk ``dy*du_j + du_{j+1}/2`` kept
    verbatim, as cmcfs_tpu keeps it.  A 0-d float32 tensor; no host sync."""
    is_in = types == NodeType.IN
    quad = is_in[:-1, :-1] & is_in[1:, :-1] & is_in[:-1, 1:] & is_in[1:, 1:]
    u00 = u[:-1, :-1]; u10 = u[1:, :-1]; u01 = u[:-1, 1:]; u11 = u[1:, 1:]
    v00 = v[:-1, :-1]; v10 = v[1:, :-1]; v01 = v[:-1, 1:]; v11 = v[1:, 1:]
    tx = _F(dy) * (u10 - u00) + (u11 - u01) / 2
    ty = _F(dx) * (v01 - v00) + (v11 - v10) / 2
    err = torch.where(quad, torch.abs(tx + ty), 0.0)
    return err.sum() / quad.sum().clamp(min=1)


def diss_x_3d(u, v, w, dx, dy, dz):
    """2 ux^2 + vx^2 + wx^2 + vx*uy + wx*uz (TimeLayer3D.h:553-563)."""
    ux = d1(u, dx, 0); vx = d1(v, dx, 0); wx = d1(w, dx, 0)
    uy = d1(u, dy, 1); uz = d1(u, dz, 2)
    return 2 * ux * ux + vx * vx + wx * wx + vx * uy + wx * uz


def diss_y_3d(u, v, w, dx, dy, dz):
    """uy^2 + 2 vy^2 + wy^2 + uy*vx + wy*vz (TimeLayer3D.h:566-576)."""
    uy = d1(u, dy, 1); vy = d1(v, dy, 1); wy = d1(w, dy, 1)
    vx = d1(v, dx, 0); vz = d1(v, dz, 2)
    return uy * uy + 2 * vy * vy + wy * wy + uy * vx + wy * vz


def diss_z_3d(u, v, w, dx, dy, dz):
    """uz^2 + vz^2 + 2 wz^2 + uz*wx + vz*wy (TimeLayer3D.h:578-588)."""
    uz = d1(u, dz, 2); vz = d1(v, dz, 2); wz = d1(w, dz, 2)
    wx = d1(w, dx, 0); wy = d1(w, dy, 1)
    return uz * uz + vz * vz + 2 * wz * wz + uz * wx + vz * wy


def _div_terms_3d(u, v, w, dx, dy, dz) -> torch.Tensor:
    """|corner-averaged flux divergence| of every cell (TimeLayer3D.h:
    595-641), before the mask."""
    # f(i,j,k) + f(.., -1 along a) + f(-1 along a and b) + f(-1 along b),
    # summed in cmcfs_tpu's term order (corner_sum_x/_y/_z)
    fm_j = shift(u, -1, 1)
    su = u + fm_j + shift(fm_j, -1, 2) + shift(u, -1, 2)
    fm_i = shift(v, -1, 0)
    sv = v + fm_i + shift(fm_i, -1, 2) + shift(v, -1, 2)
    fm_i = shift(w, -1, 0)
    sw = w + shift(w, -1, 1) + shift(fm_i, -1, 1) + fm_i
    q = _F(4.0)
    err_x = (su - shift(su, -1, 0)) * (_F(dz) * _F(dy) / q)
    err_y = (sv - shift(sv, -1, 1)) * (_F(dx) * _F(dz) / q)
    err_z = (sw - shift(sw, -1, 2)) * (_F(dx) * _F(dy) / q)
    return torch.abs(err_x + err_y + err_z)


def div_error_3d(u, v, w, types, dx, dy, dz) -> torch.Tensor:
    """Staggered-corner divergence metric (TimeLayer3D.h:595-641): mean
    over NODE_IN cells off the high borders of |corner-averaged flux
    divergence|.  Returns a 0-d float32 tensor on the fields' device."""
    mask = types == NodeType.IN
    mask[-1, :, :] = False
    mask[:, -1, :] = False
    mask[:, :, -1] = False
    err = torch.where(mask, _div_terms_3d(u, v, w, dx, dy, dz), 0.0)
    count = int(mask.sum())
    return err.sum() / max(count, 1)


def div_error_sum_3d(u, v, w, mask, dx, dy, dz) -> torch.Tensor:
    """The sum of ``div_error_3d``'s terms over ``mask``: one X slab's share
    of the metric, its halo planes filled (a 0-d tensor)."""
    return torch.where(mask, _div_terms_3d(u, v, w, dx, dy, dz), 0.0).sum()
