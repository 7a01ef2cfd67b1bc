"""The plain 3D ADI time step in PyTorch operations, on any device.

One time step of the cmc-fluid-solver ADI scheme (AdiSolver3D.cpp:
306-391) as the measured program defines it: ``num_global`` times a Z, a
Y and an X direction, each ``num_local`` implicit local iterations on
whole grid lines (u, v and w on shared rows, T on its own), each followed
by the update of the line's cells and the merge of IN cells, then the
merge of the layer, and the divergence error.  A frozen copy of the
program's plain versions: every product, sum and division rounds as
there, so on the same device the program's kernels, which round as their
plain versions do, can agree with it bit for bit.

A direction takes one of two arithmetic forms, chosen as the program's
dispatch chooses them: the pair form (derivatives by reciprocal
spacings, two iterations a call, the global merge folded into X's last
pair) on lines of at most ``MAX_SWEEP`` cells whose interior rows are
the IN cells, and the fallback form (right-hand sides by divided
differences, one solve a class of lines, the global merge as its own
step) otherwise.  Both are the same scheme.
"""
from __future__ import annotations

import numpy as np
import torch

from .grid import (BC0, BC1, BOUND, FREE, IN, INTERIOR, VALVE, Grid,
                   Params)

_F = np.float32
# the longest line the pair form takes, and the tiles the grid is padded
# to before that length is read (a pad that grows the grid by at most 25 %)
MAX_SWEEP = 256
STEP_TILES = (8, 128, 128)


def _dev(a, device):
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


class Arrays:
    """A grid's arrays on a device, and the per-axis line classes."""

    def __init__(self, g: Grid, classes: list, device):
        self.types = _dev(g.types, device)
        self.bc_vel = _dev(g.bc_vel, device)
        self.bc_temp = _dev(g.bc_temp, device)
        self.vals = _dev(np.stack([g.vel[..., 0], g.vel[..., 1],
                                   g.vel[..., 2], g.T]), device)
        self.cls_a = [_dev(a, device) for a, _, _ in classes]
        self.cls_b = [None if b is None else _dev(b, device)
                      for _, b, _ in classes]
        self.take_b = [None if t is None else _dev(t, device)
                       for _, _, t in classes]
        self.spacing = (g.dx, g.dy, g.dz)


def paths(shape: tuple, merge_ok: tuple, duals: tuple,
          num_local: int) -> list:
    """The arithmetic form of each axis: "pair" or "fallback"."""
    pad = [-n % t for n, t in zip(shape, STEP_TILES)]
    grow = np.prod([n + p for n, p in zip(shape, pad)]) / np.prod(shape)
    n_eff = [n + p for n, p in zip(shape, pad)] if grow <= 1.25 else shape
    out = []
    for ax in range(3):
        if n_eff[ax] > MAX_SWEEP:
            out.append("fallback")
        elif num_local >= 2 and merge_ok[ax] and (not duals[ax]
                                                  or num_local % 2 == 0):
            if num_local % 2:
                raise NotImplementedError("odd num_local: the stream form "
                                          "is not in this reference")
            out.append("pair")
        elif merge_ok[ax] and not duals[ax]:
            raise NotImplementedError("the stream form is not in this "
                                      "reference")
        else:
            out.append("fallback")
    return out


def scalars(p: Params, spacing, axis: int, dt) -> np.ndarray:
    """[v_vis/h^2, t_vis/h^2, 3/dt, 1/(2h), v_T, t_phi, 1/(2h1), 1/(2h2)]
    in float32 arithmetic; h1, h2 the cross axes' spacings in axis
    order."""
    h = _F(spacing[axis])
    h1, h2 = (_F(spacing[a]) for a in range(3) if a != axis)
    one, two = _F(1.0), _F(2.0)
    return np.array([_F(p.v_vis) / (h * h), _F(p.t_vis) / (h * h),
                     _F(3.0) / _F(dt), one / (two * h), _F(p.v_T),
                     _F(p.t_phi), one / (two * h1), one / (two * h2)],
                    dtype=np.float32)


def shift(f, offset: int, axis: int):
    """result[i] = f[i + offset], wrapping at the ends."""
    return torch.roll(f, -offset, dims=axis)


def over(x, s):
    """x / s correctly rounded (a division by a device scalar)."""
    return x / torch.full((), float(_F(s)), dtype=x.dtype, device=x.device)


def d1(f, h, axis):
    return over(shift(f, 1, axis) - shift(f, -1, axis), _F(2.0) * _F(h))


def diss(axis, u, v, w, dx, dy, dz):
    """The viscous dissipation of direction ``axis`` (TimeLayer3D.h:
    553-588), by divided differences."""
    if axis == 0:
        ux = d1(u, dx, 0); vx = d1(v, dx, 0); wx = d1(w, dx, 0)
        uy = d1(u, dy, 1); uz = d1(u, dz, 2)
        return 2 * ux * ux + vx * vx + wx * wx + vx * uy + wx * uz
    if axis == 1:
        uy = d1(u, dy, 1); vy = d1(v, dy, 1); wy = d1(w, dy, 1)
        vx = d1(v, dx, 0); vz = d1(v, dz, 2)
        return uy * uy + 2 * vy * vy + wy * wy + uy * vx + wy * vz
    uz = d1(u, dz, 2); vz = d1(v, dz, 2); wz = d1(w, dz, 2)
    wx = d1(w, dx, 0); wy = d1(w, dy, 1)
    return uz * uz + vz * vz + 2 * wz * wz + uz * wx + vz * wy


def rows(cls, free, adv_2h, vis, b_int):
    """(a, b, c): interior rows -q/(2h) - nu/h^2, 3/dt + 2 nu/h^2,
    q/(2h) - nu/h^2; a segment's end rows the identity, or where FREE the
    linear extrapolation (2, -1 | -1, 2); identity rows elsewhere."""
    interior = cls == INTERIOR
    is_bc0 = cls == BC0
    is_bc1 = cls == BC1
    zero = torch.zeros((), dtype=adv_2h.dtype, device=adv_2h.device)
    a = torch.where(interior, -adv_2h - vis,
                    torch.where(is_bc1, torch.where(free, -1.0, 0.0), zero))
    b = torch.where(interior, b_int,
                    torch.where(is_bc0 | is_bc1, torch.where(free, 2.0, 1.0),
                                1.0 + zero))
    c = torch.where(interior, adv_2h - vis,
                    torch.where(is_bc0, torch.where(free, -1.0, 0.0), zero))
    return a, b, c


def thomas(a, b, c, d, axis: int, exact: bool, recip_row0: bool):
    """Solve a x[i-1] + b x[i] + c x[i+1] = d along ``axis`` (row 0's a and
    the last row's c ignored); ``exact`` divides twice a row, else one
    reciprocal a row (row 0 divides unless ``recip_row0``)."""
    a, b, c, d = (torch.movedim(t, axis, 0) for t in (a, b, c, d))
    n = d.shape[0]
    cp = torch.empty_like(d)
    dp = torch.empty_like(d)
    c0 = c[0] if n > 1 else torch.zeros_like(c[0])
    if recip_row0 and not exact:
        r = torch.reciprocal(b[0])
        cp[0] = c0 * r
        dp[0] = d[0] * r
    else:
        cp[0] = c0 / b[0]
        dp[0] = d[0] / b[0]
    for i in range(1, n):
        ci = c[i] if i < n - 1 else torch.zeros_like(c[i])
        denom = b[i] - a[i] * cp[i - 1]
        num = d[i] - dp[i - 1] * a[i]
        if exact:
            cp[i] = ci / denom
            dp[i] = num / denom
        else:
            r = torch.reciprocal(denom)
            cp[i] = ci * r
            dp[i] = num * r
    x = torch.empty_like(d)
    x[n - 1] = dp[n - 1]
    for i in range(n - 2, -1, -1):
        x[i] = dp[i] - cp[i] * x[i + 1]
    return torch.movedim(x, 0, axis)


def _solve4(cls, free_v, free_t, adv_2h, d4, vis_v, vis_t, b_v, b_t, axis,
            exact, recip_row0):
    """x of u, v, w (the velocity rows) and T (its own rows)."""
    rv = rows(cls, free_v, adv_2h, vis_v, b_v)
    rt = rows(cls, free_t, adv_2h, vis_t, b_t)
    a, b, c = (torch.stack((p, p, p, q)) for p, q in zip(rv, rt))
    return thomas(a, b, c, d4, axis + 1, exact, recip_row0)


def _dd(f, inv2h, axis):
    return (shift(f, 1, axis) - shift(f, -1, axis)) * inv2h


def _forcing(temp4, axis, s):
    """t_phi * the dissipation of direction ``axis``, by reciprocal
    spacings."""
    o1, o2 = (ax for ax in range(3) if ax != axis)
    adv = temp4[axis]
    gav = _dd(adv, s[3], axis)
    go1 = _dd(temp4[o1], s[3], axis)
    go2 = _dd(temp4[o2], s[3], axis)
    h1 = _dd(adv, s[6], o1)
    h2 = _dd(adv, s[7], o2)
    if axis == 0:
        dis = 2 * gav * gav + go1 * go1 + go2 * go2
    elif axis == 1:
        dis = go1 * go1 + 2 * gav * gav + go2 * go2
    else:
        dis = go1 * go1 + go2 * go2 + 2 * gav * gav
    return s[5] * (dis + go1 * h1 + go2 * h2)


def pair_iteration(temp4, out4, rhs4, ar: Arrays, axis, s, exact, gmerge):
    """One local iteration in the pair form: (out4, tn4)."""
    inv3dt, inv2h, v_T = s[2:5]
    cls = ar.cls_a[axis]
    adv_2h = temp4[axis] * inv2h
    free_v = ar.bc_vel == FREE
    free_t = ar.bc_temp == FREE
    d_int = rhs4 * inv3dt
    d_int[axis] = d_int[axis] - v_T * _dd(temp4[3], inv2h, axis)
    d_int[3] = d_int[3] + _forcing(temp4, axis, s)
    free4 = torch.stack((free_v, free_v, free_v, free_t))
    interior = cls == INTERIOR
    d = torch.where(interior, d_int,
                    torch.where((cls == BC0) | (cls == BC1),
                                torch.where(free4, 0.0, temp4), 0.0))
    args = (free_v, free_t, adv_2h, d, s[0], s[1], s[2] + _F(2.0) * s[0],
            s[2] + _F(2.0) * s[1], axis, exact, False)
    x = _solve4(cls, *args)
    if ar.cls_b[axis] is not None:
        x_b = _solve4(ar.cls_b[axis], *args)
        x = torch.where(ar.take_b[axis], x_b, x)
    out = torch.where(cls != 0, x, out4)
    tn = torch.where(interior, (temp4 + out) * 0.5, temp4)
    if gmerge:
        tn = torch.where(interior, (tn + out) * 0.5, tn)
    return out, tn


def fallback_x(temp4, rhs4, ar: Arrays, p: Params, axis, s, exact):
    """x4 of one fallback iteration: right-hand sides by divided
    differences, the boundary rows' values folded in, each class of lines
    solved, pass B stitched where it wins."""
    dx, dy, dz = ar.spacing
    h = ar.spacing[axis]
    inv3dt, inv2h = s[2], s[3]
    d = rhs4 * inv3dt
    d[axis] = d[axis] - _F(p.v_T) * d1(temp4[3], h, axis)
    d[3] = d[3] + _F(p.t_phi) * diss(axis, temp4[0], temp4[1], temp4[2],
                                     _F(dx), _F(dy), _F(dz))
    free_v = ar.bc_vel == FREE
    free_t = ar.bc_temp == FREE
    d_bc = torch.where(torch.stack((free_v, free_v, free_v, free_t)), 0.0,
                       ar.vals)
    adv_2h = temp4[axis] * inv2h

    def solve(cls):
        dk = torch.where(cls == INTERIOR, d,
                         torch.where((cls == BC0) | (cls == BC1), d_bc, 0.0))
        return _solve4(cls, free_v, free_t, adv_2h, dk, s[0], s[1],
                       inv3dt + _F(2.0) * s[0], inv3dt + _F(2.0) * s[1],
                       axis, exact, True)

    x = solve(ar.cls_a[axis])
    if ar.cls_b[axis] is not None:
        x = torch.where(ar.take_b[axis], solve(ar.cls_b[axis]), x)
    return x


def direction(axis, path, rhs4, temp4, out4, ar, p, s, num_local, exact,
              gmerge):
    """The local iterations of one direction: (temp4, out4)."""
    if path == "pair":
        for k in range(num_local // 2):
            for last in (False, True):
                out4, temp4 = pair_iteration(
                    temp4, out4, rhs4, ar, axis, s, exact,
                    last and gmerge and k == num_local // 2 - 1)
        return temp4, out4
    written = ar.cls_a[axis] != 0
    is_in = ar.types == IN
    for _ in range(num_local):
        x = fallback_x(temp4, rhs4, ar, p, axis, s, exact)
        out4 = torch.where(written, x, out4)
        temp4 = torch.where(is_in, (temp4 + out4) / 2.0, temp4)
    return temp4, out4


def update_boundaries(x4, ar: Arrays):
    """The grid's values on BOUND and VALVE cells (AdiSolver3D.cpp:
    286-304)."""
    bv = (ar.types == BOUND) | (ar.types == VALVE)
    return torch.where(bv, ar.vals, x4)


def div_error(u, v, w, types, dx, dy, dz):
    """The mean over IN cells off the high borders of |the corner-averaged
    flux divergence| (TimeLayer3D.h:595-641)."""
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
    terms = torch.abs(err_x + err_y + err_z)
    mask = types == IN
    mask[-1, :, :] = False
    mask[:, -1, :] = False
    mask[:, :, -1] = False
    return torch.where(mask, terms, 0.0).sum() / max(int(mask.sum()), 1)


def step(cur4, nxt4, ar: Arrays, p: Params, dt, num_global: int,
         num_local: int, dirs: list, exact: bool = True):
    """One time step from the stacked (4, nx, ny, nz) current and next
    layers, their boundary cells already imposed: (new4, err)."""
    scal = [scalars(p, ar.spacing, ax, dt) for ax in range(3)]
    gfold = dirs[0] == "pair"
    is_in = ar.types == IN
    nxt4 = torch.where((ar.types == BOUND) | (ar.types == VALVE), cur4,
                       nxt4)
    temp4 = cur4
    half4 = torch.zeros_like(cur4)

    def run(axis, rhs, temp, out, gmerge=False):
        return direction(axis, dirs[axis], rhs, temp, out, ar, p, scal[axis],
                         num_local, exact, gmerge)

    for _ in range(num_global):
        temp4, nxt4 = run(2, cur4, temp4, nxt4)
        temp4, half4 = run(1, nxt4, temp4, half4)
        temp4, nxt4 = run(0, half4, temp4, nxt4, gfold)
        if not gfold:
            temp4 = torch.where(is_in, (temp4 + nxt4) / 2.0, temp4)
    dx, dy, dz = ar.spacing
    err = div_error(nxt4[0], nxt4[1], nxt4[2], ar.types, dx, dy, dz)
    return nxt4, err


def tf32_off() -> None:
    """No float32 operation here may run in TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

