"""The port's 2D line sweep (``line_sweep_2d``) against the TPU kernels it
replaces in their 2D mode (``t_var=2, bc2d=True``), run in interpret mode
on the CPU as the JAX package's own tests run them:
``pallas_sweep_dma.fused_sweep_dma`` for lines up to 288 cells and
``pallas_sweep_long.fused_sweep_long`` past them, called as
``cmcfs_tpu/models/adi2d.py:115-136`` calls them (the Y direction
transposes, the batch pads to 128 lanes, bc_temp is both BC masks).

Inputs are seeded with numpy: random segments of line classes and random
BC codes (FREE rows included), a small advection field and O(1)
right-hand sides; odd lengths on both axes, and a 300-cell line.  Every
solution is finite (checked).  Tolerance 1e-6 *
max(1, max|x|): the same row build and recurrence in the same order;
XLA may contract a mul-add into an FMA where eager PyTorch rounds twice.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cmcfs_tpu.ops.masks import BC0, BC1, IDENTITY, INTERIOR
from cmcfs_tpu.ops.pallas_sweep_dma import fused_sweep_dma
from cmcfs_tpu.ops.pallas_sweep_long import fused_sweep_long
from cmcfs_tpu_torch.ops import line_sweep as ls
from cmcfs_tpu_torch.ops.sweep_common import pack_masks

SCAL = np.array([0.5, 0.7, 30.0, 5.0], dtype=np.float32)


def segments(rng, shape, axis):
    """Line classes made of whole segments along ``axis``: BC0, interior
    rows, BC1, with identity cells between.  (Random classes can put a 2D
    FREE BC1 row right after a FREE BC0 row, a singular system.)"""
    n = shape[axis]
    lines = np.zeros((int(np.prod(shape)) // n, n), dtype=np.int8)
    for line in lines:
        i = 0
        while i < n:
            seg = int(rng.integers(3, 12))
            if rng.random() < 0.15 or i + seg > n:
                i += 1
                continue
            line[i], line[i + 1:i + seg - 1], line[i + seg - 1] = (
                BC0, INTERIOR, BC1)
            i += seg
    rest = tuple(m for ax, m in enumerate(shape) if ax != axis)
    return np.ascontiguousarray(np.moveaxis(lines.reshape(rest + (n,)), -1,
                                            axis))


def _inputs(shape, seed, axis):
    rng = np.random.default_rng(seed)
    cls = segments(rng, shape, axis)
    assert {BC0, BC1, INTERIOR, IDENTITY} <= set(np.unique(cls))
    bct = rng.integers(0, 2, shape).astype(np.int8)
    adv = (0.2 * rng.standard_normal(shape)).astype(np.float32)
    d3 = rng.standard_normal((3,) + shape).astype(np.float32)
    return adv, cls, bct, d3


def _jax(adv, cls, bct, d3, axis, exact):
    """adi2d.py:114-136: lines on the kernel's sweep axis 0, the batch
    padded to whole 128-lane tiles, bc_temp as both masks."""
    arrs = [jnp.asarray(adv), jnp.asarray(cls, jnp.float32),
            jnp.asarray(bct, jnp.float32)] + [jnp.asarray(x) for x in d3]
    if axis == 1:
        arrs = [jnp.swapaxes(m, 0, 1) for m in arrs]
    n, batch = arrs[0].shape
    bp = -(-batch // 128) * 128
    arrs = [jnp.pad(m, ((0, 0), (0, bp - batch))).reshape(n, bp // 128, 128)
            for m in arrs]
    a3, c3, b3 = arrs[:3]
    d = jnp.stack(arrs[3:])
    if n > 288:
        x = fused_sweep_long(a3, c3, b3, b3, d, jnp.asarray(SCAL),
                             sweep_axis=0, exact=exact, t_var=2, bc2d=True)
    else:
        x = fused_sweep_dma(a3, c3, b3, b3, d, jnp.asarray(SCAL),
                            sweep_axis=0, exact=exact,
                            s_tile=min(8, bp // 128), t_var=2, bc2d=True)
    x = x.reshape(3, n, bp)[:, :, :batch]
    return np.asarray(jnp.swapaxes(x, 1, 2) if axis == 1 else x)


def _port(adv, cls, bct, d3, axis, exact):
    t_bct = torch.tensor(bct)
    pk = pack_masks(torch.tensor(cls), t_bct, t_bct)
    before = ls.launches.count
    x = ls.line_sweep_2d(torch.tensor(adv), pk, torch.tensor(d3), SCAL, axis,
                         exact)
    assert ls.launches.count == before      # CPU tensors: plain version
    return x.numpy()


def _close(got, want):
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=0, equal_nan=False,
                               atol=1e-6 * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("axis", [0, 1])
def test_line_sweep_2d_matches_fused_sweep_dma(axis, exact):
    ins = _inputs((21, 13), seed=axis + 2 * exact, axis=axis)
    _close(_port(*ins, axis, exact), _jax(*ins, axis, exact))


@pytest.mark.parametrize("exact", [True, False])
def test_line_sweep_2d_matches_fused_sweep_long(exact):
    """A 300-cell line: the TPU's chunked long-line kernel."""
    ins = _inputs((300, 9), seed=5 + exact, axis=0)
    _close(_port(*ins, 0, exact), _jax(*ins, 0, exact))


def test_free_rows_are_2d_forms():
    """A FREE segment start then end on one line: x0 = x1 and
    x_{n-2} = x_{n-1} (the 2D difference rows), not 3D extrapolation."""
    n = 6
    cls = np.array([[BC0, INTERIOR, INTERIOR, INTERIOR, INTERIOR, BC1]],
                   dtype=np.int8)
    bct = np.ones((1, n), dtype=np.int8)
    adv = np.zeros((1, n), dtype=np.float32)
    d3 = np.zeros((3, 1, n), dtype=np.float32)
    d3[:, 0, 1:-1] = 1.0
    x = _port(adv, cls, bct, d3, 1, True)
    np.testing.assert_allclose(x[:, 0, 0], x[:, 0, 1], rtol=1e-6)
    np.testing.assert_allclose(x[:, 0, -1], x[:, 0, -2], rtol=1e-6)


@pytest.mark.parametrize("bad", ["dims", "d", "axis"])
def test_line_sweep_2d_checks_inputs(bad):
    adv, cls, bct, d3 = (torch.tensor(a)
                         for a in _inputs((9, 7), seed=1, axis=0))
    pk, axis = pack_masks(cls, bct, bct), 0
    if bad == "dims":
        adv, pk = adv[None], pk[None]
    elif bad == "d":
        d3 = torch.cat((d3, d3[:1]))
    else:
        axis = 2
    with pytest.raises(ValueError):
        ls.line_sweep_2d(adv, pk, d3, SCAL, axis, True)
    meta = [t.to("meta") for t in (adv, pk, d3)]
    if bad == "axis":
        with pytest.raises(RuntimeError, match="no kernel"):
            ls.line_sweep_2d(*meta, SCAL, 1, True)
