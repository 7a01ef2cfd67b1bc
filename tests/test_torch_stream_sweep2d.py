"""The port's 2D stream sweep (``stream_sweep_2d``) against cmcfs_tpu's
Pallas stream kernel in its 2D ``merge2d`` mode
(``pallas_sweep_stream.fused_sweep_stream``, t_var=2, bc2d, run in
interpret mode on the CPU as the JAX package's own tests run it), called
as ``cmcfs_tpu/models/adi2d.py:_solve_stream_2d`` calls it: the Y
direction transposes, the batch pads to 128 lanes, bc_temp is both BC
masks.

The fixture is the 2D lid cavity at 40x36 with a FREE outflow side (the
+1/-1 rows), which satisfies ``stream_ok_2d`` on both axes, with seeded
noise on IN cells and a seeded forcing field; both axes, ``first`` both
ways (copy, then average), both ``exact`` modes.

Tolerance 1e-6 * max(1, max|field|): both multiply by the same
reciprocal spacings and read Dirichlet values from temp; the port's row 0
divides where the TPU kernel multiplies by a reciprocal (``exact=False``),
and XLA may contract FMAs.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cmcfs_tpu.core.params import FluidParams
from cmcfs_tpu.core.types import BCtype, NodeType
from cmcfs_tpu.geom.synthetic import lid_cavity_2d
from cmcfs_tpu.models import adi2d as jadi
from cmcfs_tpu.models import common2d as jc
from cmcfs_tpu.ops.pallas_sweep_stream import fused_sweep_stream
from cmcfs_tpu_torch.models import adi2d as tadi
from cmcfs_tpu_torch.models.common2d import from_jax_numpy
from cmcfs_tpu_torch.ops import stream_sweep as ss


def setup_case(seed, nx=40, ny=36, noise=0.05, params=None):
    """The lid cavity with a FREE outflow side, noisy IN cells: (ga, pa,
    temp3, rhs3, out3) as numpy, JAX's grid arrays and params (by default
    the 2D bench's physical ones, bench.py:38)."""
    g = lid_cavity_2d(nx, ny, dx=0.002)
    g.cur_bct[nx - 2, 2:-2] = BCtype.FREE
    ga = jc.grid_arrays(g)
    base = np.stack([np.asarray(f) for f in
                     jc.update_boundaries(jc.init_state(g), ga)])
    p = params or FluidParams.physical(0.05, 1000.0, 461.495, 0.6, 4200.0)
    pa = jadi.ParamsArgs(*[jnp.float32(x) for x in
                           (p.v_T, p.v_vis, p.t_vis, p.t_phi, g.dx, g.dy,
                            g.start_T)])
    rng = np.random.default_rng(seed)
    is_in = np.asarray(ga.types) == NodeType.IN

    def noisy():
        n = noise * rng.standard_normal(base.shape)
        return np.where(is_in, base + n, base).astype(np.float32)

    return ga, pa, noisy(), noisy(), noisy()


def _jax(ga, temp3, rhs3, out3, forcing, scal, axis, exact, first):
    cls = ga.cls_x if axis == 0 else ga.cls_y
    arrs, batch = jadi._kernel_layout_2d(
        axis, [cls, ga.bct] + [jnp.asarray(f) for f in
                               (*temp3, *rhs3, *out3, forcing)])
    o3, t3 = fused_sweep_stream(
        jnp.stack(arrs[2:5]), arrs[0], arrs[1], arrs[1], jnp.stack(arrs[5:8]),
        jnp.stack(arrs[8:11]), arrs[11], jnp.asarray(scal), sweep_axis=0,
        axis_var=axis, exact=exact, t_var=2, bc2d=True, merge2d=True,
        first=first)

    def back(m):
        m = m.reshape(3, m.shape[1], -1)[:, :, :batch]
        return np.asarray(jnp.swapaxes(m, 1, 2) if axis == 1 else m)

    return back(o3), back(t3)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("axis, first, exact", [(0, True, False),
                                                (0, False, True),
                                                (1, True, True),
                                                (1, False, False)])
def test_stream_sweep_2d_matches_pallas(axis, first, exact):
    ga, pa, temp3, rhs3, out3 = setup_case(seed=axis + 2 * first)
    st, tga, tpa = from_jax_numpy(tuple(temp3), ga, pa, "cpu")
    assert tadi.stream_ok_2d(tga) == (True, True)
    rng = np.random.default_rng(9 + axis)
    forcing = (0.1 * rng.standard_normal(temp3.shape[1:])).astype(np.float32)
    h = tpa.dx if axis == 0 else tpa.dy
    one = np.float32(1.0)
    scal = np.array([tpa.v_vis / (h * h), tpa.t_vis / (h * h),
                     one / np.float32(0.001), one / (np.float32(2.0) * h),
                     tpa.v_T], dtype=np.float32)
    o_j, t_j = _jax(ga, temp3, rhs3, out3, forcing, scal, axis, exact, first)
    before = ss.launches.count
    o_t, t_t = ss.stream_sweep_2d(
        torch.tensor(temp3), tga.cls_x if axis == 0 else tga.cls_y, tga.bct,
        torch.tensor(rhs3), torch.tensor(out3), torch.tensor(forcing), scal,
        axis, exact, first)
    assert ss.launches.count == before      # CPU tensors: plain version
    _close(o_t.numpy(), o_j)
    _close(t_t.numpy(), t_j)
    # writes are masked by INTERIOR: elsewhere out/temp pass through
    outside = (tga.cls_x if axis == 0 else tga.cls_y).numpy() != 3
    assert np.array_equal(o_t.numpy()[:, outside], out3[:, outside])
    assert np.array_equal(t_t.numpy()[:, outside], temp3[:, outside])


def test_stream_sweep_2d_checks_inputs():
    ga, pa, temp3, rhs3, out3 = setup_case(seed=1, nx=12, ny=10)
    st, tga, tpa = from_jax_numpy(tuple(temp3), ga, pa, "cpu")
    args = [torch.tensor(temp3), tga.cls_x, tga.bct, torch.tensor(rhs3),
            torch.tensor(out3), torch.zeros(tuple(tga.types.shape))]
    scal = np.ones(5, dtype=np.float32)
    with pytest.raises(ValueError, match="scal"):
        ss.stream_sweep_2d(*args, scal[:4], 0, True, True)
    with pytest.raises(ValueError, match="axis"):
        ss.stream_sweep_2d(*args, scal, 2, True, True)
    with pytest.raises(ValueError, match="forcing"):
        ss.stream_sweep_2d(*args[:5], args[5].double(), scal, 0, True, True)
    with pytest.raises(TypeError):
        ss.stream_sweep_2d(args[0].double(), *args[1:], scal, 0, True, True)
    meta = [t.to("meta") for t in args]
    with pytest.raises(RuntimeError, match="no kernel"):
        ss.stream_sweep_2d(*meta, scal, 0, True, True)
