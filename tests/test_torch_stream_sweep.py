"""The port's stream sweep (cmcfs_tpu_torch.ops.stream_sweep) against
cmcfs_tpu's Pallas stream kernel (``pallas_sweep_stream.fused_sweep_stream``,
3D form, run in interpret mode on the CPU as the JAX package's own tests
run it), on the lid cavity at 24x20x18 with seeded noise on IN cells and a
seeded forcing field; X and Y here, each in one ``exact`` mode, and Z
(through the 1<->2 swap, as adi3d does) in test_torch_stream_sweep_z.py:
each interpreted case takes ~13 s on the CPU, mostly tracing.

Tolerance 1e-6 absolute on fields of magnitude <= 1.2: both multiply by
the same reciprocal spacings and read Dirichlet values from temp; the
port's row 0 divides where the TPU kernel multiplies by a reciprocal
(``exact=False``), and XLA may contract FMAs.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cmcfs_tpu.ops.pallas_sweep_stream import fused_sweep_stream
from cmcfs_tpu_torch.models import adi3d as tadi
from cmcfs_tpu_torch.models.common3d import from_jax_numpy, merge_ok
from cmcfs_tpu_torch.ops import stream_sweep as ss

from test_torch_pair_sweep import _stack, setup_case

ATOL = 1e-6


def _jax_stream(temp, rhs, out, ga, forcing, scal, axis, exact):
    args = [jnp.stack(tuple(temp)), ga.cls_a[axis], ga.bc_vel, ga.bc_temp,
            jnp.stack(tuple(rhs)), jnp.stack(tuple(out)),
            jnp.asarray(forcing)]
    if axis == 2:
        args = [jnp.swapaxes(a, a.ndim - 2, a.ndim - 1) for a in args]
    o4, t4 = fused_sweep_stream(*args, jnp.asarray(scal),
                                sweep_axis=min(axis, 1), axis_var=axis,
                                exact=exact)
    if axis == 2:
        o4, t4 = (jnp.swapaxes(a, 2, 3) for a in (o4, t4))
    return np.asarray(o4), np.asarray(t4)


def check_axis(axis, exact):
    """The port's stream sweep against the Pallas kernel on one case."""
    temp, rhs, out, ga, pa = setup_case(seed=4 + axis)
    st, tga, tpa = from_jax_numpy(temp, ga, pa, "cpu")
    assert merge_ok(tga)[axis]
    rng = np.random.default_rng(11 + axis)
    forcing = (0.1 * rng.standard_normal(tga.types.shape)).astype(np.float32)
    scal = tadi._nl_scal(axis, tpa, 0.01)[:5]
    o_j, t_j = _jax_stream(temp, rhs, out, ga, forcing, scal, axis, exact)
    before = ss.launches.count
    o_t, t_t = ss.stream_sweep(torch.stack(tuple(st)), tga.cls_a[axis],
                               tga.bc_vel, tga.bc_temp, _stack(rhs),
                               _stack(out), torch.tensor(forcing), scal,
                               axis, exact)
    assert ss.launches.count == before      # CPU tensors: plain version
    np.testing.assert_allclose(o_t.numpy(), o_j, rtol=0, atol=ATOL)
    np.testing.assert_allclose(t_t.numpy(), t_j, rtol=0, atol=ATOL)


@pytest.mark.parametrize("axis, exact", [(0, False), (1, True)])
def test_stream_sweep_matches_pallas(axis, exact):
    check_axis(axis, exact)


def test_stream_sweep_checks_inputs():
    temp, rhs, out, ga, pa = setup_case(seed=1)
    st, tga, tpa = from_jax_numpy(temp, ga, pa, "cpu")
    args = [torch.stack(tuple(st)), tga.cls_a[0], tga.bc_vel, tga.bc_temp,
            _stack(rhs), _stack(out)]
    forcing = torch.zeros(tuple(tga.types.shape))
    with pytest.raises(ValueError, match="scal"):
        ss.stream_sweep(*args, forcing, tadi._nl_scal(0, tpa, 0.01), 0, True)
    with pytest.raises(ValueError, match="forcing"):
        ss.stream_sweep(*args, forcing.double(),
                        tadi._nl_scal(0, tpa, 0.01)[:5], 0, True)
    meta = [t.to("meta") for t in args + [forcing]]
    with pytest.raises(RuntimeError, match="no kernel"):
        ss.stream_sweep(*meta, tadi._nl_scal(0, tpa, 0.01)[:5], 0, True)
