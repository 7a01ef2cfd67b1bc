"""The pair sweep (cmcfs_tpu_torch.ops.pair_sweep) against cmcfs_tpu's
exact-order ``scan`` path on the lid cavity at 24x20x18, on the CPU.

One pair is two local iterations of one direction:
``adi3d._solve_direction_3d(axis, ..., num_local=2, backend="scan")``, plus
the XLA MergeLayer (temp <- (temp + next)/2 on IN) when gmerge folds it in.

Tolerance 1e-6 absolute on fields of magnitude <= 1.2: the pair sweep
multiplies by the reciprocal spacings (adv * 1/(2h), the TPU kernel's
form) where the scan path divides (adv / (2h)), reads Dirichlet values
from temp where the scan path reads the grid values (equal here: temp
carries them on BOUND/VALVE cells), and XLA contracts FMAs where eager
PyTorch rounds twice.  Measured 2.4e-7 (a few ulps) on every case.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cmcfs_tpu.core.params import FluidParams
from cmcfs_tpu.core.types import NodeType
from cmcfs_tpu.geom.synthetic import lid_cavity_3d
from cmcfs_tpu.models import adi3d as jadi
from cmcfs_tpu.models import common3d as jc
from cmcfs_tpu_torch.models import adi3d as tadi
from cmcfs_tpu_torch.models.common3d import from_jax_numpy, merge_ok
from cmcfs_tpu_torch.ops import pair_sweep as ps

ATOL = 1e-6


def setup_case(seed=0):
    """Lid cavity with seeded noise on IN cells: (jax temp, rhs, out_prev,
    ga, pa) — BOUND/VALVE cells keep their grid values, as after
    update_boundaries."""
    grid = lid_cavity_3d(24, 20, 18)
    ga = jc.grid_arrays(grid)
    cur = jc.init_state(grid)
    p = FluidParams.normalized(200.0, 0.72, 1.4)
    pa = jadi.ParamsArgs3D(*(jnp.float32(x) for x in (
        p.v_T, p.v_vis, p.t_vis, p.t_phi, grid.dx, grid.dy, grid.dz)))
    rng = np.random.default_rng(seed)
    is_in = np.asarray(ga.types) == NodeType.IN

    def noisy():
        return jc.State3D(*(jnp.asarray(np.where(
            is_in, np.asarray(f) + 0.1 * rng.standard_normal(f.shape),
            np.asarray(f)).astype(np.float32)) for f in cur))

    return noisy(), noisy(), noisy(), ga, pa


def _stack(state):
    return torch.stack([torch.tensor(np.asarray(f)) for f in state])


@pytest.mark.parametrize("gmerge", [False, True])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_pair_sweep_matches_scan(axis, exact, gmerge):
    temp, rhs, out, ga, pa = setup_case()
    dt = jnp.float32(0.01)
    t_j, o_j = jadi._solve_direction_3d(axis, rhs, temp, out, ga, dt, 2, pa,
                                        "scan", exact)
    if gmerge:
        is_in = ga.types == NodeType.IN
        t_j = jc.State3D(*(jnp.where(is_in, (t + o) / 2.0, t)
                           for t, o in zip(t_j, o_j)))
    st, tga, tpa = from_jax_numpy(temp, ga, pa, "cpu")
    assert merge_ok(tga)[axis]
    before = ps.launches.count
    o_t, t_t = ps.pair_sweep(torch.stack(tuple(st)), tga.cls_a[axis],
                             tga.bc_vel, tga.bc_temp, _stack(rhs),
                             _stack(out), tadi._nl_scal(axis, tpa, dt), axis,
                             exact, gmerge)
    assert ps.launches.count == before      # CPU tensors: plain version
    for k in range(4):
        np.testing.assert_allclose(o_t[k].numpy(), np.asarray(o_j[k]),
                                   rtol=0, atol=ATOL)
        np.testing.assert_allclose(t_t[k].numpy(), np.asarray(t_j[k]),
                                   rtol=0, atol=ATOL)


def _args(device):
    temp, rhs, out, ga, pa = setup_case(seed=1)
    st, tga, tpa = from_jax_numpy(temp, ga, pa, device)
    return (torch.stack(tuple(st)), tga.cls_a[0], tga.bc_vel, tga.bc_temp,
            _stack(rhs).to(device), _stack(out).to(device),
            tadi._nl_scal(0, tpa, 0.01), 0)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "scal",
                                 "axis"])
def test_pair_sweep_checks_inputs(bad):
    temp4, cls, bcv, bct, rhs4, op4, scal, axis = _args("cpu")
    if bad == "dtype":
        rhs4 = rhs4.double()
    elif bad == "shape":
        op4 = op4[:3]
    elif bad == "contiguous":
        temp4 = temp4.transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "scal":
        scal = scal[:7]
    else:
        axis = 3
    with pytest.raises((TypeError, ValueError)):
        ps.pair_sweep(temp4, cls, bcv, bct, rhs4, op4, scal, axis, True,
                      False)


def test_pair_sweep_no_fallback_off_cpu():
    """Tensors on a device other than the CPU never take the plain version:
    a device with no kernel raises."""
    temp4, cls, bcv, bct, rhs4, op4, scal, axis = _args("cpu")
    meta = [t.to("meta") for t in (temp4, cls, bcv, bct, rhs4, op4)]
    with pytest.raises(RuntimeError, match="no kernel"):
        ps.pair_sweep(*meta[:4], meta[4], meta[5], scal, axis, True, False)
