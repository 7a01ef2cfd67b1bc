"""The CUDA pair-sweep kernel against its plain PyTorch version, on the card.

Marked ``gpu``: each test decides inside itself whether a CUDA device is
present and skips otherwise.  This file imports no JAX, so it also runs on
a machine that has only PyTorch:

    python -m pytest -m gpu tests/test_torch_kernel_gpu.py

Bound per variable 1e-5 * max(1, max|plain|), as chip_smoke.py's: nvcc
contracts mul-adds into FMAs where eager PyTorch rounds every op; the
diagonally dominant Thomas rows do not amplify ulp-level differences.
"""
import numpy as np
import pytest
import torch

from cmcfs_tpu.core.params import FluidParams
from cmcfs_tpu.core.types import NodeType
from cmcfs_tpu.geom.synthetic import lid_cavity_3d
from cmcfs_tpu_torch.models import adi3d
from cmcfs_tpu_torch.models.common3d import (grid_arrays, init_state,
                                             merge_ok, update_boundaries)
from cmcfs_tpu_torch.ops import pair_sweep as ps


def _case(device, seed=0):
    grid = lid_cavity_3d(24, 20, 18)
    ga = grid_arrays(grid, device)
    pa = adi3d.make_params(FluidParams.normalized(200.0, 0.72, 1.4),
                           grid.dx, grid.dy, grid.dz)
    base = torch.stack(tuple(update_boundaries(init_state(grid, device), ga)))
    rng = np.random.default_rng(seed)
    is_in = ga.types == NodeType.IN

    def noisy():
        n = torch.tensor(rng.standard_normal(tuple(base.shape)),
                         dtype=torch.float32, device=device)
        return torch.where(is_in, base + 0.1 * n, base)

    return ga, pa, noisy(), noisy(), noisy()


@pytest.mark.gpu
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_kernel_matches_plain(axis, exact):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ga, pa, temp4, rhs4, op4 = _case("cuda")
    assert merge_ok(ga)[axis]
    args = (temp4, ga.cls_a[axis], ga.bc_vel, ga.bc_temp, rhs4, op4,
            adi3d._nl_scal(axis, pa, 0.01), axis, exact, axis == 0)
    before = ps.launches.count
    out_k, tn_k = ps.pair_sweep(*args)
    assert ps.launches.count == before + 2
    out_p, tn_p = ps.pair_sweep_ref(*args)
    torch.cuda.synchronize()
    for k4, p4 in ((out_k, out_p), (tn_k, tn_p)):
        for k, p in zip(k4, p4):
            bound = 1e-5 * max(1.0, float(p.abs().max()))
            assert float((k - p).abs().max()) <= bound


@pytest.mark.gpu
def test_step_on_gpu_matches_cpu():
    """One whole ADI step on the card (kernel) against the same step on
    the CPU (plain version)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    steps = {}
    for dev in ("cpu", "cuda"):
        ga, pa, temp4, _, _ = _case(dev, seed=1)
        cur = tuple(temp4)
        new, err = adi3d.adi_timestep_3d(cur, cur, ga, 0.01, 2, 2, pa,
                                         exact=True, merge_ok=merge_ok(ga))
        steps[dev] = (torch.stack(tuple(new)).cpu(), float(err))
    (x_c, e_c), (x_g, e_g) = steps["cpu"], steps["cuda"]
    assert np.isfinite(e_g) and abs(e_g - e_c) <= 1e-4 * abs(e_c)
    for c, g in zip(x_c, x_g):
        bound = 1e-5 * max(1.0, float(c.abs().max()))
        assert float((g - c).abs().max()) <= bound
