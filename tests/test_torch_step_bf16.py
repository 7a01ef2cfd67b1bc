"""Whole 3D steps of the bf16 backends against cmcfs_tpu's steps of the
same backend, on the CPU: ``adi3d.adi_timestep_3d`` of the port (the plain
versions of the bf16 kernels) and of cmcfs_tpu (its Pallas kernels in
interpret mode) on the 16 x 12 x 12 lid cavity with seeded noise on IN
cells, normalized parameters, num_global 1, num_local 2: every direction
on the bf16 pair (``fused_bf16``) here, reciprocal Thomas; exact:
test_torch_step_bf16_exact.py; ``fused_pcr_bf16``:
test_torch_step_pcr_bf16.py.  A step costs cmcfs_tpu ~70 s of
interpret-mode tracing whatever the grid's size, one file a step.

Tolerance: a call of each kernel agrees within one bf16 ulp a cell
(test_torch_pair_sweep_bf16.py), and one flipped ulp feeds the next
direction, so the fields are held to STEP_TOL = 2^-8 * max(1, max|field|)
per variable, one bf16 ulp at 1; the divergence error within 1e-3.
Measured: ``fused_bf16`` equal cell for cell in both ``exact`` modes,
``fused_pcr_bf16`` 4.8e-7 * max(1, max|field|) apart.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmcfs_tpu.core.params import FluidParams
from cmcfs_tpu.core.types import NodeType
from cmcfs_tpu.geom.synthetic import lid_cavity_3d
from cmcfs_tpu.models import adi3d as jadi
from cmcfs_tpu.models import common3d as jc
from cmcfs_tpu_torch.models import adi3d as tadi
from cmcfs_tpu_torch.models.common3d import from_jax_numpy, merge_ok

STEP_TOL = 2.0 ** -8


def step_matches(backend, exact, seed=2):
    """One step of ``backend`` in both packages from the same noisy state;
    returns the largest max|delta| / max(1, max|field|)."""
    grid = lid_cavity_3d(16, 12, 12)
    ga = jc.grid_arrays(grid)
    p = FluidParams.normalized(200.0, 0.72, 1.4)
    pa = jadi.ParamsArgs3D(*(jnp.float32(x) for x in (
        p.v_T, p.v_vis, p.t_vis, p.t_phi, grid.dx, grid.dy, grid.dz)))
    rng = np.random.default_rng(seed)
    is_in = np.asarray(ga.types) == NodeType.IN
    cur = jc.State3D(*(jnp.asarray(np.where(
        is_in, np.asarray(f) + 0.05 * rng.standard_normal(f.shape),
        np.asarray(f)).astype(np.float32))
        for f in jc.update_boundaries(jc.init_state(grid), ga)))
    st, tga, tpa = from_jax_numpy(cur, ga, pa, "cpu")
    mok = merge_ok(tga)
    rep = tadi.dispatch_report(tuple(tga.types.shape), (False,) * 3,
                               backend, 2, mok)
    want_rep = jadi.dispatch_report(tuple(tga.types.shape), ga, backend, 2,
                                    mok)
    assert rep["dirs"] == want_rep["dirs"] == {"X": "pair", "Y": "pair",
                                              "Z": "pair"}
    assert rep["bf16"] and want_rep["bf16"]
    want, je = jadi.adi_timestep_3d(cur, cur, ga, jnp.float32(0.01), 1, 2,
                                    pa, backend=backend, exact=exact,
                                    merge_ok=mok)
    got, te = tadi.adi_timestep_3d(st, st, tga, np.float32(0.01), 1, 2, tpa,
                                   backend=backend, exact=exact,
                                   merge_ok=mok)
    worst = 0.0
    for g, w in zip(got, want):
        w = np.asarray(w)
        scale = max(1.0, float(np.abs(w).max()))
        err = float(np.abs(g.numpy() - w).max()) / scale
        assert err <= STEP_TOL, err
        worst = max(worst, err)
    assert abs(float(te) - float(je)) <= 1e-3
    return worst


def test_fused_bf16_step_matches_jax():
    step_matches("fused_bf16", False)
