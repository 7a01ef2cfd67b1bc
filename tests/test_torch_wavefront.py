"""The port's Z-blocked wavefront X sweep (``blocking nBlockZ``:
``AdiSolver3D.set_plan(..., nblockz=)``, ``adi3d.x_direction``) on CPU
shards.

* The split ``scan`` step with nblockz 7 on cmcfs_tpu's own fixture
  (tests/test_parallel.py:216-244: ``lid_cavity_3d(32, 19, 21)``, ng=2
  nl=2, dt 0.01, normalized parameters) over 2, 3 and 4 shards: bit for
  bit the port's unblocked split (X resharded) and its single device, and
  within atol 5e-7 of cmcfs_tpu's wavefront step over its 8-device mesh
  (its own test's tolerance, which allows its FMA contraction);
* the duals (the FREE baffle, X lines with dual endpoints: passes A and B
  through the pipeline, stitched by take_b) bit for bit under ``scan``;
  ``fused_dma`` (X on the rows, Y and Z on the line sweep) on the twin
  cavity's balanced cuts against cmcfs_tpu's ``fused_dma`` step with the
  same cuts and nblockz, within 1e-5 x max(1, max|field|) and the error
  within 1e-4 relative;
* the X direction of the bf16 backends at nl=3 (X on the fallback under a
  plan, cmcfs_tpu adi3d.py:466-470), whose wavefront builds float32 rows
  as cmcfs_tpu's does (adi3d.py:373-378), on the baffle's duals from a
  seeded noisy state: against cmcfs_tpu's ``_solve_direction_3d`` under
  its plan with the same nblockz, within 1e-5 x max(1, max|field|) (both
  ``exact`` modes; measured 2.2e-7); in exact mode bit for bit the single
  device's ``scan`` X direction (the wavefront's recurrence is the
  scan's).  The whole bf16 step is not run in cmcfs_tpu here: its pair
  and stream kernels take minutes in interpret mode;
* ``dispatch_report`` under a plan with nblockz, as cmcfs_tpu's: blocking
  leaves the pair X direction as it is;
* ``cli3d ... shards 2 blocking 4`` (``scan``) on the 16^3 box writes the
  NetCDF file of the run without ``blocking`` byte for byte.
"""
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmcfs_tpu.geom.synthetic import lid_cavity_3d as jax_lid
from cmcfs_tpu.models import adi3d as jadi
from cmcfs_tpu.models import common3d as jc
from cmcfs_tpu.models.common3d import grid_arrays, init_state
from cmcfs_tpu.models.solver3d import AdiSolver3D as JaxSolver
from cmcfs_tpu.parallel.mesh import ShardingPlan as JaxPlan
from cmcfs_tpu.parallel.mesh import make_x_mesh as jax_mesh
from cmcfs_tpu_torch import cli3d
from cmcfs_tpu_torch.core.params import FluidParams
from cmcfs_tpu_torch.core.types import NodeType
from cmcfs_tpu_torch.geom.baffle import free_baffled
from cmcfs_tpu_torch.geom.synthetic import lid_cavity_3d
from cmcfs_tpu_torch.models import adi3d as tadi
from cmcfs_tpu_torch.models.common3d import State3D
from cmcfs_tpu_torch.models.solver3d import AdiSolver3D
from cmcfs_tpu_torch.parallel.mesh import ShardingPlan, make_x_mesh
from scripts.gen_box_case import gen
from test_torch_dispatch3d import DUALS, MERGE, SHAPES
from test_torch_parallel import twin_cavity

PARAMS = FluidParams.normalized(200.0, 0.72, 1.4)


def _step(grid, backend, shards=1, nblockz=0, exact=True, num_local=2,
          balance=None):
    """One step (ng=2, dt 0.01) from the grid's initial state: (the new
    state stacked, the error, the solver)."""
    s = AdiSolver3D(backend=backend, exact=exact, device="cpu")
    s.init(grid, PARAMS)
    if shards > 1:
        s.set_plan(make_x_mesh(devices=["cpu"] * shards), nblockz=nblockz,
                   balance=balance)
    s.time_step(0.01, 2, num_local)
    return torch.stack(tuple(s.state()[0])), s.last_err, s


@pytest.fixture(scope="module")
def jax_wavefront():
    """cmcfs_tpu's wavefront step of tests/test_parallel.py:216-244."""
    grid = jax_lid(32, 19, 21)
    p = PARAMS
    pa = jadi.ParamsArgs3D(*[jnp.float32(x) for x in (
        p.v_T, p.v_vis, p.t_vis, p.t_phi, grid.dx, grid.dy, grid.dz)])
    plan = jax_mesh(8)
    cur = plan.shard_state(init_state(grid))
    out, err = jadi.adi_timestep_3d(
        cur, cur, plan.shard_grid(grid_arrays(grid)), jnp.float32(0.01), 2,
        2, pa, backend="scan", plan=JaxPlan(plan.mesh, plan.axis,
                                             nblockz=7))
    return np.stack([np.asarray(f) for f in out]), float(err)


@pytest.mark.parametrize("shards, exact", [(2, True), (3, True), (4, True),
                                           (2, False)])
def test_split_scan_wavefront_bitwise(shards, exact, jax_wavefront):
    grid = lid_cavity_3d(32, 19, 21)
    one, e1, _ = _step(grid, "scan", exact=exact)
    unblocked, eu, _ = _step(grid, "scan", shards, exact=exact)
    blocked, eb, s = _step(grid, "scan", shards, 7, exact)
    assert s.plan.nblockz == 7
    assert s.dispatch_report(2)["dirs"]["X"] == "fallback"
    assert torch.equal(blocked, unblocked)
    assert torch.equal(blocked, one)
    assert abs(eb - e1) <= 1e-6 * abs(e1) and abs(eb - eu) <= 1e-6 * abs(eu)
    if exact:
        want, werr = jax_wavefront
        np.testing.assert_allclose(blocked.numpy(), want, rtol=0, atol=5e-7)
        assert abs(eb - werr) <= 1e-9


def _within_tol(got, want, tol):
    """Per variable max|got - want| <= tol * max(1, max|want|)."""
    for g, w in zip(got, want):
        w = torch.as_tensor(np.asarray(w))
        assert float((g - w).abs().max()) <= tol * max(
            1.0, float(w.abs().max()))


def _jax_split_step(grid, backend, shards, nblockz, num_local, balance):
    """cmcfs_tpu's step over its ``shards``-device mesh with the same cuts
    (padded, then cropped as its output is) and nblockz: (the new state
    stacked, the error)."""
    ref = JaxSolver(backend=backend)
    ref.init(grid, PARAMS)
    ref.set_plan(jax_mesh(shards), nblockz=nblockz, balance=balance)
    ref.update_boundaries()
    ref.time_step(0.01, 2, num_local)
    out = np.stack([np.asarray(f) for f in ref.cur])
    if ref._x_keep is not None:
        out = out[:, ref._x_keep]
    elif ref._pad_x:
        out = out[:, :-ref._pad_x]
    return out, ref.last_err


@pytest.mark.parametrize("grid, backend, shards, nblockz, balance", [
    ("baffle", "scan", 2, 4, None), ("baffle", "scan", 3, 3, None),
    ("twin", "fused_dma", 4, 6, "EVEN_VOLUME")])
def test_duals_and_fused_backends(grid, backend, shards, nblockz, balance):
    g = free_baffled(20, 18, 16) if grid == "baffle" else twin_cavity()
    unblocked, eu, su = _step(g, backend, shards, balance=balance)
    blocked, eb, sb = _step(g, backend, shards, nblockz, balance=balance)
    assert sb.dispatch_report(2)["dirs"]["X"] == "fallback"
    assert su.x_cuts == sb.x_cuts
    if backend == "scan":
        assert sb.ga.duals[0]
        assert torch.equal(blocked, unblocked)
        assert torch.equal(blocked, _step(g, backend)[0])
    else:
        want, werr = _jax_split_step(g, backend, shards, nblockz, 2,
                                     balance)
        _within_tol(blocked, want, 1e-5)
        assert abs(eb - werr) <= 1e-4 * abs(werr)


def _noisy(types, fields, rng):
    """``fields`` (4, ...) with seeded noise on the IN cells, float32."""
    is_in = types == NodeType.IN
    return np.where(is_in, fields + 0.05 * rng.standard_normal(fields.shape),
                    fields).astype(np.float32)


@pytest.mark.parametrize("backend, exact", [
    ("fused_bf16", True), ("fused_bf16", False), ("fused_pcr_bf16", True)])
def test_wavefront_x_direction_matches_jax(backend, exact):
    grid, nl, shards, nblockz = free_baffled(20, 18, 16), 3, 2, 4
    ref = JaxSolver(backend=backend, exact=exact)
    ref.init(grid, PARAMS)
    ref.set_plan(jax_mesh(shards), nblockz=nblockz)
    port = AdiSolver3D(backend=backend, exact=exact, device="cpu")
    port.init(grid, PARAMS)
    port.set_plan(make_x_mesh(devices=["cpu"] * shards), nblockz=nblockz)
    assert port.dispatch_report(nl)["dirs"]["X"] == "fallback"
    assert port.ga.duals[0]
    rng = np.random.default_rng(12)
    types = np.asarray(grid.types)
    base = np.stack([np.asarray(f) for f in init_state(grid)])
    rhs, temp, out = (_noisy(types, base, rng) for _ in range(3))
    # the bf16 backends hand X an out layer that the Z and Y kernels
    # stored in bf16; the rows and x stay float32
    out_bf16 = torch.from_numpy(out).bfloat16()
    out = out_bf16.float().numpy()
    jt, jo = jax.jit(functools.partial(
        jadi._solve_direction_3d, 0, num_local=nl, backend=backend,
        exact=exact, plan=ref.plan))(
        *(ref.plan.shard_state(jc.State3D(*map(jnp.asarray, f)))
          for f in (rhs, temp, out)), ref.ga, jnp.float32(0.01), pa=ref.pa)
    slabs = [port.plan.split(torch.as_tensor(f), -3, port.x_cuts)
             for f in (rhs, temp, out_bf16)]
    scal = tadi._nl_scal(0, port.pa, 0.01)
    t, o = tadi.x_direction("fallback", *slabs, port.ga, port.pa, scal, nl,
                            exact, False, port.backend, port.plan)
    got = [port.plan.gather(f, -3) for f in (t, o)]
    assert all(f.dtype == torch.float32 for f in got)
    _within_tol(got[0], np.stack([np.asarray(f) for f in jt]), 1e-5)
    _within_tol(got[1], np.stack([np.asarray(f) for f in jo]), 1e-5)
    if exact:
        whole = AdiSolver3D(backend="scan", device="cpu")
        whole.init(grid, PARAMS)
        one = tadi.x_direction(
            "fallback", *([torch.as_tensor(f)] for f in (rhs, temp,
                                                          out_bf16)),
            whole.ga, whole.pa, scal, nl, True, False, "scan")
        for g, w in zip(got, one):
            assert torch.equal(g, w[0])


@pytest.mark.parametrize("shards", [2, 3])
def test_dispatch_report_with_nblockz_matches_jax(shards):
    """cmcfs_tpu's dispatch_report under a plan with nblockz 7 (which does
    not read it): the port's, whose wavefront replaces only the solve
    inside a fallback X direction."""
    jp = jax_mesh(shards)
    jplan = JaxPlan(jp.mesh, jp.axis, nblockz=7)
    tplan = ShardingPlan(["cpu"] * shards, nblockz=7)

    class Duals:
        def __init__(self, duals):
            self.cls_b = tuple(object() if d else None for d in duals)

    for shape, backend, nl, mok, duals in itertools.product(
            SHAPES, tadi.BACKENDS, (1, 2, 3), MERGE, DUALS):
        want = jadi.dispatch_report(shape, Duals(duals), backend, nl, mok,
                                    jplan)
        got = tadi.dispatch_report(shape, duals, backend, nl, mok, tplan)
        assert got["dirs"] == want["dirs"], (shape, backend, nl, mok, duals)
        assert got["pad"] == want["pad"]


def test_cli_blocking_writes_the_same_netcdf(tmp_path):
    data, cfgp = gen(str(tmp_path / "case"), dx=0.07, time_steps=2,
                     num_global=1, num_local=2)
    with open(cfgp) as f:
        text = f.read()
    with open(cfgp, "w") as f:
        f.write(text.replace("out_time_steps \t1000000",
                             "out_time_steps \t1"))
    outs = []
    for name, extra in (("plain", []), ("blocked", ["blocking", "4"])):
        base = str(tmp_path / name)
        argv = [data, base, cfgp, "quiet", "backend", "scan", "shards", "2"]
        assert cli3d.main(argv + extra, device="cpu") == 0
        with open(base + "_res.nc", "rb") as f:
            outs.append(f.read())
    assert outs[0] == outs[1]
    solver, _ = cli3d.run_case(data, str(tmp_path / "rc"), cfgp, quiet=True,
                               max_steps=1, backend="scan", device="cpu",
                               shards=2, nblockz=4)
    assert solver.plan.nblockz == 4
