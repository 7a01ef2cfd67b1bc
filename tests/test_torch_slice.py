"""The port's whole 3D main path against cmcfs_tpu on the CPU: the
extruded bench box (scripts/gen_box_case.gen) at dx=0.0164, 65^3 cells,
where every axis takes the pair sweep, num_global=4, num_local=2.

* three steps through the port's AdiSolver3D against cmcfs_tpu's
  AdiSolver3D(backend="scan"): fields within 1e-5 * max|field| (measured
  8.3e-7 with max|field| ~1: per-pair ulp-level differences, see
  test_torch_pair_sweep.py, accumulated over 3 steps x 12 pairs), the
  divergence error within 1e-4 relative (a full-grid float32 sum reduced
  in another order; measured ~1e-6 relative);
* the port's cli3d.run_case NetCDF file against the JAX CLI's: equal
  dimensions, attributes and coordinates, fields within the same bound.
"""
import numpy as np
import pytest

from cmcfs_tpu.core.config import Config
from cmcfs_tpu.core.params import FluidParams
from cmcfs_tpu.io.netcdf3 import NetCDF3Reader
from cmcfs_tpu.models.solver3d import AdiSolver3D as JaxSolver
from cmcfs_tpu_torch import cli3d
from cmcfs_tpu_torch.models.solver3d import AdiSolver3D
from scripts.gen_box_case import gen

STEPS = 3
REL = 1e-5


@pytest.fixture(scope="module")
def box_case(tmp_path_factory):
    d = tmp_path_factory.mktemp("box65")
    data, cfgp = gen(str(d), dx=0.0164, time_steps=4, num_global=4,
                     num_local=2)
    # one output layer per step, so the NetCDF files hold evolving fields
    with open(cfgp) as f:
        text = f.read()
    with open(cfgp, "w") as f:
        f.write(text.replace("out_time_steps \t1000000", "out_time_steps \t1"))
    return str(d), data, cfgp


def test_solver_matches_jax_scan(box_case):
    _, data, cfgp = box_case
    cfg = Config.load(cfgp)
    grid = cli3d.build_grid(cfg, data)
    assert (grid.dimx, grid.dimy, grid.dimz) == (65, 65, 65)
    params = FluidParams.from_config(cfg)
    dt = grid.cycle_len / (grid.num_frames * cfg.time_steps)
    ref = JaxSolver(backend="scan", exact=True)
    ref.init(grid, params)
    port = AdiSolver3D(device="cpu", exact=True)
    port.init(grid, params)
    assert port.dispatch_report(2)["dirs"] == {"X": "pair", "Y": "pair",
                                               "Z": "pair"}
    for _ in range(STEPS):
        for s in (ref, port):
            s.update_boundaries()
            s.time_step(dt, cfg.num_global, cfg.num_local)
        assert abs(port.last_err - ref.last_err) <= 1e-4 * ref.last_err
    for r, p in zip(ref.cur, port.cur):
        r = np.asarray(r)
        np.testing.assert_allclose(p.numpy(), r, rtol=0,
                                   atol=REL * float(np.abs(r).max()))
    for r, p in zip(ref.get_layer(16, 16, 16), port.get_layer(16, 16, 16)):
        np.testing.assert_allclose(p, r, rtol=0, atol=REL)


def test_cli_netcdf_matches_jax_cli(box_case):
    from cmcfs_tpu import cli3d as jax_cli
    d, data, cfgp = box_case
    jax_cli.run_case(data, d + "/jax", cfgp, quiet=True, max_steps=STEPS)
    cli3d.run_case(data, d + "/port", cfgp, quiet=True, max_steps=STEPS,
                   device="cpu")
    rj = NetCDF3Reader(d + "/jax_res.nc")
    rp = NetCDF3Reader(d + "/port_res.nc")
    assert rp.dims == rj.dims
    assert rp.numrecs == rj.numrecs
    assert rp.gattrs == rj.gattrs
    assert rp.vars.keys() == rj.vars.keys()
    for name, vj in rj.vars.items():
        vp = rp.vars[name]
        assert (vp["dimids"], vp["nc_type"]) == (vj["dimids"], vj["nc_type"])
        assert vp["attrs"].keys() == vj["attrs"].keys()
        for k, a in vj["attrs"].items():
            assert np.array_equal(np.asarray(vp["attrs"][k]), np.asarray(a))
        fj, fp = rj.read(name), rp.read(name)
        assert fp.shape == fj.shape
        if name in ("x", "y", "z", "time"):
            assert np.array_equal(fp, fj)
        else:
            np.testing.assert_allclose(fp, fj, rtol=0, atol=REL)
