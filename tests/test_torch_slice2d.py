"""The port's 2D ADI solver against cmcfs_tpu's on the CPU.

* ``adi_timestep_2d``: three steps (UpdateBoundaries then TimeStep, as the
  CLI runs them) of the port against three of cmcfs_tpu's on the 2D lid
  cavity at 40x36 with a FREE outflow side, the same backend on both
  sides, num_local 1 and 2, both ``exact`` modes, num_global=2, seeded
  noise on IN cells, normalized parameters (Re 200, Pr 0.72, lambda 1.4).
  Backend
  ``scan`` here; ``fused_dma`` (the line sweep), ``fused_full`` (the
  stream sweep) and ``pallas`` in test_torch_slice2d_{dma,stream,pallas}.py
  (cmcfs_tpu runs those in interpret mode, 5-30 s a case).  Fields within
  1e-5 * max|state| (the three stacked fields): each path computes in the
  same order as its TPU counterpart, but XLA contracts FMAs where eager
  PyTorch rounds twice, over 3 steps x 2 global x 2 directions; measured
  at most 6e-7 with max|state| ~ 1.  The divergence error within 1e-4 relative (a
  full-grid float32 sum in another order) and the iteration counts equal.
* ``dispatch_report_2d`` against cmcfs_tpu's predicates (adi2d.py:92-93,
  126, 220-223, 233-234) over a table of shapes, backends and stream_ok.
* ``cli2d.run_case``'s CDL output against ``cmcfs_tpu.cli2d``'s on the 2D
  box case (``scripts/gen_box_case.gen_2d``) at a coarse dx: equal header
  and dimensions, values within one print quantum (0.001) of each other.
"""
import itertools
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cmcfs_tpu.core.params import FluidParams
from cmcfs_tpu.models import adi2d as jadi
from cmcfs_tpu.models import common2d as jc
from cmcfs_tpu_torch import cli2d
from cmcfs_tpu_torch.models import adi2d as tadi
from cmcfs_tpu_torch.models import common2d as tc
from cmcfs_tpu_torch.models.solver2d import AdiSolver2D, make_solver
from cmcfs_tpu_torch.ops import line_sweep as ls
from cmcfs_tpu_torch.ops import stream_sweep as ss
from cmcfs_tpu_torch.ops import tridiag_rows as tr

from test_torch_stream_sweep2d import setup_case

REL = 1e-5
# normalized parameters, as the 3D tests use: the 2D bench's physical ones
# (v_T = 461) turn one ulp of T into v_T dt/(2h) = 115 ulps of v per sweep,
# and make velocity noise diverge
PARAMS = FluidParams.normalized(200.0, 0.72, 1.4)
STEPS = 3
DT = np.float32(0.001)


def run_both(backend, num_local, exact, num_global=2, nx=40, ny=36,
             ref_backend=None, atol=None):
    """STEPS steps of both packages on one fixture (cmcfs_tpu on
    ``ref_backend``, by default the same backend); asserts agreement (within
    ``atol``, by default REL * max|state|) and that the port's CPU run took
    no kernel launch."""
    ga, pa, temp3, _, _ = setup_case(seed=0, nx=nx, ny=ny, noise=0.01,
                                     params=PARAMS)
    so = jadi.stream_ok_2d(ga)
    jcur = jc.State2D(*(jnp.asarray(f) for f in temp3))
    st, tga, tpa = tc.from_jax_numpy(tuple(temp3), ga, pa, "cpu")
    assert tadi.stream_ok_2d(tga) == so
    counters = [m.launches for m in (ls, ss, tr)] + [ls.bf16_launches,
                                                      ss.bf16_launches]
    counts = [c.count for c in counters]
    tcur = st
    errs = []
    from jax.experimental.pallas import tpu as pltpu
    for _ in range(STEPS):
        with pltpu.force_tpu_interpret_mode():
            jcur, je, jit = jadi.adi_timestep_2d(
                jc.update_boundaries(jcur, ga), ga, jnp.float32(DT),
                jnp.int32(num_global), num_local, pa,
                backend=ref_backend or backend, exact=exact,
                stream_ok=so)
        tcur, te, tit = tadi.adi_timestep_2d(
            tc.update_boundaries(tcur, tga), tga, DT, num_global, num_local,
            tpa,
            backend=backend, exact=exact, stream_ok=so)
        assert tit == int(jit)
        errs.append((float(te), float(je)))
    assert [c.count for c in counters] == counts
    want = np.stack([np.asarray(f) for f in jcur])
    got = torch.stack(tuple(tcur)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=atol or REL * float(np.abs(want).max()))
    if ref_backend is None:
        for te, je in errs:
            assert abs(te - je) <= 1e-4 * je
    return float(np.abs(got - want).max())


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("num_local", [1, 2])
def test_step_scan_matches_jax(num_local, exact):
    run_both("scan", num_local, exact)


SHAPES = [(1024, 1024), (2048, 2048), (1041, 1041), (2081, 2081),
          (1416, 300), (1417, 40), (40, 36), (300, 20)]
JAX_FUSED = ("fused", "fused_dma", "fused_full", "fused_bf16", "fused_nl")


def _jax_path(n, backend, ok):
    """cmcfs_tpu's predicates, read off adi2d.py:92-93, 126, 233-234."""
    if backend in ("fused_full", "fused_nl") and ok and jadi._stream2d_fits(n):
        return "stream"
    return "line" if backend in JAX_FUSED else "rows"


@pytest.mark.parametrize("shape", SHAPES)
def test_dispatch_report_2d_matches_jax(shape):
    for backend, so in itertools.product(
            tadi.BACKENDS, [(True, True), (True, False), (False, True),
                            (False, False)]):
        got = tadi.dispatch_report_2d(shape, backend, so)
        want = {name: _jax_path(shape[ax], backend, so[ax])
                for ax, name in ((0, "X"), (1, "Y"))}
        assert got == want, (shape, backend, so)
    assert tadi.dispatch_report_2d(shape, "auto", (True, True)) == \
        tadi.dispatch_report_2d(shape, "fused_dma", (True, True))


def test_dispatch_of_bench_sizes():
    """2d1024 streams under fused_nl, 2d2048 runs the line sweep."""
    assert tadi.dispatch_report_2d((1024, 1024), "fused_nl", (True, True)) \
        == {"X": "stream", "Y": "stream"}
    assert tadi.dispatch_report_2d((2048, 2048), "fused_nl", (True, True)) \
        == {"X": "line", "Y": "line"}
    assert tadi.dispatch_report_2d((1041, 1041), "pallas", (False, False)) \
        == {"X": "rows", "Y": "rows"}


@pytest.mark.parametrize("backend", [
    pytest.param("fused_bf16", id="fused_bf16-ROADMAP B2"),
    pytest.param("pcr", id="pcr-None")])
def test_unported_backends_raise(backend):
    """Both backends used to raise and are ported.  ``pcr``: the rows path,
    stepping as cmcfs_tpu's ``pcr`` step.  ``fused_bf16``: the line path
    on both axes whatever ``stream_ok`` (cmcfs_tpu never streams it), its
    three steps within 0.02 of cmcfs_tpu's ``scan`` steps, the bound of
    test_backends2d.py's bf16 case (the same backend against cmcfs_tpu's:
    test_torch_step2d_bf16.py)."""
    assert AdiSolver2D(backend=backend, device="cpu").backend == backend
    if backend == "pcr":
        assert tadi.dispatch_report_2d((40, 36), backend) == {
            "X": "rows", "Y": "rows"}
        run_both(backend, 2, True)
        return
    assert tadi.dispatch_report_2d((40, 36), backend, (True, True)) == {
        "X": "line", "Y": "line"}
    run_both(backend, 2, True, ref_backend="scan", atol=0.02)


@pytest.mark.parametrize("name", ["Explicit", "Stable"])
def test_unported_2d_solvers_raise(name):
    """Explicit and Stable used to raise (ROADMAP A4); they build on the
    CPU and one step on tests/test_solvers2d.py's synthetic lid cavity
    equals cmcfs_tpu's within 1e-6 * max(1, max|field|), with the same
    number of global iterations."""
    from cmcfs_tpu.geom.synthetic import lid_cavity_2d
    from cmcfs_tpu.models.solver2d import make_solver as jax_make
    grid = lid_cavity_2d(24, 20, dx=0.01, lid_velocity=0.4)
    params = FluidParams.normalized(150.0, 0.72, 1.4)
    port, ref = make_solver(name, device="cpu"), jax_make(name)
    assert port.name == ref.name == name
    for s in (port, ref):
        s.init(grid, params)
        s.update_boundaries()
        s.time_step(0.002, 2, 1)
    assert port.last_iters == ref.last_iters
    for g, w in zip(port.cur, ref.cur):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-6 * max(1.0, np.abs(w).max()))


def test_box_case_grid_and_stream_ok(tmp_path):
    """The 2D box case's host arrays equal cmcfs_tpu's; its valve segment
    splits lines, so neither axis may stream."""
    from cmcfs_tpu.core.config import Config
    from cmcfs_tpu_torch.core.scene2d import Scene2D
    from cmcfs_tpu_torch.geom.raster2d import Grid2D
    from scripts.gen_box_case import gen_2d
    data, cfgp = gen_2d(str(tmp_path), dx=0.025)
    cfg = Config.load(cfgp)
    scene = Scene2D.load(data, "", dx=cfg.dx, dy=cfg.dy)
    grid = Grid2D(scene, start_T=cfg.baseT, bc_noslip=cfg.bc_noslip,
                  bc_strength=cfg.bc_strength)
    grid.prepare_frame(0, 0.0)
    tga, jga = tc.grid_arrays(grid, "cpu"), jc.grid_arrays(grid)
    for name in jc.GridArrays2D._fields:
        assert np.array_equal(getattr(tga, name).numpy(),
                              np.asarray(getattr(jga, name))), name
    assert tadi.stream_ok_2d(tga) == jadi.stream_ok_2d(jga) == (False, False)


def _read_cdl(path):
    with open(path) as f:
        text = f.read()
    head, _, body = text.partition("u = \n")
    vals = [float(x) for x in body.replace(";", ",").replace("}", "")
            .replace("\n", "").split(",") if x.strip()]
    return head, np.array(vals)


def test_cli_cdl_matches_jax_cli(tmp_path):
    from cmcfs_tpu import cli2d as jax_cli
    from scripts.gen_box_case import gen_2d
    data, cfgp = gen_2d(str(tmp_path), dx=0.025, time_steps=4)
    with open(cfgp) as f:
        text = f.read()
    with open(cfgp, "w") as f:      # one output frame per step
        f.write(text.replace("out_time_steps \t1000000", "out_time_steps \t1"))
    jax_cli.run_case(data, "", str(tmp_path / "jax.cdl"), cfgp, quiet=True,
                     max_steps=STEPS)
    solver, errs, prof = cli2d.run_case(
        data, "", str(tmp_path / "port.cdl"), cfgp, quiet=True,
        max_steps=STEPS, collect_errs=True, device="cpu")
    assert solver.backend == "fused_dma"
    assert solver.dispatch_report() == {"X": "line", "Y": "line"}
    assert len(errs) == STEPS and all(np.isfinite(errs))
    assert set(prof.events) == {"Prepare", "UpdateBoundaries", "TimeStep",
                                "SetGridBoundaries", "Output"}
    hj, vj = _read_cdl(tmp_path / "jax.cdl")
    hp, vp = _read_cdl(tmp_path / "port.cdl")
    assert hp == hj
    assert vp.shape == vj.shape == (STEPS * 50 * 50,)
    np.testing.assert_allclose(vp, vj, rtol=0, atol=1.0001e-3)


@pytest.mark.parametrize("flag", ["checkpoint", "resume"])
def test_cli_refuses_unported_flag(flag, tmp_path):
    """``checkpoint`` and ``resume`` used to exit 2 (ROADMAP A5); they are
    ported: on the 2D box case (dx 0.025), ``checkpoint`` writes the npz
    and the legacy text layer, and ``resume`` continues from one with
    the steps left."""
    from scripts.gen_box_case import gen_2d
    data, cfgp = gen_2d(str(tmp_path), dx=0.025, time_steps=3)
    ck = str(tmp_path / "ck")
    argv = [data, str(tmp_path / "out.cdl"), cfgp, "quiet"]
    if flag == "resume":
        cli2d.run_case(data, "", str(tmp_path / "first.cdl"), cfgp,
                       quiet=True, max_steps=1, checkpoint=ck, device="cpu")
        argv += ["resume", ck + ".npz"]
    else:
        argv += ["checkpoint", ck]
    assert cli2d.main(argv, device="cpu") == 0
    assert os.path.exists(ck + ".npz")
    assert os.path.exists(ck + ".lastlayer.txt")


def test_solver_2d_needs_cuda_by_default():
    """The 2D solver never picks the CPU itself: its default device is
    CUDA, which raises here."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="is_available"):
        AdiSolver2D()
    assert AdiSolver2D(device="cpu").backend == "fused_dma"
