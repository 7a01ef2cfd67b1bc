"""Guards of the PyTorch port: it never loads JAX, never picks a device or
a path on its own, and refuses what it has not ported; where a refusal
was lifted, the case now holds the port to cmcfs_tpu."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cmcfs_tpu.core.params import FluidParams
from cmcfs_tpu.core.types import BCtype, NodeType
from cmcfs_tpu.geom.synthetic import lid_cavity_3d
from cmcfs_tpu_torch import cli3d
from cmcfs_tpu_torch.device import get_device
from cmcfs_tpu_torch.models import adi3d
from cmcfs_tpu_torch.models.common3d import (grid_arrays, init_state,
                                             merge_ok)
from cmcfs_tpu_torch.models.solver3d import AdiSolver3D, make_solver_3d

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_never_imports_jax():
    """Every module of the port, and chip_smoke.py's imports, load no
    ``jax*`` module and no module of the JAX package."""
    code = ("import importlib, pkgutil, sys\n"
            "import cmcfs_tpu_torch\n"
            "for m in pkgutil.walk_packages(cmcfs_tpu_torch.__path__,\n"
            "                               'cmcfs_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "import chip_smoke, scripts.gen_box_case\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'cmcfs_tpu'))\n"
            "assert not bad, bad\n"
            "assert 'cmcfs_tpu_torch.ops.line_sweep' in sys.modules\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# the port's copies of cmcfs_tpu's JAX-free host modules: verbatim, since
# their imports are relative; native.py differs only in where it builds
HOST_COPIES = ["core/types.py", "core/config.py", "core/params.py",
               "core/scene2d.py", "core/scene3d.py", "geom/raster2d.py",
               "geom/grid3d.py", "geom/synthetic.py", "ops/masks.py",
               "io/netcdf3.py",
               "io/writers.py", "io/project.py", "io/image.py",
               "utils/timer.py", "parallel/balance.py"]


@pytest.mark.parametrize("rel", HOST_COPIES)
def test_host_copies_equal_originals(rel):
    with open(os.path.join(ROOT, "cmcfs_tpu", rel)) as f, \
            open(os.path.join(ROOT, "cmcfs_tpu_torch", rel)) as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("fn", ["save_last_layer_txt", "load_last_layer_txt",
                                "_norm", "save_checkpoint",
                                "load_checkpoint"])
def test_checkpoint_functions_equal_originals(fn):
    """io/checkpoint.py keeps cmcfs_tpu's legacy text and npz tiers
    verbatim (the orbax tier waits for multi-GPU runs, ROADMAP A8)."""
    import inspect
    from cmcfs_tpu.io import checkpoint as jck
    from cmcfs_tpu_torch.io import checkpoint as tck
    assert inspect.getsource(getattr(tck, fn)) == \
        inspect.getsource(getattr(jck, fn))
    assert not hasattr(tck, "save_checkpoint_orbax")


def test_native_source_equals_original():
    with open(os.path.join(ROOT, "native", "geom.cpp"), "rb") as f, \
            open(os.path.join(ROOT, "cmcfs_tpu_torch", "geom", "geom.cpp"),
                 "rb") as g:
        assert f.read() == g.read()


def test_host_grid_build_equals_jax(tmp_path):
    """The port's host grid build and line classes give cmcfs_tpu's arrays
    bit for bit, on the extruded bench box at 65^3."""
    from cmcfs_tpu import cli3d as jax_cli
    from cmcfs_tpu.ops import masks as jm
    from cmcfs_tpu_torch.ops import masks as tm
    from scripts.gen_box_case import gen
    data, cfgp = gen(str(tmp_path), dx=0.0164, time_steps=4, num_global=4,
                     num_local=2)
    tg = cli3d.build_grid(cli3d.load_case(data, cfgp)[0], data)
    jg = jax_cli.build_grid(jax_cli.Config.load(cfgp), data)
    for name in ("types", "bc_vel", "bc_temp", "vel", "T"):
        assert np.array_equal(getattr(tg, name), getattr(jg, name)), name
    assert (tg.dx, tg.dy, tg.dz) == (jg.dx, jg.dy, jg.dz)
    for ax in range(3):
        lt, lj = tm.line_class_3d(tg.types, ax), jm.line_class_3d(jg.types, ax)
        assert np.array_equal(lt.cls_a, lj.cls_a)
        assert (lt.cls_b is None) == (lj.cls_b is None)


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="is_available"):
        get_device("cuda")
    with pytest.raises(RuntimeError):
        AdiSolver3D()               # the default device is CUDA
    assert get_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("flag", ["GPU", "shards", "blocking", "orbax",
                                  "hosts", "balance", "rank", "coordinator"])
def test_cli_refuses_unported_flag(flag, capsys, tmp_path):
    """Multi-host runs and the orbax tier wait for ROADMAP A8 part 3.
    ``GPU n``, ``shards n``, ``balance`` (A8 part 1) and ``blocking`` (the
    Z-blocked wavefront, A8 part 2) used to be refused too; each now runs
    one CPU step of a tiny box case (16^3) split over 2 CPU shards
    (``balance EVEN_VOLUME`` over 3, whose padding plane it places;
    ``blocking 4`` with backend ``scan``, whose X direction takes the
    fallback and so the wavefront) and writes the unsharded run's NetCDF
    file byte for byte."""
    if flag not in ("GPU", "shards", "balance", "blocking"):
        argv = ["data.txt", "out", "config.txt", flag]
        if flag in ("hosts", "rank", "coordinator"):
            argv.append("2")
        assert cli3d.main(argv) == 2
        err = capsys.readouterr().err
        assert "ROADMAP A8 part 3" in err
        return
    from scripts.gen_box_case import gen
    data, cfgp = gen(str(tmp_path / "case"), dx=0.07, time_steps=2,
                     num_global=1, num_local=2)
    with open(cfgp) as f:
        text = f.read()
    with open(cfgp, "w") as f:
        f.write(text.replace("out_time_steps \t1000000",
                             "out_time_steps \t1"))
    split = {"GPU": ["GPU", "2"], "shards": ["shards", "2"],
             "balance": ["shards", "3", "balance", "EVEN_VOLUME"],
             "blocking": ["shards", "2", "blocking", "4"]}[flag]
    both = ["backend", "scan"] if flag == "blocking" else []
    outs = []
    for name, extra in (("one", []), ("split", split)):
        base = str(tmp_path / name)
        assert cli3d.main([data, base, cfgp, "quiet"] + both + extra,
                          device="cpu") == 0
        with open(base + "_res.nc", "rb") as f:
            outs.append(f.read())
    assert outs[0] == outs[1]


@pytest.mark.parametrize("flag", ["checkpoint", "resume", "carried", "profile",
                                  "dump_grid"])
def test_cli_accepts_ported_flag(flag, tmp_path):
    """The single-card flags, refused until ROADMAP A5 was ported: each
    parses and runs one CPU step of a tiny box case (16^3)."""
    from scripts.gen_box_case import gen
    data, cfgp = gen(str(tmp_path / "case"), dx=0.07, time_steps=2,
                     num_global=1, num_local=2)
    base = str(tmp_path / "out")
    argv = [data, base, cfgp, flag, "quiet"]
    if flag == "checkpoint":
        argv.insert(4, base + "_ck")
    if flag == "resume":
        # a checkpoint of the state before the one step: step 0 at t = 0
        solver, _ = cli3d.run_case(data, base, cfgp, quiet=True,
                                   max_steps=1, device="cpu")
        from cmcfs_tpu_torch.io.checkpoint import save_checkpoint
        fields = {k: f.numpy() for k, f in
                  zip(("u", "v", "w", "T", "nu", "nv", "nw", "nT"),
                      tuple(solver.next) + tuple(solver.next))}
        save_checkpoint(base + "_ck", 0, 0.0, **fields)
        argv.insert(4, base + "_ck.npz")
    assert cli3d.main(argv, device="cpu") == 0
    assert os.path.getsize(base + "_res.nc") > 0
    if flag == "checkpoint":
        assert os.path.exists(base + "_ck.npz")
    if flag == "dump_grid":
        assert len(os.listdir(base + "_grid_3d")) > 0


def _box():
    grid = lid_cavity_3d(16, 14, 12)
    return grid, grid_arrays(grid, "cpu")


@pytest.mark.parametrize("case", ["pcr", "fused_pcr", "fused_pcr_bf16",
                                  "fused_bf16"])
def test_unported_dispatch_raises(case):
    """Every backend of these cases used to raise; all are ported now.  One
    step of each on the lid cavity against cmcfs_tpu's exact-order
    ``scan`` step: ``pcr`` and ``fused_pcr`` within 5e-6, the bound
    test_backends3d.py holds cmcfs_tpu's own PCR steps to; the bf16
    backends (``fused_bf16``, ``fused_pcr_bf16``: the kernels' payloads
    stored in bf16) within 0.02, the bound of its
    test_bf16_storage_close_to_f32 and test_fused_pcr_bf16_close_to_f32,
    with their dispatch (``dirs``, ``pcr``, ``bf16``) equal to
    cmcfs_tpu's."""
    grid, ga = _box()
    pa = adi3d.make_params(FluidParams.normalized(200.0, 0.72, 1.4),
                           grid.dx, grid.dy, grid.dz)
    _step_matches_scan(grid, ga, pa, case,
                       5e-6 if case in ("pcr", "fused_pcr") else 0.02)
    assert AdiSolver3D(backend=case, device="cpu").backend == case


def _step_matches_scan(grid, ga, pa, backend, atol):
    import jax.numpy as jnp
    from cmcfs_tpu.models import adi3d as jadi
    from cmcfs_tpu.models import common3d as jc
    jga, jcur = jc.grid_arrays(grid), jc.init_state(grid)
    mok = merge_ok(ga)
    want_rep = jadi.dispatch_report(tuple(ga.types.shape), jga, backend, 2,
                                    mok)
    rep = adi3d.dispatch_report(tuple(ga.types.shape), (False,) * 3,
                                backend, 2, mok)
    for key in ("dirs", "pcr", "bf16", "backend", "pad"):
        assert rep[key] == want_rep[key], key
    jpa = jadi.ParamsArgs3D(*(jnp.float32(x) for x in pa))
    want, _ = jadi.adi_timestep_3d(jcur, jcur, jga, jnp.float32(0.01), 1, 2,
                                   jpa, backend="scan")
    cur = init_state(grid, "cpu")
    got, _ = adi3d.adi_timestep_3d(cur, cur, ga, 0.01, 1, 2, pa,
                                   backend=backend, merge_ok=mok)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=atol)


def test_dispatch_report_names_paths():
    rep = adi3d.dispatch_report((64, 64, 64), (False, False, False), "auto",
                                3, (True, False, True))
    assert rep == {"backend": "fused_nl", "pad": None, "pcr": False,
                   "bf16": False,
                   "dirs": {"X": "pair+stream", "Y": "fallback",
                            "Z": "pair+stream"}}


def test_bf16_horizon_warning():
    """The CLI warns of bf16 drift on runs longer than
    BF16_STEP_WARN_THRESHOLD steps, and only for the bf16 backends (as
    tests/test_backends3d.py:153-162 holds cmcfs_tpu's), with cmcfs_tpu's
    words."""
    from cmcfs_tpu import cli3d as jcli
    warn = cli3d.bf16_horizon_warning
    n = cli3d.BF16_STEP_WARN_THRESHOLD
    assert n == jcli.BF16_STEP_WARN_THRESHOLD == 200
    assert warn("fused_bf16", n + 1)
    assert "fused_bf16" in warn("fused_bf16", 1000)
    assert "fused_pcr_bf16" in warn("fused_pcr_bf16", 1000)
    assert warn("fused_bf16", 10) is None
    assert warn("fused_bf16", n) is None
    assert warn("fused_full", 100000) is None
    assert warn("scan", 100000) is None
    for case in (("fused_bf16", 1000), ("fused_pcr_bf16", n + 1),
                 ("fused_bf16", 10), ("fused_nl", 1000)):
        assert warn(*case) == jcli.bf16_horizon_warning(*case)


@pytest.mark.parametrize("name", ["Explicit", "Stable"])
def test_unported_solvers_raise(name):
    """Explicit and Stable used to raise (ROADMAP A4); they build on the
    CPU and one step on tests/test_solvers3d_ext.py's lid cavity (16^3)
    equals cmcfs_tpu's within 1e-6 * max(1, max|field|)."""
    from cmcfs_tpu.models.solver3d import make_solver_3d as jax_make
    grid = lid_cavity_3d(16, 16, 16, dx=0.02, lid_velocity=0.2)
    params = FluidParams.normalized(200.0, 0.72, 1.4)
    port, ref = make_solver_3d(name, device="cpu"), jax_make(name)
    assert port.name == ref.name == name
    for s in (port, ref):
        s.init(grid, params)
        s.update_boundaries()
        s.time_step(0.01, 2, 1)
    assert abs(port.last_err - ref.last_err) <= 1e-4 * ref.last_err
    for g, w in zip(port.cur, ref.cur):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-6 * max(1.0, np.abs(w).max()))


def test_free_dual_grid_raises():
    """A FREE-bc baffle with a hole leaves dual endpoints on X lines:
    ``grid_arrays`` keeps cmcfs_tpu's pass B (cls_b/take_b, inert duals
    elided on the other axes).  X dispatches ``pair`` at num_local 2; it
    used to raise, and now runs the pair kernel's second chain (its plain
    version here) and matches cmcfs_tpu's step on the same grid (the
    exact-order ``scan`` path's two-pass stitch) within 1e-5 *
    max|state|, test_torch_dispatch3d.py's bound."""
    import jax.numpy as jnp
    from cmcfs_tpu.models import adi3d as jadi
    from cmcfs_tpu.models import common3d as jc
    grid = lid_cavity_3d(20, 12, 12)
    mid = 10
    baffle = np.zeros(grid.types.shape, dtype=bool)
    baffle[mid, 2:-2, 2:-2] = True
    grid.types[baffle] = NodeType.BOUND
    grid.types[mid, 5:7, 2:-2] = NodeType.IN
    grid.bc_temp[baffle] = BCtype.FREE
    ga, jga = grid_arrays(grid, "cpu"), jc.grid_arrays(grid)
    assert ga.cls_b[0] is not None
    for ax in range(3):
        assert np.array_equal(ga.cls_a[ax].numpy(), np.asarray(jga.cls_a[ax]))
        for mine, ref in ((ga.cls_b[ax], jga.cls_b[ax]),
                          (ga.take_b[ax], jga.take_b[ax])):
            assert (mine is None) == (ref is None)
            if ref is not None:
                assert np.array_equal(mine.numpy(), np.asarray(ref))
    pa = adi3d.make_params(FluidParams.normalized(200.0, 0.72, 1.4),
                           grid.dx, grid.dy, grid.dz)
    mok = merge_ok(ga)
    assert adi3d.dispatch_report((20, 12, 12), (True, False, False), "auto",
                                 2, mok)["dirs"]["X"] == "pair"
    jcur = jc.init_state(grid)
    jpa = jadi.ParamsArgs3D(*(jnp.float32(x) for x in pa))
    want, _ = jadi.adi_timestep_3d(jcur, jcur, jga, jnp.float32(0.01), 1, 2,
                                   jpa, backend="scan")
    cur = init_state(grid, "cpu")
    got, _ = adi3d.adi_timestep_3d(cur, cur, ga, 0.01, 1, 2, pa, merge_ok=mok)
    want = [np.asarray(w) for w in want]
    bound = 1e-5 * max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=bound)
