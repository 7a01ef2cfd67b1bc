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
               "io/writers.py", "io/project.py", "utils/timer.py"]


@pytest.mark.parametrize("rel", HOST_COPIES)
def test_host_copies_equal_originals(rel):
    with open(os.path.join(ROOT, "cmcfs_tpu", rel)) as f, \
            open(os.path.join(ROOT, "cmcfs_tpu_torch", rel)) as g:
        assert f.read() == g.read()


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


@pytest.mark.parametrize("flag", ["GPU", "shards", "blocking", "checkpoint",
                                  "resume", "carried", "profile", "orbax",
                                  "dump_grid", "hosts", "balance"])
def test_cli_refuses_unported_flag(flag, capsys):
    argv = ["data.txt", "out", "config.txt", flag]
    if flag in ("shards", "checkpoint", "resume", "hosts", "balance"):
        argv.append("2")
    assert cli3d.main(argv) == 2
    assert "ROADMAP" in capsys.readouterr().err


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
    with pytest.raises(NotImplementedError, match="A4"):
        make_solver_3d(name, device="cpu")


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
