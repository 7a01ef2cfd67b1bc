"""Guards of the PyTorch port: it never loads JAX, never picks a device or
a path on its own, and refuses what it has not ported."""
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
from cmcfs_tpu_torch.models.common3d import grid_arrays
from cmcfs_tpu_torch.models.solver3d import AdiSolver3D, make_solver_3d

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_never_imports_jax():
    code = ("import sys\n"
            "import cmcfs_tpu_torch, cmcfs_tpu_torch.cli3d\n"
            "import cmcfs_tpu_torch.models.adi3d, cmcfs_tpu_torch.models.solver3d\n"
            "import cmcfs_tpu_torch.ops.pair_sweep, cmcfs_tpu_torch.kernels.build\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "assert 'cmcfs_tpu.models' not in sys.modules\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


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


@pytest.mark.parametrize("case", ["odd_num_local", "num_local_1",
                                  "merge_not_ok", "backend_scan"])
def test_unported_dispatch_raises(case):
    grid, ga = _box()
    pa = adi3d.make_params(FluidParams.normalized(200.0, 0.72, 1.4),
                           grid.dx, grid.dy, grid.dz)
    cur = tuple(torch.zeros(ga.types.shape) for _ in range(4))
    kw = dict(num_local=2, backend="auto", merge_ok=(True, True, True))
    if case == "odd_num_local":
        kw["num_local"] = 3
    elif case == "num_local_1":
        kw["num_local"] = 1
    elif case == "merge_not_ok":
        kw["merge_ok"] = (True, False, True)
    else:
        kw["backend"] = "scan"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        adi3d.adi_timestep_3d(cur, cur, ga, 0.01, 1, pa=pa, **kw)


def test_dispatch_report_names_paths():
    rep = adi3d.dispatch_report("auto", 3, (True, False, True))
    assert rep == {"backend": "fused_nl",
                   "dirs": {"X": "pair+stream", "Y": "fallback",
                            "Z": "pair+stream"}}


@pytest.mark.parametrize("name", ["Explicit", "Stable"])
def test_unported_solvers_raise(name):
    with pytest.raises(NotImplementedError, match="A8"):
        make_solver_3d(name, device="cpu")


def test_free_dual_grid_raises():
    """A FREE-bc baffle with a hole leaves dual endpoints on X lines that
    need the pair kernel's second chain (not ported)."""
    grid = lid_cavity_3d(20, 12, 12)
    mid = 10
    baffle = np.zeros(grid.types.shape, dtype=bool)
    baffle[mid, 2:-2, 2:-2] = True
    grid.types[baffle] = NodeType.BOUND
    grid.types[mid, 5:7, 2:-2] = NodeType.IN
    grid.bc_temp[baffle] = BCtype.FREE
    with pytest.raises(NotImplementedError, match="B1"):
        grid_arrays(grid, "cpu")
