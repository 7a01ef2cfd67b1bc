"""The port's X split against cmcfs_tpu's, on the CPU.

* ``set_plan``: the padded layout (``padded_types``) equals cmcfs_tpu's
  padded ``types`` (``array_equal``), trailing and balanced, and the port
  cuts X where cmcfs_tpu's even split of it cuts;
* ``dispatch_report(..., plan)`` equals cmcfs_tpu's over
  test_torch_dispatch3d.py's shapes and backends, num_local 1-4, merge_ok,
  duals and 2, 3 and 4 shards;
* the slice as a whole: cmcfs_tpu's ``AdiSolver3D(backend="scan")`` with
  ``set_plan(make_x_mesh(N))`` on the virtual CPU mesh (tests/conftest.py)
  against the port's solver over N CPU shards, from the same state and
  parameters (``from_jax_numpy``), two steps: the port's ``scan`` within
  rtol 1e-6, atol 1e-7 (tests/test_parallel.py:51), its ``fused_nl``
  within rtol 2e-5, atol 1e-6 (tests/test_parallel.py:122: the pair
  kernel multiplies by 1/(2h) where the rows divide).  No case runs
  cmcfs_tpu's sharded ``fused_nl``: its interpret-mode kernels take
  minutes (tests/test_parallel.py ran 2908 s).
"""
import itertools
from typing import NamedTuple

import numpy as np
import pytest

from cmcfs_tpu.core.params import FluidParams
from cmcfs_tpu.geom.synthetic import lid_cavity_3d as jax_lid
from cmcfs_tpu.models import adi3d as jadi
from cmcfs_tpu.models.solver3d import AdiSolver3D as JaxSolver
from cmcfs_tpu.parallel.mesh import make_x_mesh as jax_mesh
from cmcfs_tpu_torch.geom.synthetic import lid_cavity_3d
from cmcfs_tpu_torch.models import adi3d as tadi
from cmcfs_tpu_torch.models.common3d import from_jax_numpy
from cmcfs_tpu_torch.models.solver3d import AdiSolver3D
from cmcfs_tpu_torch.parallel.mesh import make_x_mesh
from test_torch_dispatch3d import DUALS, MERGE, SHAPES
from test_torch_parallel import twin_cavity

PARAMS = FluidParams.normalized(200.0, 0.72, 1.4)


def _cpu_plan(n):
    return make_x_mesh(devices=["cpu"] * n)


@pytest.mark.parametrize("balance", [None, "EVEN_SEGMENTS", "EVEN_VOLUME"])
@pytest.mark.parametrize("shards", [2, 3, 4])
def test_set_plan_padding_matches_jax(shards, balance):
    """The padded types equal cmcfs_tpu's; each shard owns the grid's
    planes among the padded planes cmcfs_tpu's even split gives it."""
    grid = twin_cavity()
    ref = JaxSolver(backend="scan")
    ref.init(grid, PARAMS)
    ref.set_plan(jax_mesh(shards), balance=balance)
    port = AdiSolver3D(backend="scan", device="cpu")
    port.init(grid, PARAMS)
    port.set_plan(_cpu_plan(shards), balance=balance)
    padded = np.asarray(ref.ga.types)
    assert np.array_equal(port.padded_types, padded)
    s = padded.shape[0] // shards
    keep = getattr(ref, "_x_keep", None)
    real = (np.arange(padded.shape[0]) < grid.dimx if keep is None
            else np.isin(np.arange(padded.shape[0]), keep))
    assert port.x_cuts == [int(real[i * s:(i + 1) * s].sum())
                           for i in range(shards)]


class _Duals(NamedTuple):
    cls_b: tuple


@pytest.mark.parametrize("shards", [2, 3, 4])
def test_dispatch_report_with_plan_matches_jax(shards):
    jplan, tplan = jax_mesh(shards), _cpu_plan(shards)
    for shape, backend, nl, mok, duals in itertools.product(
            SHAPES, tadi.BACKENDS, (1, 2, 3, 4), MERGE, DUALS):
        ga = _Duals(tuple(object() if d else None for d in duals))
        want = jadi.dispatch_report(shape, ga, backend, nl, mok, jplan)
        got = tadi.dispatch_report(shape, duals, backend, nl, mok, tplan)
        case = (shape, backend, nl, mok, duals, shards)
        for key in ("dirs", "pad", "backend", "pcr", "bf16"):
            assert got[key] == want[key], (key, case)


def test_auto_under_a_plan_is_fused_nl():
    """``auto`` stays ``fused_nl`` under a plan, as cmcfs_tpu resolves it
    on its target, the TPU (off the TPU it picks ``fused``)."""
    rep = tadi.dispatch_report((64, 64, 64), (False,) * 3, "auto", 2,
                               (True,) * 3, _cpu_plan(2))
    assert rep["backend"] == "fused_nl"
    assert set(rep["dirs"].values()) == {"pair"}


@pytest.mark.parametrize("backend, shards, rtol, atol", [
    ("scan", 2, 1e-6, 1e-7), ("scan", 4, 1e-6, 1e-7),
    ("fused_nl", 4, 2e-5, 1e-6)])
def test_sharded_step_matches_jax_scan(backend, shards, rtol, atol):
    grid = jax_lid(16, 14, 12)
    ref = JaxSolver(backend="scan")
    ref.init(grid, PARAMS)
    ref.set_plan(jax_mesh(shards))
    port = AdiSolver3D(backend=backend, device="cpu")
    port.init(lid_cavity_3d(16, 14, 12), PARAMS)
    port.set_plan(_cpu_plan(shards))
    st, _, pa = from_jax_numpy(ref.cur, ref.ga, ref.pa, "cpu")
    port.set_state(st, st)
    port.pa = pa
    for _ in range(2):
        for s in (ref, port):
            s.update_boundaries()
            s.time_step(0.01, 2, 2)
        assert abs(port.last_err - ref.last_err) <= 1e-5 * ref.last_err
    for got, want in zip(port.state()[0], ref.cur):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=rtol, atol=atol)
