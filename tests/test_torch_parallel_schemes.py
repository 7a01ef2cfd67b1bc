"""The Explicit and Stable schemes split over X (``set_plan`` on
``ExplicitSolver3D`` / ``StableSolver3D``, ``plan=`` of their steps) on
CPU shards.

* Over 2, 3 and 4 shards, under each balance policy (none, EVEN_X,
  EVEN_SEGMENTS, EVEN_VOLUME) on a 19 x 10 x 9 twin cavity (tests/
  test_torch_parallel.py), whose balanced padding cuts mid-domain, from a
  state with seeded noise on its IN cells: two steps at ng=2 bit for bit
  the port's single device, fields and Poisson iteration counts, the
  divergence error within 1e-6 relative (its sums run in another order
  over the shards).  The red-black colours follow the grid's X index, so
  a cut that moves planes does not move the colours.
* Against cmcfs_tpu's schemes sharded through GSPMD on its virtual CPU
  mesh (tests/conftest.py), with the padding it stores at the grid's end
  only (18 planes over 4 shards), two steps of the 18 x 16 x 16 lid cavity
  of tests/torch_schemes.py: within the scheme tests' REL = 1e-6 x max(1,
  max|field|) (tests/torch_schemes.py) and the error within 1e-4
  relative, as tests/test_torch_{explicit,stable}3d.py hold the single
  device.
"""
import functools

import numpy as np
import pytest
import torch

from cmcfs_tpu.models.solver3d import make_solver_3d as jax_solver
from cmcfs_tpu.parallel.mesh import make_x_mesh as jax_mesh
from cmcfs_tpu_torch.core.params import FluidParams
from cmcfs_tpu_torch.core.types import NodeType
from cmcfs_tpu_torch.geom.synthetic import lid_cavity_3d
from cmcfs_tpu_torch.models.solver3d import make_solver_3d
from cmcfs_tpu_torch.parallel.mesh import make_x_mesh
from test_torch_parallel import twin_cavity
from torch_schemes import REL, assert_close

PARAMS = FluidParams.normalized(200.0, 0.72, 1.4)
# inside the explicit limit dx^2 / (6 nu) = 3.3e-3 of the twin cavity
DT = 0.002


def _noisy(solver, seed=3):
    """The grid's state with seeded noise (0.02) on the IN cells, as the
    solver's cur and next."""
    cur, _ = solver.state()
    rng = np.random.default_rng(seed)
    is_in = np.asarray(solver.grid.types) == NodeType.IN
    fields = [np.where(is_in, f.cpu().numpy() + 0.02 * rng.standard_normal(
        is_in.shape), f.cpu().numpy()).astype(np.float32) for f in cur]
    solver.set_state(fields, fields)


def _run(scheme, grid, shards=1, balance=None, steps=2):
    """``steps`` steps from the noisy state: (each step's (state, error,
    Poisson counts), the solver)."""
    s = make_solver_3d(scheme, device="cpu")
    s.init(grid, PARAMS)
    _noisy(s)
    if shards > 1:
        s.set_plan(make_x_mesh(devices=["cpu"] * shards), balance=balance)
    out = []
    for _ in range(steps):
        s.update_boundaries()
        s.time_step(DT, 2, 1)
        out.append((torch.stack(tuple(s.state()[0])), s.last_err,
                    list(getattr(s, "last_poisson_iters", ()))))
    return out, s


def _twin():
    return twin_cavity(9, 10, 10, 9)


@functools.lru_cache(maxsize=None)
def _single(scheme):
    return _run(scheme, _twin())[0]


@pytest.mark.parametrize("shards, balance", [
    (2, None), (3, None), (4, None), (2, "EVEN_X"), (4, "EVEN_SEGMENTS"),
    (4, "EVEN_VOLUME")])
@pytest.mark.parametrize("scheme", ["Explicit", "Stable"])
def test_split_scheme_bitwise(scheme, shards, balance):
    grid = _twin()
    one = _single(scheme)
    split, s = _run(scheme, grid, shards, balance)
    assert s.plan.n == shards and sum(s.x_cuts) == grid.dimx
    for (a, ea, ia), (b, eb, ib) in zip(one, split):
        assert torch.equal(a, b), float((a - b).abs().max())
        assert abs(ea - eb) <= 1e-6 * abs(ea)
        assert ia == ib
        if scheme == "Stable":
            assert all(1 < i < 4000 for i in ia)


def test_balanced_cuts_move_planes():
    """The balanced cuts of the cases above differ from the even ones, so
    those cases move planes between shards."""
    cuts = {b: _run("Explicit", _twin(), 4, b, steps=0)[1].x_cuts
            for b in (None, "EVEN_SEGMENTS", "EVEN_VOLUME")}
    assert cuts[None] == [5, 5, 5, 4]
    assert cuts["EVEN_SEGMENTS"] != cuts[None] != cuts["EVEN_VOLUME"]


@pytest.mark.parametrize("scheme", ["Explicit", "Stable"])
@pytest.mark.parametrize("shards", [2, 4])
def test_split_scheme_matches_jax(scheme, shards):
    grid = lid_cavity_3d(18, 16, 16, dx=0.02, lid_velocity=0.2)
    ref = jax_solver(scheme, backend="scan")
    ref.init(grid, PARAMS)
    ref.set_plan(jax_mesh(shards))
    assert ref._x_keep is None        # the padding, if any, at the end
    port = make_solver_3d(scheme, device="cpu")
    port.init(grid, PARAMS)
    port.set_plan(make_x_mesh(devices=["cpu"] * shards))
    for _ in range(2):
        for s in (ref, port):
            s.update_boundaries()
            s.time_step(0.01, 2, 1)
        want = [np.asarray(f)[:grid.dimx] for f in ref.cur]
        assert_close(tuple(port.state()[0]), want, REL)
        assert abs(port.last_err - ref.last_err) <= 1e-4 * abs(ref.last_err)
