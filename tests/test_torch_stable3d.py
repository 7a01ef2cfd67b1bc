"""The port's 3D Stable scheme (cmcfs_tpu_torch/models/stable3d.py)
against cmcfs_tpu's on the CPU: one ``_poisson_project`` from random
intermediate velocities, a NaN's stop, and steps on
tests/test_solvers3d_ext.py's lid cavity (16^3 and 24^3); and the Poisson
loop read on the host every 16 iterations against every iteration, bit
for bit.  Tolerance: torch_schemes.REL = 1e-6 * max(1, max|field|) per
variable (measured 1.5e-8).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmcfs_tpu.models import stable3d as jsb
from cmcfs_tpu_torch.models import common3d, poisson, stable3d
from tests.torch_schemes import assert_close, cavity3d, random_state

DT = 0.01


def _w_fields(jcur, jga, seed):
    """Random intermediate velocities (wu, wv, ww) on IN cells."""
    return random_state(tuple(jcur)[:3], jga.types, seed, 0.02)


def test_poisson_project_matches_jax():
    grid, (jcur, jga, jpa), (_, ga, pa) = cavity3d(16)
    w = _w_fields(jcur, jga, 4)
    want = jsb._poisson_project(*(jnp.asarray(f) for f in w), jga, jpa)
    got, iters = stable3d._poisson_project(*(torch.tensor(f) for f in w),
                                           ga, pa)
    assert 1 < iters < poisson.MAX_POISSON_ITERS
    assert_close(got, want)


def test_poisson_nan_stops_like_jax():
    """A NaN in the divergence makes the error NaN, which ends the loop
    after one iteration, as cmcfs_tpu's while loop ends (NaN >= 1e-2 is
    false); the NaNs land where cmcfs_tpu's do."""
    grid, (jcur, jga, jpa), (_, ga, pa) = cavity3d(12)
    w = _w_fields(jcur, jga, 5)
    w[0][6, 6, 6] = np.nan
    want = jsb._poisson_project(*(jnp.asarray(f) for f in w), jga, jpa)
    got, iters = stable3d._poisson_project(*(torch.tensor(f) for f in w),
                                           ga, pa)
    assert iters == 1
    for g, wnt in zip(got, want):
        assert np.array_equal(np.isnan(g.numpy()), np.isnan(np.asarray(wnt)))
    assert_close(got, want)


@pytest.mark.parametrize("n", [16, 24])
def test_stable_steps_match_jax(n):
    """Two steps at ng=2 with the solver's swap; the Poisson counts of
    each global iteration are recorded (175 at 24^3 in the first step)."""
    grid, (jcur, jga, jpa), (cur, ga, pa) = cavity3d(n)
    jnxt, nxt = jcur, cur
    for _ in range(2):
        want, werr = jsb.stable_timestep_3d(jcur, jnxt, jga, jnp.float32(DT),
                                            2, 1, jpa)
        got, err, iters = stable3d.stable_timestep_3d(cur, nxt, ga, DT, 2, 1,
                                                      pa)
        assert len(iters) == 2 and all(1 < i < 4000 for i in iters)
        assert_close(got, want)
        assert abs(float(err) - float(werr)) <= 1e-4 * abs(float(werr))
        jnxt, jcur = jcur, want
        nxt, cur = cur, got


def test_check_every_bitwise():
    """Reading the loop's state on the host every iteration (k = 1, the
    while loop) and every 16 gives the same fields bit for bit and the
    same iteration counts: an iteration past convergence changes
    nothing."""
    grid, (jcur, jga, _), (_, ga, pa) = cavity3d(16)
    cur = common3d.State3D(*(torch.tensor(f) for f in
                             random_state(jcur, jga.types, 6, 0.02)))
    runs = [stable3d.stable_timestep_3d(cur, cur, ga, DT, 2, 1, pa,
                                        check_every=k) for k in (1, 16)]
    (a, ea, ia), (b, eb, ib) = runs
    assert ia == ib
    assert any(i % 16 for i in ia), ia      # the k = 16 run overshoots
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(ea, eb)
