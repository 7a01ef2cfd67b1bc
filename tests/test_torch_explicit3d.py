"""The port's 3D Explicit scheme (cmcfs_tpu_torch/models/explicit3d.py)
against cmcfs_tpu's on the CPU: the second difference ``stencil.d2``,
one ``_explicit_update`` on a random state, and 3 steps on
tests/test_solvers3d_ext.py's lid cavity at 24^3 and from a random state.
Tolerances: ``d2`` bit for bit (the same operations, each rounded once);
the rest within torch_schemes.REL = 1e-6 * max(1, max|field|) per
variable (measured 2.2e-7: a few float32 ulps where XLA contracts).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmcfs_tpu.models import common3d as jc
from cmcfs_tpu.models import explicit3d as jex
from cmcfs_tpu.ops import stencil as jst
from cmcfs_tpu_torch.models import common3d
from cmcfs_tpu_torch.models import explicit3d
from cmcfs_tpu_torch.ops import stencil
from tests.torch_schemes import assert_close, both, cavity3d, random_state

DT = 0.01              # tests/test_solvers3d_ext.py's; dx^2 / (6 nu) = 0.0133


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_d2_matches_jax(axis):
    rng = np.random.default_rng(axis)
    f = rng.standard_normal((9, 10, 11)).astype(np.float32)
    h = np.float32(0.0173)
    want = np.asarray(jst.d2(jnp.asarray(f), jnp.float32(h), axis))
    got = stencil.d2(torch.tensor(f), h, axis).numpy()
    np.testing.assert_array_equal(got, want)


def test_explicit_update_matches_jax():
    grid, (jcur, jga, jpa), (cur, ga, pa) = cavity3d(16)
    jcur_r, cur_r = both(random_state(jcur, jga.types, 1), jc.State3D,
                         common3d.State3D)
    jtemp, temp = both(random_state(jcur, jga.types, 2), jc.State3D,
                       common3d.State3D)
    want = jex._explicit_update(jcur_r, jtemp, jpa, jnp.float32(DT))
    got = explicit3d._explicit_update(cur_r, temp, pa, DT)
    assert_close(got, want)


def _steps(jcur, jnxt, jga, jpa, cur, nxt, ga, pa, steps=3):
    for _ in range(steps):
        want, werr = jex.explicit_timestep_3d(jcur, jnxt, jga,
                                              jnp.float32(DT), 2, 1, jpa)
        got, err = explicit3d.explicit_timestep_3d(cur, nxt, ga, DT, 2, 1, pa)
        assert_close(got, want)
        assert abs(float(err) - float(werr)) <= 1e-4 * abs(float(werr))
        jnxt, jcur = jcur, want
        nxt, cur = cur, got
    assert np.abs(np.asarray(jcur.u)).max() > 0


def test_explicit_steps_lid_cavity():
    """Three steps with the solver's swap (next <- cur) at ng=2."""
    grid, (jcur, jga, jpa), (cur, ga, pa) = cavity3d(24)
    _steps(jcur, jcur, jga, jpa, cur, cur, ga, pa)


def test_explicit_steps_random_state():
    grid, (jcur, jga, jpa), (_, ga, pa) = cavity3d(16)
    jcur, cur = both(random_state(jcur, jga.types, 3, 0.02), jc.State3D,
                     common3d.State3D)
    _steps(jcur, jcur, jga, jpa, cur, cur, ga, pa)
