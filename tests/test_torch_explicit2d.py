"""The port's 2D Explicit scheme (cmcfs_tpu_torch/models/explicit2d.py)
against cmcfs_tpu's on the CPU: one ``_explicit_update`` on a random
state, and 3 steps on tests/test_solvers2d.py's synthetic lid cavity and
from a random state, with the global loop's iteration count and error.
Tolerance: torch_schemes.REL = 1e-6 * max(1, max|field|) per variable
(measured 9.9e-8).
"""
import jax.numpy as jnp
import numpy as np

from cmcfs_tpu.models import common2d as jc
from cmcfs_tpu.models import explicit2d as jex
from cmcfs_tpu_torch.models import common2d, explicit2d
from tests.torch_schemes import assert_close, both, cavity2d, random_state

DT = 0.002             # inside the explicit limit dx^2 / (4 nu) = 0.00375


def test_explicit_update_matches_jax():
    grid, (jcur, jga, jpa), (_, ga, pa) = cavity2d(20, 18)
    jc_r, c_r = both(random_state(jcur, jga.types, 1), jc.State2D,
                     common2d.State2D)
    jt, t = both(random_state(jcur, jga.types, 2), jc.State2D,
                 common2d.State2D)
    want = jex._explicit_update(jc_r, jt, jpa, jnp.float32(DT))
    got = explicit2d._explicit_update(c_r, t, pa, DT)
    assert_close(got, want)


def _steps(jcur, jga, jpa, cur, ga, pa, num_global=2, steps=3):
    for _ in range(steps):
        want, werr, wit = jex.explicit_timestep_2d(
            jcur, jcur, jga, jnp.float32(DT), jnp.int32(num_global), 1, jpa)
        got, err, it = explicit2d.explicit_timestep_2d(cur, cur, ga, DT,
                                                       num_global, 1, pa)
        assert it == int(wit) >= num_global
        assert abs(float(err) - float(werr)) <= 1e-4 * abs(float(werr))
        assert_close(got, want)
        jcur, cur = want, got
    assert np.abs(np.asarray(jcur.v)).max() > 0


def test_explicit_steps_lid_cavity():
    grid, (jcur, jga, jpa), (cur, ga, pa) = cavity2d(24, 20)
    _steps(jcur, jga, jpa, cur, ga, pa)


def test_explicit_steps_random_state():
    """From this random state the divergence error stays above 0.1, so the
    first step's global loop runs past num_global = 1 to its cap (102
    iterations) and the second stops at 1, in both packages alike."""
    grid, (jcur, jga, jpa), (_, ga, pa) = cavity2d(20, 18)
    jcur, cur = both(random_state(jcur, jga.types, 3, 0.3), jc.State2D,
                     common2d.State2D)
    _steps(jcur, jga, jpa, cur, ga, pa, num_global=1, steps=2)
