"""The 3D step with the row backend ``pcr`` (materialized rows solved by
cyclic reduction, ``ops/pcr.py``; u, v and w on shared rows) against
cmcfs_tpu's ``pcr`` step on ``__graft_entry__._setup(32, 19, 21)``
(test_backends3d.py's setup), one step of num_global 2, num_local 2, both
``exact`` modes, on the CPU.  Bound 1e-5 * max|state|,
test_torch_dispatch3d.py's: both packages build the rows and right-hand
sides dividing by 2h and dt and reduce in the same order, so the steps
differ by contracted FMAs only.  The divergence error within 1e-4
relative (a full-grid sum in another order).
"""
import numpy as np
import jax.numpy as jnp
import pytest

import __graft_entry__ as entry
from cmcfs_tpu_torch.models import adi3d as tadi
from cmcfs_tpu_torch.models.common3d import from_jax_numpy
from cmcfs_tpu_torch.ops import tridiag_rows as tr

REL = 1e-5


@pytest.mark.parametrize("exact", [True, False])
def test_pcr_backend_step_3d_matches_jax(exact):
    jadi, ga, cur, pa = entry._setup(32, 19, 21, "scan")
    dt = jnp.float32(0.01)
    want, j_err = jadi.adi_timestep_3d(cur, cur, ga, dt, 2, 2, pa,
                                       backend="pcr", exact=exact)
    st, tga, tpa = from_jax_numpy(cur, ga, pa, "cpu")
    assert tadi.dispatch_report(tuple(tga.types.shape), (False,) * 3, "pcr",
                                2)["dirs"] == {"X": "fallback",
                                               "Y": "fallback",
                                               "Z": "fallback"}
    before = tr.launches.count
    got, t_err = tadi.adi_timestep_3d(st, st, tga, 0.01, 2, 2, tpa,
                                      backend="pcr", exact=exact)
    assert tr.launches.count == before
    want = [np.asarray(w) for w in want]
    bound = REL * max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=bound)
    assert abs(float(t_err) - float(j_err)) <= 1e-4 * float(j_err)
