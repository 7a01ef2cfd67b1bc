"""The port's ``fused_pcr`` step (every ``pair`` direction on the PCR pair
sweep, ``ops/pcr_sweep.py``, as its plain version here) against
cmcfs_tpu's exact-order ``scan`` step, on the CPU, at 5e-6 absolute:
test_backends3d.py's and test_duals.py's bound for cmcfs_tpu's own
``fused_pcr`` against ``scan`` (PCR eliminates in another order than
Thomas; measured 7.2e-7 on the lid cavity, and the port's PCR step within
3.6e-7 of cmcfs_tpu's, whose interpret-mode step takes 87 s here).

* the lid cavity at 32 x 19 x 21 (test_backends3d.py's setup), one step of
  num_global 2, num_local 2 (all three directions ``pair``) and num_local
  3 (``pair+stream``: the trailing odd iteration runs the stream sweep,
  Thomas, as in cmcfs_tpu), both ``exact`` modes at num_local 2;
* the FREE baffle (``tests/test_duals.py::_free_baffled(16, 12, 12)``):
  PCR with the dual chains on X (test_duals.py:139-167).
The divergence error within 1e-6 absolute, as those tests hold it.
"""
import numpy as np
import jax.numpy as jnp
import pytest

import __graft_entry__ as entry
from cmcfs_tpu.models import adi3d as jadi
from cmcfs_tpu.models.common3d import grid_arrays, init_state
from cmcfs_tpu_torch.models import adi3d as tadi
from cmcfs_tpu_torch.models.common3d import from_jax_numpy, merge_ok
from cmcfs_tpu_torch.ops import pcr_sweep as pcs
from cmcfs_tpu_torch.ops import stream_sweep as ss

from test_duals import _free_baffled, _pa

ATOL = 5e-6


def _step_vs_scan(ga, cur, pa, nl, exact, want_dirs):
    dt = jnp.float32(0.01)
    ref, j_err = jadi.adi_timestep_3d(cur, cur, ga, dt, 2, nl, pa,
                                      backend="scan", exact=exact)
    st, tga, tpa = from_jax_numpy(cur, ga, pa, "cpu")
    mok = merge_ok(tga)
    duals = tuple(c is not None for c in tga.cls_b)
    rep = tadi.dispatch_report(tuple(tga.types.shape), duals, "fused_pcr",
                               nl, mok)
    assert rep["pcr"] and rep["dirs"] == want_dirs
    assert rep["dirs"] == jadi.dispatch_report(
        tuple(tga.types.shape), ga, "fused_pcr", nl, mok)["dirs"]
    counts = (pcs.launches.count, ss.launches.count)
    out, t_err = tadi.adi_timestep_3d(st, st, tga, 0.01, 2, nl, tpa,
                                      backend="fused_pcr", exact=exact,
                                      merge_ok=mok)
    assert (pcs.launches.count, ss.launches.count) == counts
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0,
                                   atol=ATOL)
    assert abs(float(t_err) - float(j_err)) < 1e-6


@pytest.mark.parametrize("nl, exact", [(2, True), (2, False), (3, True)])
def test_fused_pcr_step_matches_scan(nl, exact):
    _, ga, cur, pa = entry._setup(32, 19, 21, "scan")
    path = "pair" if nl % 2 == 0 else "pair+stream"
    _step_vs_scan(ga, cur, pa, nl, exact, {"X": path, "Y": path, "Z": path})


def test_fused_pcr_free_baffle_matches_scan():
    grid = _free_baffled(16, 12, 12)
    ga = grid_arrays(grid)
    assert ga.cls_b[0] is not None
    _step_vs_scan(ga, init_state(grid), _pa(grid), 2, True,
                  {"X": "pair", "Y": "pair", "Z": "pair"})
