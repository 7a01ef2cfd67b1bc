"""The port's 3D dispatch and whole ADI step against cmcfs_tpu, on the CPU.

* ``dispatch_report``: the port's ``dirs`` and ``pad`` equal cmcfs_tpu's
  over a table of shapes (incl. 384^3, 260^3, 270x256x256 and 250^3),
  backends, num_local in {1, 2, 3}, merge_ok and duals.
* ``adi_timestep_3d``: three steps of the port (plain versions of its
  kernels, on the CPU) against three of cmcfs_tpu's ``backend="scan"``
  (exact-order Thomas on materialized rows) on every path: pair,
  pair+stream, stream and fallback (the dual stitch is in
  test_torch_duals3d.py).  Fields within
  1e-5 * max|state| (PR 1's bound, over the four stacked fields): the pair
  and stream sweeps multiply by 1/(2h) where the scan path divides, the
  line sweep's row 0 multiplies by a reciprocal where the scan path
  divides, and XLA contracts FMAs.  Those ulp-level differences arise in
  terms of the state's largest size (T ~ 1.1, u ~ 0.5) and reach the
  small fields too (the lid cavity's v stays below 1e-2 after 3 steps),
  so the bound is taken over the state, not per field.  Measured at most
  6e-7 absolute on every path.  The divergence error within 1e-4
  relative (a full-grid float32 sum reduced in another order).
"""
import itertools
from typing import NamedTuple

import numpy as np
import jax.numpy as jnp
import pytest

from cmcfs_tpu.core.params import FluidParams
from cmcfs_tpu.geom.synthetic import lid_cavity_3d
from cmcfs_tpu.models import adi3d as jadi
from cmcfs_tpu.models import common3d as jc
from cmcfs_tpu_torch.models import adi3d as tadi
from cmcfs_tpu_torch.models import common3d as tc
from cmcfs_tpu_torch.models.common3d import from_jax_numpy, merge_ok

REL = 1e-5
STEPS = 3


class _Duals(NamedTuple):
    cls_b: tuple


SHAPES = [(384, 384, 384), (260, 260, 260), (270, 256, 256),
          (250, 250, 250), (256, 256, 256), (16, 14, 12), (300, 64, 256)]
MERGE = [(True, True, True), (True, False, True)]
DUALS = [(False, False, False), (True, False, False), (False, True, True)]


@pytest.mark.parametrize("shape", SHAPES)
def test_dispatch_report_matches_jax(shape):
    for backend, nl, mok, duals in itertools.product(
            tadi.BACKENDS, (1, 2, 3), MERGE, DUALS):
        ga = _Duals(tuple(object() if d else None for d in duals))
        want = jadi.dispatch_report(shape, ga, backend, nl, mok)
        got = tadi.dispatch_report(shape, duals, backend, nl, mok)
        case = (shape, backend, nl, mok, duals)
        assert got["dirs"] == want["dirs"], case
        assert got["pad"] == want["pad"], case
        assert got["backend"] == want["backend"], case


def test_dispatch_report_auto_is_fused_nl():
    """``auto`` resolves to fused_nl, the card's default as the TPU's;
    384^3 goes to the line sweep on all three directions."""
    rep = tadi.dispatch_report((384, 384, 384), (False,) * 3, "auto", 2,
                               (True, True, True))
    assert rep == {"backend": "fused_nl", "pad": None, "pcr": False,
                   "bf16": False,
                   "dirs": {"X": "fallback", "Y": "fallback",
                            "Z": "fallback"}}
    rep = tadi.dispatch_report((250, 250, 250), (False,) * 3, "auto", 2,
                               (True, True, True))
    assert rep["pad"] == (6, 6, 6)
    assert set(rep["dirs"].values()) == {"pair"}


def _params(grid):
    p = FluidParams.normalized(200.0, 0.72, 1.4)
    return jadi.ParamsArgs3D(*(jnp.float32(x) for x in (
        p.v_T, p.v_vis, p.t_vis, p.t_phi, grid.dx, grid.dy, grid.dz)))


def _lid():
    grid = lid_cavity_3d(16, 14, 12)
    return jc.grid_arrays(grid), jc.init_state(grid), _params(grid)


def _run_both(ga, cur, pa, ng, nl, backend, exact, mok=None):
    """STEPS steps of cmcfs_tpu's scan path and of the port; returns the
    port's dispatch dirs."""
    dt = jnp.float32(0.01)
    st, tga, tpa = from_jax_numpy(cur, ga, pa, "cpu")
    mok = merge_ok(tga) if mok is None else mok
    j_cur = j_nxt = cur
    t_cur = t_nxt = st
    for _ in range(STEPS):
        j_new, j_err = jadi.adi_timestep_3d(
            jc.update_boundaries(j_cur, ga), jc.update_boundaries(j_nxt, ga),
            ga, dt, ng, nl, pa, backend="scan", exact=exact)
        j_nxt, j_cur = j_cur, j_new
        t_new, t_err = tadi.adi_timestep_3d(
            tc.update_boundaries(t_cur, tga), tc.update_boundaries(t_nxt, tga),
            tga, dt, ng, nl, tpa, backend=backend, exact=exact,
            merge_ok=mok)
        t_nxt, t_cur = t_cur, t_new
        assert abs(float(t_err) - float(j_err)) <= 1e-4 * float(j_err)
    j_cur = [np.asarray(j) for j in j_cur]
    bound = REL * max(float(np.abs(j).max()) for j in j_cur)
    for j, t in zip(j_cur, t_cur):
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=bound)
    duals = tuple(c is not None for c in tga.cls_b)
    return tadi.dispatch_report(tuple(tga.types.shape), duals, backend, nl,
                                mok)["dirs"]


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("case", ["nl1_stream", "nl3_pair_stream",
                                  "fused_dma", "fused", "fused_full",
                                  "merge_not_ok_y"])
def test_step_matches_jax_scan_lid(case, exact):
    ga, cur, pa = _lid()
    ng, nl, backend, mok = 2, 2, "auto", None
    if case == "nl1_stream":
        nl, want = 1, ("stream",) * 3
    elif case == "nl3_pair_stream":
        nl, want = 3, ("pair+stream",) * 3
    elif case in ("fused_dma", "fused"):
        backend, want = case, ("fallback",) * 3
    elif case == "fused_full":
        backend, want = case, ("stream",) * 3
    else:
        mok, want = (True, False, True), ("pair", "fallback", "pair")
    dirs = _run_both(ga, cur, pa, ng, nl, backend, exact, mok)
    assert tuple(dirs[k] for k in "XYZ") == want
