"""The port's 3D ADI step on the FREE baffle (``tests/test_duals.py::
_free_baffled(16, 12, 12)``) at an even num_local, against cmcfs_tpu's
``scan`` path, on the CPU.  The baffle's FREE dual endpoints survive the
inert-dual elision on X, and at an even num_local both packages run the
pair sweep there, stitching the two passes inside it (the port: the pair
kernel's dual form, ``ops/pair_sweep.py`` with the dual plane, as its
plain version here); Y and Z run the pair sweep on dual-free lines.
Three steps (num_global 2, backend ``auto``), both ``exact`` modes; the
bound and its reason are test_torch_dispatch3d.py's (1e-5 * max|state|).
"""
import pytest

from cmcfs_tpu.models import adi3d as jadi
from cmcfs_tpu.models import common3d as jc

from test_duals import _free_baffled, _pa
from test_torch_dispatch3d import _run_both

SHAPE = (16, 12, 12)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("nl", [2, 4])
def test_step_matches_jax_scan_free_baffle_pair(nl, exact):
    grid = _free_baffled(*SHAPE)
    ga = jc.grid_arrays(grid)
    assert ga.cls_b[0] is not None
    mok = (True, True, True)
    dirs = _run_both(ga, jc.init_state(grid), _pa(grid), 2, nl, "auto",
                     exact, mok)
    assert dirs == {"X": "pair", "Y": "pair", "Z": "pair"}
    assert dirs == jadi.dispatch_report(SHAPE, ga, "fused_nl", nl,
                                        mok)["dirs"]
