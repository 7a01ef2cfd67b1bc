"""The port's 3D ADI step against cmcfs_tpu's ``scan`` path on the FREE
baffle fixture (``__graft_entry__._setup(..., baffle=True)``, 24^3), on
the CPU: a FREE-bc baffle plane at mid-X pierced by a hole leaves dual
endpoints on X lines that survive the inert-dual elision, so X runs the
fallback with the ``cls_b``/``take_b`` stitch (two line sweeps per
iteration) and Y/Z the stream paths, as cmcfs_tpu dispatches them.
Three steps, both ``exact`` modes; the bound and its reason are
test_torch_dispatch3d.py's (1e-5 * max|state|).
"""
import pytest

import __graft_entry__ as entry
from cmcfs_tpu.models import adi3d as jadi

from test_torch_dispatch3d import _run_both

N = 24


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("nl", [1, 3])
def test_step_matches_jax_scan_free_baffle(nl, exact):
    """X lines carry FREE dual endpoints: X runs the fallback with the
    cls_b/take_b stitch (two line sweeps per iteration), Y/Z the stream
    paths, as cmcfs_tpu dispatches them."""
    _, ga, cur, pa = entry._setup(N, N, N, "auto", baffle=True)
    assert ga.cls_b[0] is not None
    dirs = _run_both(ga, cur, pa, 2, nl, "auto", exact)
    tail = "pair+stream" if nl == 3 else "stream"
    assert dirs == {"X": "fallback", "Y": tail, "Z": tail}
    want = jadi.dispatch_report((N, N, N), ga, "fused_nl", nl,
                                entry._merge_ok(ga))["dirs"]
    assert dirs == want
