"""The port's 3D dispatch for the backends and grids this slice brings to
the pair kernels, against cmcfs_tpu's ``dispatch_report``, on the CPU:
``fused_pcr`` (PCR on every pair direction) and the row backend ``pcr``,
and grids with FREE duals on one or more axes, at num_local 1 to 4, over
test_torch_dispatch3d.py's shapes and merge_ok cases.  ``dirs``, ``pad``,
``backend`` and the ``pcr`` flag must be equal; an even num_local sends
dual directions to the pair kernel (its second chain), an odd one to the
fallback, as in cmcfs_tpu (adi3d.py:459-508).  The bf16 backends
(``fused_bf16``, ``fused_pcr_bf16``), which used to raise, dispatch as
cmcfs_tpu's, ``bf16`` and ``pcr`` flags included.
"""
import itertools

import pytest

from cmcfs_tpu.models import adi3d as jadi
from cmcfs_tpu_torch.models import adi3d as tadi

from test_torch_dispatch3d import MERGE, SHAPES, _Duals

DUALS = [(False, False, False), (True, False, False), (False, True, True),
         (True, True, True)]


@pytest.mark.parametrize("shape", SHAPES)
def test_dispatch_report_pcr_and_duals_match_jax(shape):
    for backend, nl, mok, duals in itertools.product(
            ("fused_pcr", "pcr", "fused_nl"), (1, 2, 3, 4), MERGE,
            DUALS):
        ga = _Duals(tuple(object() if d else None for d in duals))
        want = jadi.dispatch_report(shape, ga, backend, nl, mok)
        got = tadi.dispatch_report(shape, duals, backend, nl, mok)
        case = (shape, backend, nl, mok, duals)
        for key in ("dirs", "pad", "backend", "pcr", "bf16"):
            assert got[key] == want[key], (key, case)


def test_dual_directions_pair_at_even_num_local():
    rep = tadi.dispatch_report((16, 12, 12), (True, False, False),
                               "fused_pcr", 4, (True, True, True))
    assert rep["pcr"] and rep["dirs"] == {"X": "pair", "Y": "pair",
                                          "Z": "pair"}
    rep = tadi.dispatch_report((16, 12, 12), (True, False, False), "auto",
                               3, (True, True, True))
    assert not rep["pcr"] and rep["dirs"] == {"X": "fallback",
                                              "Y": "pair+stream",
                                              "Z": "pair+stream"}


@pytest.mark.parametrize("backend", ["fused_bf16", "fused_pcr_bf16"])
def test_bf16_backends_raise_naming_b2(backend):
    """The bf16 backends no longer raise: their dispatch equals cmcfs_tpu's
    over the shapes, num_local, merge_ok and duals of the test above, with
    ``bf16`` set and ``pcr`` set for ``fused_pcr_bf16``."""
    for shape, nl, mok, duals in itertools.product(SHAPES, (1, 2, 3, 4),
                                                   MERGE, DUALS):
        ga = _Duals(tuple(object() if d else None for d in duals))
        want = jadi.dispatch_report(shape, ga, backend, nl, mok)
        got = tadi.dispatch_report(shape, duals, backend, nl, mok)
        for key in ("dirs", "pad", "backend", "pcr", "bf16"):
            assert got[key] == want[key], (key, shape, nl, mok, duals)
        assert got["bf16"] and got["pcr"] == (backend == "fused_pcr_bf16")
