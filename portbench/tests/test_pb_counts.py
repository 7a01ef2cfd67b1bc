"""The byte counts of the rooflines, from shapes, give the bounds the
port's kernel table states: 0.416 ms a pair at 256^3, 0.62 ms a
line-sweep launch at 383^3 and 1.375 ms a fused fallback launch there;
a fallback axis counts a fused launch's 82 B only where the port fuses
it."""
import types

import pytest

from _helpers import CHECKOUT  # noqa: F401
from portbench.metrics import _counts


def _rec(n, pair, dual=False, backend="auto", wavefront=False):
    return types.SimpleNamespace(cells=n ** 3, ng=4, nl=2, backend=backend,
                                 wavefront=wavefront, axes=[
                                     {"n": n, "pair": pair, "dual": dual}]
                                 * 3)


def test_pair_bound_256():
    r = _rec(256, True)
    assert round(_counts.bound_ms(_counts.pair_bytes(r)) / 12, 3) == 0.416
    assert _counts.step_bytes(r) == _counts.pair_bytes(r)
    assert _counts.line_bytes(r) == 0


def test_line_bound_383():
    # bf16 payloads keep the line sweep's LineRows launches
    r = _rec(383, False, backend="fused_bf16")
    assert round(_counts.bound_ms(_counts.line_bytes(r)) / 24, 2) == 0.62
    assert _counts.pair_bytes(r) == 0
    # the step's count is the same pairs' traffic whatever implements it
    assert _counts.step_bytes(r) == 12 * 83 * 383 ** 3


def test_fused_fallback_bound_383():
    """``auto`` (``fused_nl``) fuses every dual-free fallback axis: 24
    launches of 82 B a cell, 1.375 ms each."""
    r = _rec(383, False)
    assert _counts.line_bytes(r) == 24 * 82 * 383 ** 3
    assert round(_counts.bound_ms(_counts.line_bytes(r)) / 24, 3) == 1.375
    assert _counts.step_bytes(r) == 12 * 83 * 383 ** 3


@pytest.mark.parametrize("backend,dual,wavefront,per_axis", [
    ("fused_nl", False, False, (82, 82, 82)),
    ("fused_dma", False, False, (82, 82, 82)),
    ("fused_pcr", False, False, (82, 82, 82)),
    ("fused_nl", False, True, (37, 82, 82)),
    ("fused_nl", True, False, (74, 74, 74)),
    ("fused_bf16", False, False, (37, 37, 37)),
    ("fused_pcr_bf16", True, False, (74, 74, 74)),
    ("scan", False, False, (37, 37, 37)),
    ("pcr", True, True, (74, 74, 74)),
])
def test_line_bytes_by_launch(backend, dual, wavefront, per_axis):
    """82 B a cell a launch on a fused axis (a float32 fused backend, no
    pass B, no wavefront on X); 37 on the others, 74 with a pass B."""
    r = _rec(383, False, dual, backend, wavefront)
    assert [_counts.fused_fallback(r, ax) for ax in range(3)] == [
        b == 82 for b in per_axis]
    assert _counts.line_bytes(r) == 8 * sum(per_axis) * 383 ** 3


def test_dual_axis_counts_its_plane():
    r = types.SimpleNamespace(cells=256 ** 3, ng=4, nl=2, axes=[
        {"n": 256, "pair": True, "dual": True},
        {"n": 256, "pair": True, "dual": False},
        {"n": 256, "pair": True, "dual": False}])
    assert _counts.pair_bytes(r) == 4 * 256 ** 3 * (84 + 83 + 83)
