"""The byte counts of the rooflines, from shapes, give the bounds the
port's kernel table states: 0.416 ms a pair at 256^3 and 0.62 ms a
line-sweep launch at 383^3."""
import types

from _helpers import CHECKOUT  # noqa: F401
from portbench.metrics import _counts


def _rec(n, pair, dual=False):
    return types.SimpleNamespace(cells=n ** 3, ng=4, nl=2, axes=[
        {"n": n, "pair": pair, "dual": dual}] * 3)


def test_pair_bound_256():
    r = _rec(256, True)
    assert round(_counts.bound_ms(_counts.pair_bytes(r)) / 12, 3) == 0.416
    assert _counts.step_bytes(r) == _counts.pair_bytes(r)
    assert _counts.line_bytes(r) == 0


def test_line_bound_383():
    r = _rec(383, False)
    assert round(_counts.bound_ms(_counts.line_bytes(r)) / 24, 2) == 0.62
    assert _counts.pair_bytes(r) == 0
    # the step's count is the same pairs' traffic whatever implements it
    assert _counts.step_bytes(r) == 12 * 83 * 383 ** 3


def test_dual_axis_counts_its_plane():
    r = types.SimpleNamespace(cells=256 ** 3, ng=4, nl=2, axes=[
        {"n": 256, "pair": True, "dual": True},
        {"n": 256, "pair": True, "dual": False},
        {"n": 256, "pair": True, "dual": False}])
    assert _counts.pair_bytes(r) == 4 * 256 ** 3 * (84 + 83 + 83)
