"""A run over several cards, on synthetic readings: each card's trace is
read on its own timeline (busy, span and idle summed over the cards, not
merged into one), the cards a run used are counted from its evidence and
must be the cell's, and a step takes the latest card's time."""
import types

import pytest

from _helpers import CHECKOUT  # noqa: F401
from portbench import run, trace

# two cards busy at the same time: card 0 runs [0, 40) and [60, 100),
# card 1 runs [10, 50) and [70, 90); each card's span is its own
TWO = [("k", 0.0, 40.0, 0), ("k", 60.0, 100.0, 0),
       ("k", 10.0, 50.0, 1), ("m", 70.0, 90.0, 1)]


def test_busy_and_span_per_card():
    assert trace.busy_us(TWO) == 80.0 + 60.0
    assert trace.span_us(TWO) == 100.0 + 80.0
    # one card's reading is what the union of its intervals gives
    assert trace.busy_us(TWO[:2]) == 80.0
    assert trace.span_us(TWO[:2]) == 100.0
    # merged into one timeline the two cards would read 90 busy of 100
    merged = [(n, s, e, 0) for n, s, e, _ in TWO]
    assert trace.busy_us(merged) == 90.0
    assert trace.span_us(merged) == 100.0


def test_idle_is_each_cards_own():
    idle = 1.0 - trace.busy_us(TWO) / trace.span_us(TWO)
    assert idle == pytest.approx(40.0 / 180.0)


def test_top_ops_sum_over_cards():
    assert trace.top_ops(TWO) == [["k", pytest.approx(120e-6)],
                                  ["m", pytest.approx(20e-6)]]


def test_idle_gaps_name_their_card():
    host = [("time_step", 0.0, 100.0), ("aten::sum", 35.0, 75.0)]
    gaps = dict(trace.idle_gaps(TWO, host, spans=("time_step",)))
    assert gaps == {"cuda:0 time_step/aten::sum": pytest.approx(20e-6),
                    "cuda:1 time_step/aten::sum": pytest.approx(20e-6)}
    one = dict(trace.idle_gaps(TWO[:2], host, spans=("time_step",)))
    assert one == {"time_step/aten::sum": pytest.approx(20e-6)}


def test_used_cards_from_memory_and_trace():
    assert run.used_cards({0: 5, 1: 0, 2: 7, 3: 0}) == [0, 2]
    assert run.used_cards({0: 5, 1: 0}, {1}) == [0, 1]
    assert run.used_cards({0: 0}) == []


@pytest.mark.parametrize("chips,used,timed,ok", [
    (1, [0], [0], True),
    (4, [0, 1, 2, 3], [0, 1, 2, 3], True),
    (4, [0], [0], False),            # four shards on cuda:0
    (2, [0], [0], False),
    (1, [0, 1], [0], False),         # a card outside the cell's
    (2, [0, 1], [0], False),         # a card first used in the window
    (1, [], [], False),
])
def test_card_fault(chips, used, timed, ok):
    fault = run.card_fault("cell.x", chips, used, timed)
    assert (fault is None) == ok
    if not ok:
        assert f"has chips {chips}" in fault
        assert f"used {len(used)} device(s)" in fault


class _Ev:
    def __init__(self, t):
        self.t = t

    def elapsed_time(self, other):
        return other.t - self.t


def test_step_time_is_the_latest_cards():
    starts = [_Ev(0.0), _Ev(0.0)]
    events = [[_Ev(10.0), _Ev(12.0)], [_Ev(25.0), _Ev(22.0)],
              [_Ev(30.0), _Ev(40.0)]]
    assert run.step_times(starts, events) == [12.0, 15.0, 18.0]
    # one card reads its own intervals, as a single-card run always has
    assert run.step_times(starts[:1], [e[:1] for e in events]) == [
        10.0, 15.0, 5.0]


def test_fused_count_reads_the_record():
    """The byte count reads the backend and the wavefront from the
    record the case's comparison returns."""
    from portbench.metrics import _counts
    rec = types.SimpleNamespace(cells=10, ng=1, nl=1, backend="auto",
                                wavefront=False, axes=[
                                    {"n": 10, "pair": False, "dual": False},
                                    {"n": 10, "pair": True, "dual": False},
                                    {"n": 10, "pair": True, "dual": False}])
    assert _counts.line_bytes(rec) == 82 * 10
