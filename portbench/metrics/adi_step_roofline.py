"""The step's compulsory bytes (``_counts.step_bytes``) / 3.35 TB/s, as a
share of the device's busy time a traced step, summed over the cards: a
share of one card's peak, whatever the number of cards."""
from portbench.metrics import _counts


def read(rec):
    t = rec.trace
    if t is None or t.busy_s <= 0:
        return None
    busy_ms = t.busy_s * 1e3 / t.steps
    return 100.0 * _counts.bound_ms(_counts.step_bytes(rec)) / busy_ms
