"""The line-sweep kernel's launches' compulsory bytes
(``_counts.line_bytes``: a fused fallback launch's 82 B a cell, a
LineRows launch's 37) / 3.35 TB/s, as a share of the line-sweep kernel's
device time a traced step, summed over the cards; nothing where it did
not run or no direction takes the fallback."""
from portbench.metrics import _counts


def read(rec):
    t = rec.trace
    if t is None or not _counts.line_bytes(rec):
        return None
    s = _counts.kernel_seconds(rec, ("line_sweep_kernel",))
    if s <= 0:
        return None
    return (100.0 * _counts.bound_ms(_counts.line_bytes(rec))
            / (s * 1e3 / t.steps))
