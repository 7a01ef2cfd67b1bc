"""The pair directions' compulsory bytes (``_counts.pair_bytes``) / 3.35
TB/s, as a share of the pair kernel's device time a traced step, summed
over the cards; nothing where no pair kernel ran or no direction takes
the pair form."""
from portbench.metrics import _counts


def read(rec):
    t = rec.trace
    if t is None or not _counts.pair_bytes(rec):
        return None
    s = _counts.kernel_seconds(rec, ("pair_sweep_iter_kernel",))
    if s <= 0:
        return None
    return (100.0 * _counts.bound_ms(_counts.pair_bytes(rec))
            / (s * 1e3 / t.steps))
