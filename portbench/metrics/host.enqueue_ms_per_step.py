"""The median over the window's untraced steps of the host's time in the
``update_boundaries`` and ``time_step`` calls (host clock, no
synchronize: the step's own error read waits on the device every tenth
step, which the median passes over)."""
import statistics


def read(rec):
    if not rec.host_ms:
        return None
    return statistics.median(rec.host_ms)
