"""The 95th percentile (nearest rank) over every step of the window of the
time between consecutive CUDA events recorded after each step, the first
from the window's opening event."""
import math


def read(rec):
    if len(rec.step_ms) < 20:
        return None
    ms = sorted(rec.step_ms)
    return ms[math.ceil(0.95 * len(ms)) - 1]
