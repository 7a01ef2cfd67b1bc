"""Reading a ``torch.profiler`` trace of a run's profiled steps.

The device's busy time is the union of the intervals in which an
operation (a kernel, a copy, a fill) ran on it; a gap is a stretch
between them, named by what the host was doing when it began: the
case's span (for ADI ``update_boundaries``, ``time_step``) and the
innermost operation the profiler recorded on the host at that time.
"""
from __future__ import annotations

import numpy as np
import torch

def device_events(prof, spans=()) -> list:
    """(name, start_us, end_us) of every operation the device ran (the
    case's ``spans``, which the profiler also draws on the device's
    timeline, left out)."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.name not in spans]


def host_events(prof) -> list:
    """(name, start_us, end_us) of every host-side event."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU]


def busy_intervals(events) -> list:
    """The union of the events' [start, end) intervals, in order."""
    out = []
    for _, s, e in sorted(events, key=lambda t: t[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(events) -> float:
    return sum(e - s for s, e in busy_intervals(events))


def top_ops(events, n: int = 10) -> list:
    """[name, seconds] of the ``n`` operations with the most device time."""
    tot: dict = {}
    for name, s, e in events:
        tot[name] = tot.get(name, 0.0) + (e - s)
    best = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:160], t * 1e-6] for name, t in best]


def idle_gaps(dev_events, cpu_events, t0_us: float, t1_us: float,
              spans=(), n: int = 10, longest: int = 400) -> list:
    """[what the host was doing, seconds] of the ``longest`` idle gaps in
    [t0_us, t1_us], summed by that name, the ``n`` largest."""
    iv = busy_intervals(dev_events)
    edges = [t0_us] + [x for s, e in iv for x in (s, e)] + [t1_us]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges) - 1, 2)
            if edges[k + 1] > edges[k]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:longest]
    if not cpu_events:
        return []
    names = [c[0] for c in cpu_events]
    st = np.array([c[1] for c in cpu_events], dtype=np.float64)
    en = np.array([c[2] for c in cpu_events], dtype=np.float64)
    span = np.array([nm in spans for nm in names])
    tot: dict = {}
    for s, e in gaps:
        inside = (st <= s) & (en >= s)
        sp = np.flatnonzero(inside & span)
        op = np.flatnonzero(inside & ~span)
        label = names[sp[np.argmax(st[sp])]] if sp.size else "between steps"
        if op.size:
            label += "/" + names[op[np.argmax(st[op])]]
        tot[label] = tot.get(label, 0.0) + (e - s)
    best = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:160], t * 1e-6] for name, t in best]
