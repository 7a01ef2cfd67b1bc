"""Reading a ``torch.profiler`` trace of a run's profiled steps.

Every device event keeps the index of the card it ran on, and each card
is read on its own timeline: its busy time is the union of the intervals
in which an operation (a kernel, a copy, a fill) ran on it, and its span
runs from its first operation's start to its last one's end.  Over
several cards the busy times and the spans are summed, so that busy over
span is the cards' pooled busy share.  A gap is a stretch of a card's
span between its operations, named by what the host was doing when it
began: the case's span (for ADI ``update_boundaries``, ``time_step``)
and the innermost operation the profiler recorded on the host at that
time.
"""
from __future__ import annotations

import numpy as np
import torch


def device_events(prof, spans=()) -> list:
    """(name, start_us, end_us, card) of every operation a card ran (the
    case's ``spans``, which the profiler also draws on the device's
    timeline, left out)."""
    return [(e.name, e.time_range.start, e.time_range.end, e.device_index)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.name not in spans]


def host_events(prof) -> list:
    """(name, start_us, end_us) of every host-side event."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU]


def by_card(events) -> dict:
    """The events of each card, by its index, in the order of the
    indices."""
    out: dict = {}
    for ev in sorted(events, key=lambda t: t[3]):
        out.setdefault(ev[3], []).append(ev)
    return out


def busy_intervals(events) -> list:
    """The union of one card's events' [start, end) intervals, in
    order."""
    out = []
    for _, s, e, _ in sorted(events, key=lambda t: t[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(events) -> float:
    """Each card's busy time, summed over the cards."""
    return sum(e - s for card in by_card(events).values()
               for s, e in busy_intervals(card))


def span_us(events) -> float:
    """Each card's span, from its first operation's start to its last
    one's end, summed over the cards."""
    return sum(max(e[2] for e in card) - min(e[1] for e in card)
               for card in by_card(events).values())


def top_ops(events, n: int = 10) -> list:
    """[name, seconds] of the ``n`` operations with the most device time,
    summed over the cards."""
    tot: dict = {}
    for name, s, e, _ in events:
        tot[name] = tot.get(name, 0.0) + (e - s)
    best = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:160], t * 1e-6] for name, t in best]


def idle_gaps(dev_events, cpu_events, spans=(), n: int = 10,
              longest: int = 400) -> list:
    """[what the host was doing, seconds] of the ``longest`` idle gaps
    within the cards' spans, summed by that name, the ``n`` largest;
    where more than one card ran, each name begins with its card
    (``cuda:1 time_step/...``)."""
    cards = by_card(dev_events)
    gaps = []
    for card, evs in cards.items():
        iv = busy_intervals(evs)
        gaps += [(card, a[1], b[0]) for a, b in zip(iv, iv[1:])]
    gaps = sorted(gaps, key=lambda g: g[1] - g[2])[:longest]
    if not cpu_events:
        return []
    names = [c[0] for c in cpu_events]
    st = np.array([c[1] for c in cpu_events], dtype=np.float64)
    en = np.array([c[2] for c in cpu_events], dtype=np.float64)
    span = np.array([nm in spans for nm in names])
    tot: dict = {}
    for card, s, e in gaps:
        inside = (st <= s) & (en >= s)
        sp = np.flatnonzero(inside & span)
        op = np.flatnonzero(inside & ~span)
        label = names[sp[np.argmax(st[sp])]] if sp.size else "between steps"
        if op.size:
            label += "/" + names[op[np.argmax(st[op])]]
        if len(cards) > 1:
            label = f"cuda:{card} {label}"
        tot[label] = tot.get(label, 0.0) + (e - s)
    best = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:160], t * 1e-6] for name, t in best]
