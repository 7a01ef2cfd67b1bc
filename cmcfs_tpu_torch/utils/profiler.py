"""Named-section wall-clock profiler (port of cmcfs_tpu/utils/profiler.py;
the reference is src/Common/Profiler.h).

Per-event count / total / average milliseconds, printed sorted by total
time in human or CSV form (the reference's CSV flag).  On a CUDA device
each section waits for the card's queued work at its start and end
(``torch.cuda.synchronize``, the analogue of the reference's pre-event
MPI_Barrier, Profiler.h:57-59), so a section's time counts the kernels it
queued.  ``torch_trace`` captures a ``torch.profiler`` trace for deeper
looks.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch


class _Event:
    __slots__ = ("count", "total")

    def __init__(self) -> None:
        self.count = 0
        self.total = 0.0


class Profiler:
    def __init__(self, device):
        """``device``: the device whose work a section waits for."""
        self.events: Dict[str, _Event] = {}
        self.device = torch.device(device)
        self._wall_start = time.perf_counter()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def section(self, name: str):
        self._sync()
        start = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            ev = self.events.setdefault(name, _Event())
            ev.count += 1
            ev.total += time.perf_counter() - start

    def report(self, csv: bool = False) -> str:
        rows = sorted(self.events.items(), key=lambda kv: -kv[1].total)
        wall = time.perf_counter() - self._wall_start
        if csv:
            out = ["event,count,total_ms,avg_ms"]
            out += [f"{name},{ev.count},{ev.total*1e3:.3f},"
                    f"{ev.total*1e3/max(ev.count,1):.3f}"
                    for name, ev in rows]
            out.append(f"overall_sec,,{wall:.3f},")
            return "\n".join(out)
        out = [f"{'event':<24}{'count':>8}{'total ms':>14}{'avg ms':>12}"]
        out += [f"{name:<24}{ev.count:>8}{ev.total*1e3:>14.3f}"
                f"{ev.total*1e3/max(ev.count,1):>12.3f}"
                for name, ev in rows]
        out.append(f"overall: {wall:.3f} sec")
        return "\n".join(out)


@contextlib.contextmanager
def torch_trace(logdir: str):
    """Capture a ``torch.profiler`` trace (CPU, and CUDA when present)
    into ``logdir/trace.json``, viewable in Perfetto or chrome://tracing."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
