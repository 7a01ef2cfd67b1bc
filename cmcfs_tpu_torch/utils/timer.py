"""Wall-clock timer + progress/ETA printer (reference src/Common/Timer.h and
PrintTimeStepInfo, src/Common/IO.h:455-478)."""
from __future__ import annotations

import sys
import time


class CpuTimer:
    def __init__(self) -> None:
        self._t0 = time.perf_counter()
        self._elapsed = 0.0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        self._elapsed = time.perf_counter() - self._t0

    def elapsed_sec(self) -> float:
        return self._elapsed


def print_time_step_info(frame: int, subframe: int, cur_time: float,
                         max_time: float, elapsed_sec: float,
                         stream=sys.stdout) -> None:
    pct = cur_time * 100.0 / max_time
    if pct < 2:
        stream.write(f" frame {frame}\tsubstep {subframe}\t{int(pct)}%\t(----- left)")
    else:
        left = elapsed_sec * (100 - pct) / pct
        h = int(left) // 3600
        m = (int(left) // 60) % 60
        s = int(left) % 60
        stream.write(f" frame {frame}\tsubstep {subframe}\t{int(pct)}%\t"
                     f"({h} h {m} m {s} s left)")
    stream.flush()
