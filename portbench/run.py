"""The benchmark of cmcfs_tpu_torch on NVIDIA cards.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout.  The cell (``BENCHMARK.json``) names a
configuration (``configs/<name>.json``), a traffic
(``traffic/<name>.json``: the grid's size, the backend, the shards, the
steps to trace) and its ``chips``; ``workloads/<cell>.json`` holds the
limits of the comparison.  The configuration's ``kind`` names
``kinds/<kind>.py``, whose ``build(cfg, traffic, device, seed, shape,
control)`` makes the case: the port's solver on the configuration's grid
with the seed's state, its step as the port's command line runs it, and
its comparison with the plain reference (``reference/``).  A ``build``
that takes ``devices`` is handed the cell's cards, ``cuda:0`` to
``cuda:{chips - 1}``; ``device`` is the first.

Set-up, from process start to the window's first step: imports, the
case's set-up (the port's kernel library, built into
``build/cmcfs_tpu_torch/`` inside the checkout on the first run, the
grid, the solver, the seeded state) and its warm-up steps.  The cards
the window synchronises and times are those of the cell's on which
set-up allocated memory; no other card is touched.  The window then runs
the case's steps for ``--seconds`` and to the end of the step under
way, and closes with ``torch.cuda.synchronize`` on each of them.  A CUDA
event on each card after each step times it without a synchronize: a
step's time is the latest card's, the largest over the cards of the
time since that card's previous event.  With ``--trace 1`` a run of
consecutive steps is profiled (``torch.profiler``) and the per-layer
metrics are reported instead of the end-to-end ones; the trace is read
card by card (``trace.py``).

After the window the cards the run used are counted from what the case
cannot write itself: the allocator's peak memory on each visible card
and, in a traced run, the cards of the profiled operations.  Unless they
are the cell's cards, all of them and no other, and of one name, the run
says so on standard error and exits with 5, printing no result.
``device.count`` is their number, ``memory_peak_bytes`` the fullest
card's peak and ``memory_peak_bytes_each`` each card's.  The port's
state is then freed, and the case's comparison runs: for the 3D ADI
kinds (``kinds/_adi3d.py``) the reference works out the grid, the
initial state and two steps again, the first warm-up step and one step
of the window drawn from the seed among those that check the error.
``correct`` is every compared number within its limit and no step
failed.  The last lines on standard error and the result's ``checks``
give each number with its limit.

``--rehearse`` runs the same on the CPU, at ``--grid`` cells, on the
port's plain versions, a CPU shard for each of the cell's cards; it
prints no device metric.  ``--control`` runs the kind's control (for
ADI the port's bf16 payload mode) in the program's place: the
comparison has to find it not correct.  ``--list`` prints every
configuration, traffic, cell, kind and metric file the folders hold.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import inspect  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)
if CHECKOUT not in sys.path:
    sys.path.insert(0, CHECKOUT)

from portbench import check, registry  # noqa: E402

# top-level module names that may not be loaded in a run: the JAX package
# and JAX itself (the port's name begins with the package's, so names are
# compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "cmcfs_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="the CPU, the plain versions, no device metric")
    ap.add_argument("--grid", default="40",
                    help="a rehearsal's grid: n (n^3) or nx,ny,nz")
    ap.add_argument("--control", action="store_true",
                    help="run the configuration kind's control in the "
                    "program's place")
    ap.add_argument("--list", action="store_true")
    return ap.parse_args(argv)


def card_info(cards: list) -> dict:
    """The cards' name, count, and each one's power limit and clocks
    (nvidia-smi); raises ``ValueError`` where the cards' names differ."""
    import torch
    names = {torch.cuda.get_device_name(c) for c in cards}
    if len(names) != 1:
        raise ValueError(f"the cards differ: {sorted(names)}")
    info = {"platform": "gpu", "kind": names.pop(), "count": len(cards)}
    keys = ("power_limit_w", "clock_sm_mhz", "clock_max_sm_mhz")
    try:
        out = subprocess.run(
            ["nvidia-smi", "--id=" + ",".join(map(str, cards)),
             "--query-gpu=index,power.limit,clocks.sm,clocks.max.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30).stdout
        rows = {int(r[0]): [float(x) for x in r[1:]] for r in
                (line.split(",") for line in out.strip().splitlines())}
        for k, key in enumerate(keys):
            info[key] = [rows[c][k] for c in cards]
    except (OSError, ValueError, IndexError, KeyError,
            subprocess.SubprocessError):
        info["power_limit_w"] = None
    return info


def used_cards(peaks: dict, traced=()) -> list:
    """The cards a run used: those with a peak of allocated memory
    (``peaks``: card -> bytes) above 0, and those that ran a traced
    operation."""
    return sorted({c for c, b in peaks.items() if b > 0} | set(traced))


def card_fault(workload: str, chips: int, used: list,
               timed: list):
    """What is wrong with the cards a run used, or None: they have to be
    the cell's ``chips`` cards, cuda:0 onwards, and those the window
    timed (the ones set-up used)."""
    given = list(range(chips))
    if used == given and timed == given:
        return None
    return (f"{workload} has chips {chips} (cuda:0..cuda:{chips - 1}); "
            f"the run used {len(used)} device(s): "
            + (", ".join(f"cuda:{c}" for c in used) or "none")
            + "; set-up used "
            + (", ".join(f"cuda:{c}" for c in timed) or "none"))


def step_times(starts: list, events: list) -> list:
    """Each step's ms: ``events`` holds one list a step of one CUDA event
    a card, recorded after the step, ``starts`` one a card from the
    window's opening; a step takes the largest over the cards of the time
    since that card's previous event."""
    out, prev = [], starts
    for evs in events:
        out.append(max(a.elapsed_time(b) for a, b in zip(prev, evs)))
        prev = evs
    return out


def run(args) -> int:
    bench = registry.benchmark(CHECKOUT)
    cell = registry.cell(bench, args.workload)
    cfg = registry.load_json("configs", cell["config"])
    traffic = registry.load_json("traffic", cell["traffic"])
    limits = registry.load_json("workloads", args.workload)["limits"]
    build = registry.builder(cfg["kind"])

    import torch
    phases = {"imports": time.perf_counter() - T_START}
    chips = cell["chips"]
    if args.rehearse:
        devices = [torch.device("cpu")] * chips
    else:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < chips):
            print(f"{args.workload} needs {chips} CUDA device(s); "
                  f"torch.cuda.is_available() "
                  f"{torch.cuda.is_available()}, device_count "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 3
        devices = [torch.device(f"cuda:{i}") for i in range(chips)]
    device = devices[0]
    cuda = device.type == "cuda"
    shape = None
    if args.rehearse:
        shape = tuple(int(n) for n in args.grid.split(","))
        shape = shape * 3 if len(shape) == 1 else shape
    kw = ({"devices": devices}
          if "devices" in inspect.signature(build).parameters else {})
    t = time.perf_counter()
    case = build(cfg, traffic, device, args.seed, shape, args.control, **kw)
    phases.update(getattr(case, "phases", {}))
    phases["case"] = time.perf_counter() - t

    def peaks() -> dict:
        # the allocator's own record: reading it makes no context on a card
        return {c: torch.cuda.max_memory_allocated(c)
                for c in range(torch.cuda.device_count())} if cuda else {}

    def sync():
        for c in timed:
            torch.cuda.synchronize(c)

    def record() -> list:
        """A timing event on each timed card's current stream."""
        evs = [torch.cuda.Event(enable_timing=True) for _ in timed]
        for c, ev in zip(timed, evs):
            ev.record(torch.cuda.current_stream(c))
        return evs

    attempted = failed = 0
    try:
        case.warm_up()
    except case.failures as e:
        print(f"warm-up step failed: {e}", file=sys.stderr)
        attempted, failed = 1, 1
    # the cards that set-up used: the window synchronises and times these
    timed = used_cards(peaks())
    sync()
    setup_s = time.perf_counter() - T_START
    phases["warm_up"] = setup_s - sum(v for k, v in phases.items()
                                      if k in ("imports", "case"))

    rng = random.Random(args.seed)
    trace_steps = traffic["trace_steps"] if args.trace else 0
    trace_from = case.trace_from
    events, host_ms = [], []
    prof = None
    tr = types.SimpleNamespace()
    sample = None
    check_steps = steps = 0
    i = case.warmup_steps
    start_evs = record()
    t0 = time.perf_counter()
    # the window lasts --seconds, and to the end of a traced stretch and of
    # one checkable step, which the comparison needs
    while failed == 0 and (time.perf_counter() - t0 < args.seconds
                           or (trace_steps and not hasattr(tr, "t1"))
                           or sample is None):
        if trace_steps and i == trace_from:
            sync()
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU] + (
                [torch.profiler.ProfilerActivity.CUDA] if cuda else []))
            prof.start()
            sync()
        traced = prof is not None and not hasattr(tr, "t1")
        checkable = case.checkable(i)
        pre = case.hold() if checkable else None
        h0 = time.perf_counter()
        try:
            case.step(i, traced)
        except case.failures as e:
            print(f"step {i} failed: {e}", file=sys.stderr)
            attempted += 1
            failed += 1
            break
        h1 = time.perf_counter()
        events.append(record())
        attempted += 1
        steps += 1
        if not traced:
            host_ms.append((h1 - h0) * 1e3)
        if checkable:
            check_steps += 1
            # a uniform draw among the window's checkable steps, from the
            # seed
            if rng.randrange(check_steps) == 0:
                sample = case.held(pre)
        pre = None
        if traced and i == trace_from + trace_steps - 1:
            sync()
            tr.t1 = time.perf_counter()
            prof.stop()
        i += 1
    sync()
    window_s = time.perf_counter() - t0
    if prof is not None and not hasattr(tr, "t1"):   # a step failed
        tr.t1 = time.perf_counter()
        prof.stop()
    step_ms = step_times(start_evs, events) if timed else []
    peak = peaks()
    forbidden = forbidden_modules()
    if forbidden:
        print(f"loaded in the run: {', '.join(forbidden)}", file=sys.stderr)
        return 4

    dev_ev = []
    if prof is not None:
        from portbench import trace
        dev_ev = trace.device_events(prof, case.spans)
    if cuda:
        used = used_cards(peak, {e[3] for e in dev_ev})
        fault = card_fault(args.workload, chips, used, timed)
        try:
            dev_info = card_info(used)
        except ValueError as e:
            fault = fault or f"{args.workload}: {e}"
        if fault:
            print(fault, file=sys.stderr)
            return 5
        dev_info["memory_peak_bytes"] = int(max(peak[c] for c in used))
        dev_info["memory_peak_bytes_each"] = [int(peak[c]) for c in used]
    else:
        dev_info = {"platform": "cpu", "kind": "cpu (rehearsal)",
                    "count": 0, "memory_peak_bytes": 0}
    print(f"# card {dev_info['kind']}, count {dev_info['count']} of "
          f"{torch.cuda.device_count() if cuda else 0} visible, power limit "
          f"{dev_info.get('power_limit_w')} W, SM clock "
          f"{dev_info.get('clock_sm_mhz')} of "
          f"{dev_info.get('clock_max_sm_mhz')} MHz; peak memory "
          f"{dev_info.get('memory_peak_bytes_each', 0)} B; {case.label()}; "
          f"{steps} window steps in {window_s:.3f} s; set-up "
          f"{setup_s:.3f} s ("
          + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()) + ")")

    if prof is not None:
        cpu_ev = trace.host_events(prof)
        tr.steps = trace_steps
        tr.kernels = dev_ev
        tr.busy_s = trace.busy_us(dev_ev) * 1e-6
        # each card's traced window is its own: from its first operation
        # of the traced steps to its last, so that neither the synchronize
        # that opens the stretch nor the one that closes it counts as idle
        tr.window_s = trace.span_us(dev_ev) * 1e-6
        tr.breakdown = {"device_ops": trace.top_ops(dev_ev),
                        "idle_gaps": trace.idle_gaps(dev_ev, cpu_ev,
                                                     case.spans)}
        del prof, cpu_ev

    # the port's state is freed, so that the reference runs in the memory
    # it leaves
    case.release(sample)
    del sample, events

    t_ref = time.perf_counter()
    checks, work = case.judge(limits, failed)
    ref_s = time.perf_counter() - t_ref

    rec = types.SimpleNamespace(
        cells=case.cells, steps=steps, window_s=window_s, setup_s=setup_s,
        step_ms=step_ms, host_ms=host_ms,
        trace=tr if trace_steps else None, **work)
    metrics = {}
    if not args.rehearse:
        for m in registry.cell_metrics(bench, args.workload,
                                       bool(args.trace)):
            value = registry.reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = check.verdict(checks)
    print(f"# reference {ref_s:.3f} s; checkable window steps "
          f"{check_steps}")
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev_info}
    if trace_steps and hasattr(tr, "busy_s"):
        # averaged over the cards, so that their ratio is the pooled share
        n = max(dev_info["count"], 1)
        dev_info["busy_s"] = tr.busy_s / n
        dev_info["window_s"] = tr.window_s / n
        result["breakdown"] = tr.breakdown
    if args.rehearse:
        result["rehearsal"] = True
    result["checks"] = checks
    if forbidden_modules():
        print(f"loaded in the run: {', '.join(forbidden_modules())}",
              file=sys.stderr)
        return 4
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


def main(argv=None) -> int:
    args = parse(argv)
    if args.list:
        print(json.dumps(registry.listing(), indent=1))
        return 0
    if not args.workload:
        print("--workload is required", file=sys.stderr)
        return 2
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
