"""The benchmark of cmcfs_tpu_torch on one NVIDIA card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout.  The cell (``BENCHMARK.json``) names a
configuration (``configs/<name>.json``) and a traffic
(``traffic/<name>.json``: the grid's size, the backend, the steps to
trace); ``workloads/<cell>.json`` holds the limits of the comparison.
The configuration's ``kind`` names its builder, ``kinds/<kind>.py``,
whose ``build(cfg, traffic, device, seed, shape, control)`` makes the
case: the port's solver on the configuration's grid with the seed's
state, its step as the port's command line runs it, and its comparison
with the plain reference (``reference/``).

Set-up, from process start to the window's first step: imports, the
case's set-up (the port's kernel library, built into
``build/cmcfs_tpu_torch/`` inside the checkout on the first run, the
grid, the solver, the seeded state) and its warm-up steps.  The window
then runs the case's steps for ``--seconds`` and to the end of the step
under way, and closes with ``torch.cuda.synchronize()``.  A CUDA event
after each step times it without a synchronize.  With ``--trace 1`` a
run of consecutive steps is profiled (``torch.profiler``) and the
per-layer metrics are reported instead of the end-to-end ones.

After the window the peak device memory is read, the port's state is
freed, and the case's comparison runs: for the 3D ADI kinds
(``kinds/_adi3d.py``) the reference works out the grid, the initial
state and two steps again, the first warm-up step and one step of the
window drawn from the seed among those that check the error.
``correct`` is every compared number within its limit and no step
failed.  The last lines on standard error and the result's ``checks``
give each number with its limit.

``--rehearse`` runs the same on the CPU, at ``--grid`` cells, on the
port's plain versions; it prints no device metric.  ``--control`` runs
the kind's control (for ADI the port's bf16 payload mode) in the
program's place: the comparison has to find it not correct.  ``--list``
prints every configuration, traffic, cell, kind and metric file the
folders hold.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
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


def card_info(device) -> dict:
    """The card's name, count, power limit and clock (nvidia-smi)."""
    import torch
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1}
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={device.index or 0}",
             "--query-gpu=power.limit,clocks.sm,clocks.max.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30).stdout.split(",")
        info["power_limit_w"] = float(out[0])
        info["clock_sm_mhz"] = float(out[1])
        info["clock_max_sm_mhz"] = float(out[2])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        info["power_limit_w"] = None
    return info


def run(args) -> int:
    bench = registry.benchmark(CHECKOUT)
    cell = registry.cell(bench, args.workload)
    cfg = registry.load_json("configs", cell["config"])
    traffic = registry.load_json("traffic", cell["traffic"])
    limits = registry.load_json("workloads", args.workload)["limits"]
    build = registry.builder(cfg["kind"])

    import torch
    phases = {"imports": time.perf_counter() - T_START}
    if args.rehearse:
        device = torch.device("cpu")
    else:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell["chips"]):
            print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
                  f"torch.cuda.is_available() "
                  f"{torch.cuda.is_available()}, device_count "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 3
        device = torch.device("cuda:0")
    cuda = device.type == "cuda"
    shape = None
    if args.rehearse:
        shape = tuple(int(n) for n in args.grid.split(","))
        shape = shape * 3 if len(shape) == 1 else shape
    t = time.perf_counter()
    case = build(cfg, traffic, device, args.seed, shape, args.control)
    phases.update(getattr(case, "phases", {}))
    phases["case"] = time.perf_counter() - t

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    attempted = failed = 0
    try:
        case.warm_up()
    except case.failures as e:
        print(f"warm-up step failed: {e}", file=sys.stderr)
        attempted, failed = 1, 1
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
    if cuda:
        start_ev = torch.cuda.Event(enable_timing=True)
        start_ev.record()
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
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
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
    step_ms = []
    if cuda and events:
        step_ms = [a.elapsed_time(b) for a, b in
                   zip([start_ev] + events[:-1], events)]
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    forbidden = forbidden_modules()
    if forbidden:
        print(f"loaded in the run: {', '.join(forbidden)}", file=sys.stderr)
        return 4

    dev_info = (card_info(device) if cuda else
                {"platform": "cpu", "kind": "cpu (rehearsal)", "count": 0})
    dev_info["memory_peak_bytes"] = int(memory_peak)
    count = torch.cuda.device_count() if cuda else 0
    print(f"# card {dev_info['kind']}, count {count}, power limit "
          f"{dev_info.get('power_limit_w')} W, SM clock "
          f"{dev_info.get('clock_sm_mhz')} of "
          f"{dev_info.get('clock_max_sm_mhz')} MHz; peak memory "
          f"{memory_peak} B; {case.label()}; {steps} window steps in "
          f"{window_s:.3f} s; set-up {setup_s:.3f} s ("
          + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()) + ")")

    if prof is not None:
        from portbench import trace
        dev_ev = trace.device_events(prof, case.spans)
        cpu_ev = trace.host_events(prof)
        tr.steps = trace_steps
        tr.kernels = dev_ev
        tr.busy_s = trace.busy_us(dev_ev) * 1e-6
        # the traced window is the device's: from its first operation of
        # the traced steps to its last, so that neither the synchronize
        # that opens the stretch nor the one that closes it counts as idle
        lo = min((e[1] for e in dev_ev), default=0.0)
        hi = max((e[2] for e in dev_ev), default=0.0)
        tr.window_s = (hi - lo) * 1e-6
        tr.breakdown = {"device_ops": trace.top_ops(dev_ev),
                        "idle_gaps": trace.idle_gaps(dev_ev, cpu_ev, lo, hi,
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
        dev_info["busy_s"] = tr.busy_s
        dev_info["window_s"] = tr.window_s
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
