#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's 3D ADI paths once on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card
and nvcc.  Phases, each of which raises on failure:

1. device: card name, power limit, torch / CUDA / nvcc versions;
2. build: nvcc builds cmcfs_tpu_torch/kernels/csrc/*.cu for sm_90a, one
   process per source;
3. pair kernel vs plain: the pair-sweep kernel against its plain PyTorch
   version on the 256^3 bench box, X / Y / Z, both ``exact`` modes,
   gmerge on X, with CUDA-event times of both;
4. stream kernel vs plain on the same inputs, X / Y / Z, both modes;
5. pair slice: ``cmcfs_tpu_torch.cli3d.run_case`` on the 256^3 box at
   num_global=4, num_local=2 with NetCDF output; dispatch (all ``pair``),
   launch count, ms/step, cell-updates/s, divergence error; then one
   whole step with the kernel against one with the plain version;
6. the other backends: one step each of ``fused_dma``, ``fused`` (24
   line-sweep launches) and ``fused_full`` (24 stream launches) from the
   pair slice's state, each against the pair step;
7. odd num_local: ``run_case`` on the 256^3 box at ng=4 nl=3: dispatch
   all ``pair+stream``, 24 pair and 12 stream launches a step;
8. long-line slice: ``run_case`` on ``bench --case 3d384``'s box
   (383^3) at ng=4 nl=2: dispatch all ``fallback``, 24 line-sweep
   launches a step, ms/step and cell-updates/s in both ``exact`` modes,
   divergence error, host grid-build time, NetCDF output; one whole step
   kernel vs plain;
9. line-sweep kernel vs plain on that 383^3 state (X / Y / Z, lines past
   the TPU kernels' 288-cell cap) and on the 256^3 box (X), both
   ``exact`` modes, with CUDA-event times.

Every kernel's launch counter is set to 0 just before a path is driven
and read just after; launches made to compare a kernel with its plain
version do not count.  The last lines are a JSON record of the kernels,
the card's ``nvidia-smi`` name and power limit, and ``{"ok": true,
"device": ...}``.  It exits non-zero without a result when CUDA is absent
or the port's package is not beside it.  It imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BOX_DX = 0.00409          # scripts/gen_box_case.gen: exactly 256^3 cells
# bench.py --case 3d384: 383^3 cells, whose lines cmcfs_tpu's dispatch
# pads to 384 and, past the pair and stream kernels' 256-cell cap, sends
# to the line sweep
BOX383_DX = 0.0027267
BOX383_SHAPE = (383, 383, 383)
NUM_GLOBAL, NUM_LOCAL = 4, 2
SLICE_STEPS = 3
LONG_STEPS = 2
TIMED_STEPS = 5
LONG_TIMED_STEPS = 3
SEED = 0
# Kernel vs plain, per variable: |delta| <= TOL * max(1, max|plain|).  The
# kernel's nvcc build contracts mul-adds into FMAs and rounds the row
# build / forcing once per fused expression, plain PyTorch rounds every
# op; the diagonally dominant Thomas rows do not amplify the ulp-level
# differences.  One launch and one whole step alike; the other backends'
# steps against the pair step too (the same scheme in other rounding).
TOL = 1e-5
# bound_ms: the least time the card could take, from the published H100
# SXM peaks (NVIDIA's data sheet): 3.35 TB/s device memory, 67 TFLOP/s
# float32 outside the tensor cores
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
CSRC = "cmcfs_tpu_torch/kernels/csrc/"
KERNELS = {
    # name: (source, the TPU kernel(s) it replaces, compulsory bytes a
    # cell per call: each input read once, each output written once,
    # float32 operations a cell per call)
    "pair_sweep": (
        CSRC + "pair_sweep.cu", "cmcfs_tpu/ops/pallas_sweep_nl.py:1068",
        # temp4, rhs4, out_prev4 in; 3 int8 masks; out4, tn4 out
        48 + 3 + 32, 2 * 4 * 40),
    "line_sweep": (
        CSRC + "line_sweep.cu",
        "cmcfs_tpu/ops/pallas_sweep_dma.py:214, "
        "cmcfs_tpu/ops/pallas_sweep_long.py:293, "
        "cmcfs_tpu/ops/pallas_sweep.py:98",
        # adv, pk (int8), d4 in; x4 out
        4 + 1 + 16 + 16, 4 * 14),
    "stream_sweep": (
        CSRC + "pair_sweep.cu",
        "cmcfs_tpu/ops/pallas_sweep_stream.py:400",
        # temp4, rhs4, out_prev4, forcing in; 3 int8 masks; out4, tn4 out
        48 + 4 + 3 + 32, 4 * 30),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str) -> None:
    print(f"\n== {name}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def in_turns(kernel, plain, k_reps: int, p_reps: int):
    """(kernel ms, plain ms), timed in turns: plain, kernel, kernel, plain."""
    tp = cuda_ms(plain, p_reps)
    tk = cuda_ms(kernel, k_reps)
    tk = (tk + cuda_ms(kernel, k_reps)) / 2
    tp = (tp + cuda_ms(plain, p_reps)) / 2
    return tk, tp


def max_rel_err(a4, b4):
    """Per variable max|a - b| and the bound TOL * max(1, max|b|)."""
    errs, bounds = [], []
    for a, b in zip(a4, b4):
        errs.append(float((a - b).abs().max()))
        bounds.append(TOL * max(1.0, float(b.abs().max())))
    return errs, bounds


def check_close(what: str, a4, b4) -> float:
    """Fail unless a4 is finite and within TOL of b4; returns max err."""
    import torch
    errs, bounds = max_rel_err(a4, b4)
    if not bool(torch.isfinite(a4).all()):
        fail(f"{what}: non-finite values")
    if any(e > b for e, b in zip(errs, bounds)):
        fail(f"{what}: max|delta| {errs} beyond bounds {bounds}")
    return max(errs)


class Counters:
    """The launch counters of every kernel wrapper of the port."""

    def __init__(self, **mods):
        self.mods = mods

    def reset(self) -> None:
        for m in self.mods.values():
            m.launches.reset()

    def read(self) -> dict:
        return {k: m.launches.count for k, m in self.mods.items()}


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a GPU")
    if not os.path.isdir(os.path.join(ROOT, "cmcfs_tpu_torch")):
        fail(f"cmcfs_tpu_torch/ not found beside {__file__}: run from a "
             "checkout of the repository")
    sys.path.insert(0, ROOT)
    t_start = time.perf_counter()

    # ------------------------------------------------------------ 1. device
    phase("1. device")
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    from cmcfs_tpu_torch.kernels import build
    nvcc_v = subprocess.run([build.nvcc_path(), "--version"],
                            capture_output=True, text=True, timeout=60,
                            check=True).stdout.strip().splitlines()[-1]
    print(f"device: {name} (count {torch.cuda.device_count()})")
    print(f"nvidia-smi: {smi}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, nvcc: {nvcc_v}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ------------------------------------------------------------- 2. build
    phase("2. build")
    t0 = time.perf_counter()
    klib = build.load_library()
    print(f"built {klib.path} in {klib.build_seconds:.2f} s "
          f"(load total {time.perf_counter() - t0:.2f} s), flags "
          f"{' '.join(build.NVCC_FLAGS)}")
    for line in klib.nvcc_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas:", line.strip())

    from scripts.gen_box_case import gen
    from cmcfs_tpu_torch import cli3d
    from cmcfs_tpu_torch.models import adi3d
    from cmcfs_tpu_torch.models.common3d import (NodeType, grid_arrays,
                                                 init_state,
                                                 update_boundaries)
    from cmcfs_tpu_torch.ops import line_sweep as ls
    from cmcfs_tpu_torch.ops import pair_sweep as ps
    from cmcfs_tpu_torch.ops import stream_sweep as ss
    from cmcfs_tpu_torch.ops.stencil import div_error_3d

    counters = Counters(pair_sweep=ps, line_sweep=ls, stream_sweep=ss)
    rec = {k: {"name": k, "route": "cuda", "source": src, "replaces": rep,
               "launches": 0, "max_abs_err": 0.0, "ms": None,
               "plain_ms": None, "bound_ms": None, "bound_by": None,
               "library_ms": None}
           for k, (src, rep, _, _) in KERNELS.items()}

    def note(kernel, err, ms_list, plain_list, cells):
        """Fold one phase's measurements into the kernel's record."""
        r = rec[kernel]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if ms_list:
            r["ms"] = sum(ms_list) / len(ms_list)
            r["plain_ms"] = sum(plain_list) / len(plain_list)
            nbytes, nflop = KERNELS[kernel][2:]
            t_bytes = cells * nbytes / HBM_BYTES_S * 1e3
            t_ops = cells * nflop / F32_FLOP_S * 1e3
            r["bound_ms"] = max(t_bytes, t_ops)
            r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"

    work = tempfile.mkdtemp(prefix="cmcfs_smoke_")
    data, cfgp = gen(os.path.join(work, "b256"), dx=BOX_DX, time_steps=4,
                     num_global=NUM_GLOBAL, num_local=NUM_LOCAL)

    def noisy_state(ga, grid, gen_t):
        """(temp4, rhs4, op4): interior noise keeps BOUND/VALVE cells at
        their grid values (the UpdateBoundaries invariant)."""
        base4 = torch.stack(tuple(update_boundaries(init_state(grid, dev),
                                                    ga)))
        is_in = ga.types == NodeType.IN

        def noise(scale):
            return scale * torch.randn(base4.shape, generator=gen_t,
                                       device=dev)

        temp4 = torch.where(is_in, base4 + noise(0.01), base4)
        return temp4, temp4 + noise(0.01), temp4 + noise(0.01)

    # --------------------------------------------------- 3. kernel vs plain
    phase("3. pair-sweep kernel vs plain PyTorch, 256^3 bench box")
    t0 = time.perf_counter()
    cfg, params, grid = cli3d.load_case(data, cfgp)
    shape = (grid.dimx, grid.dimy, grid.dimz)
    print(f"grid {shape} built on the host in "
          f"{time.perf_counter() - t0:.2f} s")
    if shape != (256, 256, 256):
        fail(f"bench box is {shape}, expected 256^3")
    ga = grid_arrays(grid, dev)
    pa = adi3d.make_params(params, grid.dx, grid.dy, grid.dz)
    dt = grid.cycle_len / (grid.num_frames * cfg.time_steps)
    gen_t = torch.Generator(device=dev).manual_seed(SEED)
    temp4, rhs4, op4 = noisy_state(ga, grid, gen_t)
    cases = [(0, True, True), (0, False, True), (1, True, False),
             (1, False, False), (2, True, False), (2, False, False)]
    k_ms, p_ms, worst = [], [], 0.0
    print(f"{'dir':<4}{'exact':<7}{'gmerge':<8}{'max|d out|':>12}"
          f"{'max|d tn|':>12}{'kernel ms':>11}{'plain ms':>10}")
    for axis, exact, gmerge in cases:
        scal = adi3d._nl_scal(axis, pa, dt)
        args = (temp4, ga.cls_a[axis], ga.bc_vel, ga.bc_temp, rhs4, op4,
                scal, axis, exact, gmerge)
        ok4, tk4 = ps.pair_sweep(*args)
        op4r, tp4r = ps.pair_sweep_ref(*args)
        torch.cuda.synchronize()
        eo = check_close(f"pair {axis} {exact} out", ok4, op4r)
        et = check_close(f"pair {axis} {exact} tn", tk4, tp4r)
        worst = max(worst, eo, et)
        tk, tp = in_turns(lambda: ps.pair_sweep(*args),
                          lambda: ps.pair_sweep_ref(*args), 5, 2)
        k_ms.append(tk)
        p_ms.append(tp)
        print(f"{'XYZ'[axis]:<4}{str(exact):<7}{str(gmerge):<8}"
              f"{eo:>12.3e}{et:>12.3e}{tk:>11.3f}{tp:>10.2f}", flush=True)
    print(f"(times per pair = 2 kernel launches; {smi})")
    note("pair_sweep", worst, k_ms, p_ms, math.prod(shape))

    # ------------------------------------------------------- 4. stream
    phase("4. stream-sweep kernel vs plain PyTorch, 256^3 bench box")
    k_ms, p_ms, worst = [], [], 0.0
    print(f"{'dir':<4}{'exact':<7}{'max|d out|':>12}{'max|d tn|':>12}"
          f"{'kernel ms':>11}{'plain ms':>10}")
    for axis in range(3):
        forcing = pa.t_phi * adi3d._DISS[axis](temp4[0], temp4[1], temp4[2],
                                               pa.dx, pa.dy, pa.dz)
        for exact in (True, False):
            args = (temp4, ga.cls_a[axis], ga.bc_vel, ga.bc_temp, rhs4, op4,
                    forcing, adi3d._nl_scal(axis, pa, dt)[:5], axis, exact)
            ok4, tk4 = ss.stream_sweep(*args)
            op4r, tp4r = ss.stream_sweep_ref(*args)
            torch.cuda.synchronize()
            eo = check_close(f"stream {axis} {exact} out", ok4, op4r)
            et = check_close(f"stream {axis} {exact} tn", tk4, tp4r)
            worst = max(worst, eo, et)
            tk, tp = in_turns(lambda: ss.stream_sweep(*args),
                              lambda: ss.stream_sweep_ref(*args), 5, 2)
            k_ms.append(tk)
            p_ms.append(tp)
            print(f"{'XYZ'[axis]:<4}{str(exact):<7}{eo:>12.3e}{et:>12.3e}"
                  f"{tk:>11.3f}{tp:>10.2f}", flush=True)
    print(f"(one launch per call; {smi})")
    note("stream_sweep", worst, k_ms, p_ms, math.prod(shape))
    del temp4, rhs4, op4, ok4, tk4, op4r, tp4r, forcing

    # ------------------------------------------------------------- 5. slice
    phase(f"5. pair slice: cli3d.run_case, 256^3 box, ng={NUM_GLOBAL} "
          f"nl={NUM_LOCAL}, {SLICE_STEPS} steps")

    def run_slice(data, cfgp, base, steps, want_dirs, want_launches):
        counters.reset()
        solver, errs = cli3d.run_case(data, os.path.join(work, base), cfgp,
                                      max_steps=steps, collect_errs=True,
                                      device=dev)
        torch.cuda.synchronize()
        got = counters.read()
        nl = cli3d.Config.load(cfgp).num_local
        rep = solver.dispatch_report(nl)
        print(f"\ndispatch: backend={rep['backend']} pad={rep['pad']} "
              f"dirs={rep['dirs']} (num_local={nl})")
        print(f"kernel launches over {steps} steps: {got} "
              f"(expected {want_launches})")
        if set(rep["dirs"].values()) != {want_dirs}:
            fail(f"dispatch is not all {want_dirs}: {rep['dirs']}")
        if any(got[k] != n for k, n in want_launches.items()):
            fail(f"launch counts {got} != {want_launches}")
        cur = solver.cur
        if any(not bool(torch.isfinite(f).all()) for f in cur):
            fail("non-finite fields after the slice")
        err = float(div_error_3d(cur.u, cur.v, cur.w, solver.ga.types,
                                 solver.pa.dx, solver.pa.dy, solver.pa.dz))
        print(f"divergence error per step: {errs}; after the last step: "
              f"{err:.6e} (threshold {adi3d.ERR_THRESHOLD})")
        if not (math.isfinite(err) and err <= adi3d.ERR_THRESHOLD):
            fail(f"divergence error {err} not finite or above threshold")
        return solver, got

    def check_output(solver, base, cfg):
        nc_path = os.path.join(work, base + "_res.nc")
        layer = solver.get_layer(cfg.outdimx, cfg.outdimy, cfg.outdimz)
        print(f"NetCDF output {os.path.getsize(nc_path)} bytes; output "
              f"layer shapes {[a.shape for a in layer]}")
        if any(a.shape != (cfg.outdimx, cfg.outdimy, cfg.outdimz)
               or not bool(((a == 99999.0) | (abs(a) < 1e3)).all())
               for a in layer):
            fail("output layer has the wrong shape or values")

    def time_steps(solver, dt, nl, steps, cells):
        out = {}
        for exact in (True, False):
            solver.exact = exact
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                solver.update_boundaries()
                solver.time_step(dt, NUM_GLOBAL, nl, compute_error=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            out[exact] = wall / steps * 1e3
            print(f"exact={exact}: {wall / steps * 1e3:.2f} ms/step, "
                  f"{cells * steps / wall:.4e} cell-updates/s over {steps} "
                  f"steps ({smi})", flush=True)
        return out

    def step_vs_plain(solver, dt, nl, kernel_mod, attr, plain):
        """One whole step with the kernels against one with ``attr`` of
        adi3d swapped for its plain version, same tensors."""
        solver.update_boundaries()
        args = (solver.cur, solver.next, solver.ga, dt, NUM_GLOBAL, nl,
                solver.pa)
        kw = dict(exact=False, compute_error=False, merge_ok=solver.merge_ok)
        new_k, _ = adi3d.adi_timestep_3d(*args, **kw)
        setattr(adi3d, attr, plain)
        try:
            t0 = time.perf_counter()
            new_p, _ = adi3d.adi_timestep_3d(*args, **kw)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
        finally:
            setattr(adi3d, attr, getattr(kernel_mod, attr))
        err = check_close("whole step kernel vs plain", torch.stack(new_k),
                          torch.stack(new_p))
        print(f"whole step kernel vs plain: max|delta| {err:.3e}; plain "
              f"step {plain_s * 1e3:.1f} ms")
        return err

    per_step = NUM_GLOBAL * 3 * NUM_LOCAL
    solver, got = run_slice(data, cfgp, "box", SLICE_STEPS, "pair",
                            {"pair_sweep": SLICE_STEPS * per_step,
                             "line_sweep": 0, "stream_sweep": 0})
    rec["pair_sweep"]["launches"] = got["pair_sweep"]
    if tuple(solver.cur.u.shape) != shape:
        fail("mis-shaped fields after the slice")
    check_output(solver, "box", cfg)
    timing = {"256 pair": time_steps(solver, dt, NUM_LOCAL, TIMED_STEPS,
                                     math.prod(shape))}
    err = step_vs_plain(solver, dt, NUM_LOCAL, ps, "pair_sweep",
                        ps.pair_sweep_ref)
    note("pair_sweep", err, [], [], 0)

    # ------------------------------------------------------ 6. backends
    phase("6. the other backends, one step each from the pair slice's "
          "state, against the pair step")
    solver.update_boundaries()
    args = (solver.cur, solver.next, solver.ga, dt, NUM_GLOBAL, NUM_LOCAL,
            solver.pa)
    kw = dict(exact=False, compute_error=False, merge_ok=solver.merge_ok)
    ref4 = torch.stack(adi3d.adi_timestep_3d(*args, **kw)[0])
    for backend, kernel in (("fused_dma", "line_sweep"),
                            ("fused", "line_sweep"),
                            ("fused_full", "stream_sweep")):
        counters.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new4 = torch.stack(adi3d.adi_timestep_3d(*args, backend=backend,
                                                 **kw)[0])
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        got = counters.read()
        err = check_close(f"{backend} step vs pair step", new4, ref4)
        print(f"{backend}: launches {got}, max|delta| vs pair step "
              f"{err:.3e}, {step_ms:.2f} ms for the step ({smi})")
        if got[kernel] != per_step or sum(got.values()) != per_step:
            fail(f"{backend}: launches {got}, expected {per_step} of "
                 f"{kernel}")
    del ref4, new4, solver, ga

    # ------------------------------------------------------- 7. odd nl
    phase("7. odd num_local: cli3d.run_case, 256^3 box, ng=4 nl=3")
    data3, cfgp3 = gen(os.path.join(work, "b256nl3"), dx=BOX_DX,
                       time_steps=4, num_global=NUM_GLOBAL, num_local=3)
    solver, got = run_slice(data3, cfgp3, "box_nl3", SLICE_STEPS,
                            "pair+stream",
                            {"pair_sweep": SLICE_STEPS * NUM_GLOBAL * 3 * 2,
                             "stream_sweep": SLICE_STEPS * NUM_GLOBAL * 3,
                             "line_sweep": 0})
    rec["stream_sweep"]["launches"] = got["stream_sweep"]
    timing["256 nl=3"] = time_steps(solver, dt, 3, 2, math.prod(shape))
    del solver

    # ---------------------------------------------------- 8. 383^3 slice
    phase(f"8. long-line slice: cli3d.run_case, 383^3 box, ng={NUM_GLOBAL} "
          f"nl={NUM_LOCAL}, {LONG_STEPS} steps")
    data_l, cfgp_l = gen(os.path.join(work, "b383"), dx=BOX383_DX,
                           time_steps=4, num_global=NUM_GLOBAL,
                           num_local=NUM_LOCAL)
    torch.cuda.reset_peak_memory_stats(dev)
    solver, got = run_slice(data_l, cfgp_l, "box383", LONG_STEPS,
                            "fallback",
                            {"line_sweep": LONG_STEPS * per_step,
                             "pair_sweep": 0, "stream_sweep": 0})
    rec["line_sweep"]["launches"] = got["line_sweep"]
    shape_l = tuple(solver.cur.u.shape)
    if shape_l != BOX383_SHAPE:
        fail(f"long-line box is {shape_l}, expected {BOX383_SHAPE}")
    print(f"peak device memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f}"
          " GB")
    check_output(solver, "box383", cli3d.Config.load(cfgp_l))
    dt_l = solver.grid.cycle_len / (solver.grid.num_frames
                                     * cli3d.Config.load(cfgp_l).time_steps)
    timing["383 fallback"] = time_steps(solver, dt_l, NUM_LOCAL,
                                        LONG_TIMED_STEPS,
                                        math.prod(shape_l))
    err = step_vs_plain(solver, dt_l, NUM_LOCAL, ls, "line_sweep",
                        ls.line_sweep_ref)
    note("line_sweep", err, [], [], 0)

    # ----------------------------------------- 9. line sweep vs plain
    phase("9. line-sweep kernel vs plain PyTorch: 383^3 X / Y / Z, 256^3 X")
    k_ms, p_ms, worst = [], [], 0.0
    ga_l = solver.ga
    temp4 = torch.stack(tuple(solver.cur))
    rhs4 = torch.stack(tuple(solver.next))
    print(f"{'grid':<6}{'dir':<4}{'exact':<7}{'max|d x|':>12}"
          f"{'kernel ms':>11}{'plain ms':>10}")
    for axis in range(3):
        scal = adi3d._nl_scal(axis, solver.pa, dt_l)
        d4 = adi3d.fold_d(*adi3d.fallback_rhs(axis, rhs4, temp4, ga_l,
                                              solver.pa, scal[2]),
                          ga_l.cls_a[axis])
        for exact in (True, False):
            args = (temp4[axis], ga_l.pk_a[axis], d4, scal[:4], axis, exact)
            xk = ls.line_sweep(*args)
            xp = ls.line_sweep_ref(*args)
            torch.cuda.synchronize()
            e = check_close(f"line {axis} {exact}", xk, xp)
            worst = max(worst, e)
            tk, tp = in_turns(lambda: ls.line_sweep(*args),
                              lambda: ls.line_sweep_ref(*args), 3, 1)
            k_ms.append(tk)
            p_ms.append(tp)
            print(f"{'383':<6}{'XYZ'[axis]:<4}{str(exact):<7}{e:>12.3e}"
                  f"{tk:>11.3f}{tp:>10.2f}", flush=True)
        del d4, xk, xp
    note("line_sweep", worst, k_ms, p_ms, math.prod(shape_l))
    del solver, ga_l, temp4, rhs4
    torch.cuda.empty_cache()
    ga = grid_arrays(grid, dev)
    temp4, rhs4, _ = noisy_state(ga, grid, gen_t)
    scal = adi3d._nl_scal(0, pa, dt)
    d4 = adi3d.fold_d(*adi3d.fallback_rhs(0, rhs4, temp4, ga, pa, scal[2]),
                      ga.cls_a[0])
    for exact in (True, False):
        args = (temp4[0], ga.pk_a[0], d4, scal[:4], 0, exact)
        xk = ls.line_sweep(*args)
        xp = ls.line_sweep_ref(*args)
        torch.cuda.synchronize()
        e = check_close(f"line 256 X {exact}", xk, xp)
        rec["line_sweep"]["max_abs_err"] = max(
            rec["line_sweep"]["max_abs_err"], e)
        tk, tp = in_turns(lambda: ls.line_sweep(*args),
                          lambda: ls.line_sweep_ref(*args), 3, 1)
        print(f"{'256':<6}{'X':<4}{str(exact):<7}{e:>12.3e}{tk:>11.3f}"
              f"{tp:>10.2f}", flush=True)
    print(f"(one launch per call; {smi})")

    # ------------------------------------------------------------ result
    phase("result")
    print(f"ms/step by slice and exact mode: {json.dumps(timing)}")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(rec.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
