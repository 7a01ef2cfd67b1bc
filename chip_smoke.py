#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's 3D ADI main path once on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card
and nvcc.  Phases, each of which raises on failure:

1. device: card name, power limit, torch / CUDA / nvcc versions;
2. build: nvcc builds cmcfs_tpu_torch/kernels/csrc/*.cu for sm_90a;
3. kernel vs plain: the pair-sweep kernel against its plain PyTorch
   version on the 256^3 bench box, X / Y / Z, both ``exact`` modes,
   gmerge on X, with CUDA-event times of both;
4. slice: ``cmcfs_tpu_torch.cli3d.run_case`` on the 256^3 box at
   num_global=4, num_local=2 with NetCDF output; dispatch, launch count,
   ms/step, cell-updates/s, divergence error; then one whole step with the
   kernel against one with the plain version.

The last lines are a JSON record of the kernels, the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``.
It exits non-zero without a result when CUDA is absent or the port's
package is not beside it.  It imports nothing of JAX.
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
NUM_GLOBAL, NUM_LOCAL = 4, 2
SLICE_STEPS = 3
TIMED_STEPS = 5
SEED = 0
# Kernel vs plain, per variable: |delta| <= TOL * max(1, max|plain|).  The
# kernel's nvcc build contracts mul-adds into FMAs and rounds the row
# build / forcing once per fused expression, plain PyTorch rounds every
# op; the diagonally dominant Thomas rows do not amplify the ulp-level
# differences.  One pair and one whole step (24 chained pairs) alike.
TOL = 1e-5
KERNEL_SOURCE = "cmcfs_tpu_torch/kernels/csrc/pair_sweep.cu"
REPLACES = "cmcfs_tpu/ops/pallas_sweep_nl.py:1068"


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


def max_rel_err(a4, b4):
    """Per variable max|a - b| and the bound TOL * max(1, max|b|)."""
    errs, bounds = [], []
    for a, b in zip(a4, b4):
        errs.append(float((a - b).abs().max()))
        bounds.append(TOL * max(1.0, float(b.abs().max())))
    return errs, bounds


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
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    from scripts.gen_box_case import gen
    from cmcfs_tpu_torch import cli3d
    from cmcfs_tpu_torch.models import adi3d
    from cmcfs_tpu_torch.models.common3d import (NodeType, grid_arrays,
                                                 init_state,
                                                 update_boundaries)
    from cmcfs_tpu_torch.ops import pair_sweep as ps
    from cmcfs_tpu_torch.ops.stencil import div_error_3d

    work = tempfile.mkdtemp(prefix="cmcfs_smoke_")
    data, cfgp = gen(work, dx=BOX_DX, time_steps=4, num_global=NUM_GLOBAL,
                     num_local=NUM_LOCAL)

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
    base4 = torch.stack(tuple(update_boundaries(init_state(grid, dev), ga)))
    gen_t = torch.Generator(device=dev).manual_seed(SEED)
    is_in = ga.types == NodeType.IN

    def noise(scale):
        return scale * torch.randn(base4.shape, generator=gen_t, device=dev)

    # interior perturbation keeps BOUND/VALVE cells at their grid values
    temp4 = torch.where(is_in, base4 + noise(0.01), base4)
    rhs4 = temp4 + noise(0.01)
    op4 = temp4 + noise(0.01)
    cases = [(0, True, True), (0, False, True), (1, True, False),
             (1, False, False), (2, True, False), (2, False, False)]
    k_ms, p_ms, worst = [], [], 0.0
    print(f"{'dir':<4}{'exact':<7}{'gmerge':<8}{'max|d out|':>12}"
          f"{'max|d tn|':>12}{'bound':>10}{'kernel ms':>11}{'plain ms':>10}")
    bad = []
    for axis, exact, gmerge in cases:
        scal = adi3d._nl_scal(axis, pa, dt)
        args = (temp4, ga.cls_a[axis], ga.bc_vel, ga.bc_temp, rhs4, op4,
                scal, axis, exact, gmerge)
        ok4, tk4 = ps.pair_sweep(*args)
        op4r, tp4r = ps.pair_sweep_ref(*args)
        torch.cuda.synchronize()
        eo, bo = max_rel_err(ok4, op4r)
        et, bt = max_rel_err(tk4, tp4r)
        finite = bool(torch.isfinite(ok4).all() and torch.isfinite(tk4).all())
        if not finite or any(e > b for e, b in zip(eo + et, bo + bt)):
            bad.append((axis, exact, gmerge, eo, et, bo, bt, finite))
        worst = max(worst, max(eo + et))
        # device times in turns: plain, kernel, kernel, plain
        tp = cuda_ms(lambda: ps.pair_sweep_ref(*args), 2)
        tk = cuda_ms(lambda: ps.pair_sweep(*args), 5)
        tk = (tk + cuda_ms(lambda: ps.pair_sweep(*args), 5)) / 2
        tp = (tp + cuda_ms(lambda: ps.pair_sweep_ref(*args), 2)) / 2
        k_ms.append(tk)
        p_ms.append(tp)
        print(f"{'XYZ'[axis]:<4}{str(exact):<7}{str(gmerge):<8}"
              f"{max(eo):>12.3e}{max(et):>12.3e}{min(bo + bt):>10.1e}"
              f"{tk:>11.3f}{tp:>10.2f}", flush=True)
    print(f"(times per pair = 2 kernel launches; {smi})")
    if bad:
        fail(f"kernel disagrees with plain beyond TOL={TOL}: {bad}")
    del temp4, rhs4, op4, base4, ok4, tk4, op4r, tp4r

    # ------------------------------------------------------------- 4. slice
    phase(f"4. slice: cli3d.run_case, 256^3 box, ng={NUM_GLOBAL} "
          f"nl={NUM_LOCAL}, {SLICE_STEPS} steps")
    ps.launches.reset()
    solver, errs = cli3d.run_case(data, os.path.join(work, "box"), cfgp,
                                  max_steps=SLICE_STEPS, collect_errs=True,
                                  device=dev)
    torch.cuda.synchronize()
    launches = ps.launches.count
    expected = SLICE_STEPS * NUM_GLOBAL * 3 * (NUM_LOCAL // 2) * 2
    dirs = solver.dispatch_report(NUM_LOCAL)["dirs"]
    print(f"dispatch dirs: {dirs}")
    print(f"pair_sweep kernel launches: {launches} (expected {expected})")
    if dirs != {"X": "pair", "Y": "pair", "Z": "pair"}:
        fail(f"dispatch is not all pair: {dirs}")
    if launches != expected:
        fail(f"launch count {launches} != {expected}")
    cur = solver.cur
    if any(tuple(f.shape) != shape or not bool(torch.isfinite(f).all())
           for f in cur):
        fail("non-finite or mis-shaped fields after the slice")
    err = float(div_error_3d(cur.u, cur.v, cur.w, solver.ga.types,
                             solver.pa.dx, solver.pa.dy, solver.pa.dz))
    print(f"divergence error per step: {errs}; after the last step: {err:.6e}"
          f" (threshold {adi3d.ERR_THRESHOLD})")
    if not (math.isfinite(err) and err <= adi3d.ERR_THRESHOLD):
        fail(f"divergence error {err} not finite or above threshold")
    nc_path = os.path.join(work, "box_res.nc")
    layer = solver.get_layer(cfg.outdimx, cfg.outdimy, cfg.outdimz)
    print(f"NetCDF output {os.path.getsize(nc_path)} bytes; output layer "
          f"shapes {[a.shape for a in layer]}")
    if any(a.shape != (cfg.outdimx, cfg.outdimy, cfg.outdimz)
           or not bool(((a == 99999.0) | (abs(a) < 1e3)).all())
           for a in layer):
        fail("output layer has the wrong shape or values")

    cells = math.prod(shape)
    timing = {}
    for exact in (True, False):
        solver.exact = exact
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            solver.update_boundaries()
            solver.time_step(dt, NUM_GLOBAL, NUM_LOCAL, compute_error=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        timing[exact] = wall / TIMED_STEPS
        print(f"exact={exact}: {wall / TIMED_STEPS * 1e3:.2f} ms/step, "
              f"{cells * TIMED_STEPS / wall:.4e} cell-updates/s over "
              f"{TIMED_STEPS} steps ({smi})")

    # one whole step, kernel vs plain, from the slice's state
    solver.update_boundaries()
    step_args = (solver.cur, solver.next, solver.ga, dt, NUM_GLOBAL,
                 NUM_LOCAL, solver.pa)
    kw = dict(exact=False, compute_error=False, merge_ok=solver.merge_ok)
    new_k, _ = adi3d.adi_timestep_3d(*step_args, **kw)
    adi3d.pair_sweep = ps.pair_sweep_ref     # plain version, same tensors
    try:
        t0 = time.perf_counter()
        new_p, _ = adi3d.adi_timestep_3d(*step_args, **kw)
        torch.cuda.synchronize()
        plain_step = time.perf_counter() - t0
    finally:
        adi3d.pair_sweep = ps.pair_sweep
    es, bs = max_rel_err(new_k, new_p)
    print("whole step kernel vs plain, max|delta| u v w T: "
          + " ".join(f"{e:.3e}" for e in es)
          + f" (bounds {' '.join(f'{b:.1e}' for b in bs)}); plain step "
          f"{plain_step * 1e3:.1f} ms")
    if any(e > b for e, b in zip(es, bs)):
        fail("whole step: kernel disagrees with plain")
    worst = max(worst, max(es))

    # ------------------------------------------------------------ 5. result
    rec = {"kernels": [{
        "name": "pair_sweep", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": worst,
        "ms": sum(k_ms) / len(k_ms), "plain_ms": sum(p_ms) / len(p_ms)}]}
    print(json.dumps(rec))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
