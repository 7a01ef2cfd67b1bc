#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's 3D and 2D paths once on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card
and nvcc.  Phases, each of which raises on failure:

1. device: card name, power limit, torch / CUDA / nvcc versions;
2. build: nvcc builds cmcfs_tpu_torch/kernels/csrc/*.cu for sm_90a, one
   process per source; every kernel's registers and spills from the
   build's ``ptxas -v`` log (float32, bf16 and PCR instantiations alike),
   failing if a PCR or bf16 instantiation spills;
3. pair kernel vs plain: the pair-sweep kernel against its plain PyTorch
   version on the 256^3 bench box, X / Y / Z, both ``exact`` modes,
   gmerge on X, with CUDA-event times of both and the GB/s that the
   source's count of the bytes the kernel moves (``MOVED``) gives;
4. stream kernel vs plain on the same inputs, X / Y / Z, both modes;
5. pair slice: ``cmcfs_tpu_torch.cli3d.run_case`` on the 256^3 box at
   num_global=4, num_local=2 with NetCDF output; dispatch (all ``pair``),
   launch count, ms/step, cell-updates/s, divergence error; then one
   whole step with the kernel against one with the plain version;
6. the other backends: one step each of ``fused_dma``, ``fused`` (24
   fallback-iteration launches) and ``fused_full`` (24 stream launches)
   from the pair slice's state, each against the pair step;
7. odd num_local: ``run_case`` on the 256^3 box at ng=4 nl=3: dispatch
   all ``pair+stream``, 24 pair and 12 stream launches a step;
8. long-line slice: ``run_case`` on ``bench --case 3d384``'s box
   (383^3) at ng=4 nl=2: dispatch all ``fallback``, 24 launches a step
   of the fallback iteration (``line_sweep.fallback_iteration``) and
   none of the line sweep alone, ms/step and cell-updates/s in both
   ``exact`` modes, divergence error, host grid-build time, NetCDF
   output; one whole step kernel vs plain;
9. line-sweep kernel vs plain on that 383^3 state (X / Y / Z, lines past
   the TPU kernels' 288-cell cap; Z also at each Z tile the source
   builds, ``line_sweep.Z_ROWS``); the fallback iteration's launch
   against its plain version bit for bit on the same state (X / Y / Z),
   timed beside the plain version and the composition it replaces (the
   right-hand side, the folds, the line sweep's launch, the two
   ``where``s, bit for bit too); then the line sweep on the 256^3 box
   (X / Y / Z, the shapes of dual axes of ``fused_dma``), both ``exact``
   modes, with CUDA-event times;
10. the 2D modes and the row solve vs plain: the 2D line sweep on the
   2D box case (``scripts/gen_box_case.gen_2d``, 1041^2) and on the
   2048^2 lid cavity, X / Y; the 2D stream sweep on the 1024^2 lid
   cavity, X / Y, ``first`` both ways; the tridiag_rows kernel on the 2D
   box's rows (3 variables, X / Y, scan and pallas forms) and on the
   256^3 pair slice's state (X / Y / Z), u, v and w on their shared rows
   (k = 3, one launch) and T (k = 1); both ``exact`` modes, with
   CUDA-event times;
11. 2d1024 (``bench.py --case 2d1024``'s configuration: lid cavity 1024^2,
   physical parameters, dt 0.0005, ng=2 nl=1, ``exact=False``, backend
   ``fused_nl``): dispatch stream on X and Y, 2 stream launches per global
   iteration, ms/step and cell-updates/s, divergence error; one whole
   step kernel vs plain;
12. 2d2048: the same at 2048^2, where the dispatch is the line sweep;
13. the 2D CLI: ``cmcfs_tpu_torch.cli2d.run_case`` on the 2D box case
   (``fused_dma``: the line sweep) with CDL output and its section times
   (Prepare, UpdateBoundaries, TimeStep, Output); then one step each of
   backends ``pallas`` and ``scan`` (tridiag_rows launches), each bit for
   bit the same step on the CPU, and ``pcr`` (cyclic reduction in PyTorch
   ops, no kernel) from its state, with the distance of each to the
   ``fused_dma`` step (and, for the rows, the CPU's own distance: the rows
   divide by 2h where the line sweep multiplies by 1/(2h), which v_T
   amplifies at this box's physical parameters);
14. the 3D row path: one step each of ``pallas`` and ``scan`` from the
   256^3 pair slice's state (48 tridiag_rows launches each: (u, v, w)
   and T per direction and local iteration) and of ``pcr`` (no kernel),
   each against the pair step;
15. the probes: ``cmcfs_tpu_torch.probes``' five measurement probes
   (row cost, ILP, slab copy, the stream-kernel floors, in-kernel
   dissipation) at their scripts' defaults, every variant's kernel
   against its plain version (bit for bit but where a variant's tolerance
   says otherwise), each probe's table printed;
16. duals: the lid cavity at 256^3 with the FREE baffle
   (``geom.baffle.free_baffled``) through ``make_solver_3d("ADI",
   backend="auto")`` at ng=4 nl=2, 3 steps: X dispatches ``pair`` on
   lines with FREE dual endpoints (the pair kernel's dual form, 8
   launches a step; Y and Z the dual-free pair), ms/step in both ``exact``
   modes, the divergence check; the dual pair kernel against its plain
   version on X and on the baffle turned onto Y and Z, both ``exact``
   modes, gmerge, timed beside the dual-free pair on the same inputs; one
   step against the ``fused_dma`` step (the fallback's two-pass stitch)
   from the same state;
17. PCR: ``run_case`` on the 256^3 box with backend ``fused_pcr`` at ng=4
   nl=2: all three directions ``pair`` on the PCR kernel (24 launches a
   step), ms/step; the PCR kernel against its plain version on X, Y and
   Z and with the baffle's duals on X, both ``exact`` modes, float32 and
   bf16 payloads (bf16 bit for bit), each timed; every PCR
   instantiation's registers, local memory and blocks an SM as the card
   reports them (failing on local memory or under two blocks); one step
   against the ``fused_nl`` step from the same state (PCR against
   Thomas: not bit for bit, held to the same bound); one step at nl=3
   (``pair+stream``: the trailing iteration on the stream sweep); one
   ``fused_pcr`` step on the baffle grid (PCR with the dual chains)
   against its ``auto`` step;
18. bf16 payloads: every bf16 kernel mode against its plain version bit
   for bit, with CUDA-event times of it, of its float32 twin on the same
   inputs and of the plain version, both ``exact`` modes (the pair,
   stream and line sweeps on the 256^3 box, X / Y / Z, the line sweep's
   Z at each tile; the dual pair on the baffle turned onto each axis; the
   2D stream at 1024^2, the 2D line at 2048^2 and on the 1041^2 box; the
   line sweep at 383^3; bf16 PCR: phase 17); then
   ``run_case`` on the 256^3 box with ``fused_bf16`` (all ``pair``, 24
   bf16 pair launches a step) and with ``fused_pcr_bf16`` (24 bf16 PCR
   launches), ms/step in both modes, a whole step kernels against plain
   versions bit for bit and against its float32 twin (``fused_nl``,
   ``fused_pcr``) within BF16_TOL; one ``fused_bf16`` step at nl=3 (the
   bf16 stream iteration), one on the baffle (the bf16 dual pair), the
   383^3 box on ``fused_bf16`` (the bf16 line sweep, ms/step, bit for
   bit, against ``fused_nl``), 2d2048 and 2d1024 on ``fused_bf16`` (the
   2D line sweep) and the 2D CLI box on it; and ``fused_bf16`` beside
   ``fused_nl`` for 100 steps on the box at about 128^3, max|du|/max|u|
   at steps 10, 50 and 100;
19. the Explicit and Stable schemes in 3D (PyTorch ops; no kernel backs
   them, none launches): ``stencil.over``'s quotients on the card against
   the CPU's, bit for bit, with a host-scalar division's count of
   differing values beside them; ``make_solver_3d`` on the 256^3 lid cavity at
   ng=2, dt 4e-4 (inside the explicit limit), 3 Explicit steps and one
   Stable step, ms a step, the divergence error and the Poisson
   iterations of each global iteration; the same at 64^3 on the card and
   on the CPU (``device="cpu"``), within 1e-6 * max(1, max|field|) with
   equal Poisson counts;
20. the schemes in 2D: ``make_solver`` on the 2d2048 lid cavity, 3
   Explicit steps and one Stable step; Stable's ``sequential`` order one
   step at 32^2 (a cut: its waves grow with the grid); card against CPU
   at 128^2 and for the sequential step;
21. the CLI flags: ``cli3d.run_case`` on the 256^3 box (the pair), 4
   steps straight against 2 with ``checkpoint`` and 2 ``resume``d (state
   and NetCDF file bit for bit), ``carried`` (the same), ``dump_grid``
   (dimz BMP files), ``profile`` (its event table; the direction
   sections against unprofiled steps); ``cli2d`` checkpoint and resume on
   the 2D box (state and CDL frames bit for bit); each scheme through
   both CLIs by the config's ``solver`` line;
22. ``python -m cmcfs_tpu_torch.verify`` on the 256^3 box, 2 steps,
   ``scan`` against ``auto``: returns 0;
23. the X split (``parallel/mesh.py``) on the one card, the MGPU_EMU
   analogue (``devices=["cuda:0"] * N``): ``cli3d.run_case`` on the 256^3
   box, ``auto``, over 2 and 4 shards, each step bit for bit phase 5's,
   the error within 1e-6 relative, N times phase 5's pair launches,
   ms/step beside phase 5's; ``balance EVEN_VOLUME`` over 2 shards, the
   baffle over 2 (phase 16's steps, X's duals through the reshard) and
   the 383^3 fallback over 2 (phase 8's first step), bit for bit; one
   nl=3 step over 2 (X on the fallback under a split, as cmcfs_tpu
   dispatches it) within TOL of phase 7's; ``cli3d.main([..., "shards",
   "2"])``, which refuses naming the visible count on one card and is
   held bit for bit on two; under a minute;
24. the Z-blocked wavefront X sweep (``blocking nBlockZ``) on shards
   emulated on the one card: the carry kernels (``tridiag_carry.cu``)
   against their plain versions bit for bit at a 2-shard slab of the
   256^3 box (k = 3 and 1, both ``exact`` modes, the first, a middle and
   the last shard), timed as one block's X solve of the 4 variables;
   ``scan`` at ng=4 nl=2, 2 steps over 2 and 4 shards with nblockz 8, bit
   for bit the unblocked split in both modes (the carry kernels' launch
   count checked); ``auto`` at nl=3 over 2 shards with blocking 8 (X on
   the wavefront, Y/Z pair+stream) within TOL of the unblocked split,
   and its X direction alone (a bf16 out layer in, exact) bit for bit
   the single device's ``scan`` X direction;
   ``auto`` at nl=2 with blocking 8 (X stays ``pair``) bit for bit phase
   5's first step; 383^3 ``fused_dma`` over 2 shards with blocking 8, one
   step within TOL of phase 8's, timed beside the unblocked split's;
   ms/step at nb = 1 (the reshard), 4, 8, 16 in both modes for the
   ``scan`` and the nl=3 runs;
25. the Explicit and Stable schemes split over X on the one card: the
   64^3 lid cavity, 3 Explicit steps and one Stable step over 2 and 4
   shards, bit for bit the unsharded steps with equal Poisson counts;
   the 256^3 cavity at ng=2, 3 Explicit steps (ms a step) and one Stable
   step (its time and Poisson counts) over 2 shards, bit for bit phase
   19's.

Phases 19-25 print their seconds.  Every kernel's launch counter is set
to 0 just before a path is driven and read just after; launches made to compare a kernel with its plain
version do not count.  The last lines are a JSON record of the kernels,
the card's ``nvidia-smi`` name and power limit, and ``{"ok": true,
"device": ...}``.  It exits non-zero without a result when CUDA is absent
or the port's package is not beside it.  It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import types

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
# the 2D configurations: bench.py run_bench_2d (bench.py:23-63) and the 2D
# box case of scripts/gen_box_case.gen_2d, whose dx=0.001 builds 1041^2
DT2 = 0.0005
TIMED_STEPS_2D = 10
BOX2D_DX = 0.001
BOX2D_SHAPE = (1041, 1041)
CLI2D_STEPS = 5
# the FREE baffle's lid cavity (dx 0.01, normalized parameters Re 200, Pr
# 0.72, lambda 1.4, as the tests run it)
BAFFLE_DT = 0.01
# Kernel vs plain, per variable: |delta| <= TOL * max(1, max|plain|).  The
# kernels round every product before they add it (__fmul_rn / __fadd_rn /
# __fsub_rn), in their plain versions' order of operations, so they match
# those versions bit for bit; TOL is the bound a kernel must hold, not a
# rounding allowance.  One launch and one whole step alike; the other
# backends' steps against the pair step too (the same scheme in another
# order of operations).
TOL = 1e-5
# A bf16 backend's step against its float32 twin's: |delta| <= BF16_TOL *
# max(1, max|field|) per variable, the bound cmcfs_tpu's own
# test_bf16_storage_close_to_f32 and test_fused_pcr_bf16_close_to_f32 hold
# its bf16 steps to (tests/test_backends3d.py:97-150).  Each bf16 kernel
# and step against its plain version: bit for bit.
BF16_TOL = 0.02
# phases 19-20: the Explicit and Stable schemes, PyTorch ops (no kernel
# backs them, in cmcfs_tpu either: XLA ops).  3D: tests/test_solvers3d_ext.py's
# lid cavity at full size (dx = 1/n, lid 0.2, normalized Re 200, Pr 0.72,
# lambda 1.4); the explicit limit dx^2 / (6 nu) is 5.09e-4 at 256^3.  One
# Stable step at 256^3 took 28.7 s at ng=2 (NVIDIA H100 80GB HBM3, 700 W:
# 2437 and 3617 Poisson iterations), so both schemes run at ng=2.
SCHEME_N = 256
SCHEME_DT = 4e-4
SCHEME_NG = 2
EXPLICIT_STEPS = 3
# card against the port on the CPU: the sizes, and the CPU tests' bound
# (tests/torch_schemes.REL): |delta| <= SCHEME_REL * max(1, max|cpu|)
SCHEME_CHECK_N = 64
SCHEME_CHECK_N2D = 128
SCHEME_REL = 1e-6
# 2D: the 2d2048 configuration (bench.py run_bench_2d: lid cavity 2048^2,
# dx 0.001, physical parameters, dt 0.0005 inside dx^2 / (4 nu) = 0.005,
# ng=2); the sequential Gauss-Seidel order runs one small grid (cut): a
# sweep is about 2n waves of a few launches each (32^2: 12.6 s for a step
# of 928 + 1577 sweeps, 48^2 31.4 s, 64^2 54.6 s on the H100 above)
SEQ_N = 32
# phase 21: the CLI runs at k steps and 2k steps
CLI_K = 2
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
    # the dual-free fallback iteration on the line sweep's walk (the
    # kernel line_sweep_kernel on FallbackRows): temp4, rhs4, out_prev4
    # in, the packed code and the node type (int8), out4, tn4 out (the
    # grid's values, read at the boundary rows only, left out); the line
    # sweep's operations and 42 more a cell: 30 of the right-hand side
    # (the dissipation's five derivatives and their products and sums),
    # 12 of the update
    "line_fallback": (
        CSRC + "line_sweep.cu",
        "cmcfs_tpu/models/adi3d.py:213-302 (_build_and_solve_3d's fused "
        "branch: XLA around the line sweep's pallas_call)",
        48 + 2 + 32, 4 * 14 + 42),
    "stream_sweep": (
        CSRC + "pair_sweep.cu",
        "cmcfs_tpu/ops/pallas_sweep_stream.py:400",
        # temp4, rhs4, out_prev4, forcing in; 3 int8 masks; out4, tn4 out
        48 + 4 + 3 + 32, 4 * 30),
    # the 2D modes, timed at the 2d2048 / 2d1024 main-path shapes
    "line_sweep_2d": (
        CSRC + "line_sweep.cu",
        "cmcfs_tpu/ops/pallas_sweep_dma.py:214, "
        "cmcfs_tpu/ops/pallas_sweep_long.py:293 (t_var=2, bc2d)",
        # adv, pk (int8), d3 in; x3 out
        4 + 1 + 12 + 12, 3 * 14),
    "stream_sweep_2d": (
        CSRC + "pair_sweep.cu",
        "cmcfs_tpu/ops/pallas_sweep_stream.py:400 (merge2d)",
        # temp3, rhs3, out_prev3, forcing in; cls and bct (int8); out3,
        # tn3 out
        36 + 4 + 2 + 24, 3 * 30),
    # the pair kernel's dual form, timed on the 256^3 baffle turned onto
    # each axis: the pair's bytes and the flag plane; pass B adds its c'
    # of two rows, d' of four variables and their substitutions, 30
    # operations a cell an iteration
    "pair_sweep_dual": (
        CSRC + "pair_sweep.cu",
        "cmcfs_tpu/ops/pallas_sweep_nl.py:1068 (has_dual: :193-202, "
        ":417-450, :491-535)",
        48 + 3 + 32 + 1, 2 * (4 * 40 + 30)),
    # the PCR pair, timed at 256^3: the pair's bytes; per iteration and
    # cell, counted from pcr_sweep.cu: 43 operations of rows, right-hand
    # sides, dissipation and update, and 32 a level of the two chains
    # (ops/pcr.py: 2 divisions and 16 products and sums on the velocity
    # chain and its 3 d's, 2 and 10 on T's), ceil(log2 256) = 8 levels
    "pcr_sweep": (
        CSRC + "pcr_sweep.cu",
        "cmcfs_tpu/ops/pallas_sweep_nl.py:1068 (pcr: :538-660, :758-1012)",
        48 + 3 + 32, 2 * (43 + 32 * 8)),
    # the 3D row path's velocity launch, timed at 256^3: a, b, c and the
    # d of u, v, w in, their x out (k = 3); 4 operations a cell for c', 5
    # for each d' and x
    "tridiag_rows": (
        CSRC + "tridiag_rows.cu", "cmcfs_tpu/ops/pallas_tridiag.py:93",
        12 + 3 * 8, 4 + 3 * 5),
    # the wavefront's carry passes, one block's X solve of the 4 variables
    # (forward and backward at k = 3 and k = 1), timed at a 2-shard slab
    # of the 256^3 box: forward k=3 reads a, b, c, 3 d (24) and writes c',
    # 3 d' (16), backward k=3 reads c', 3 d' (16) and writes 3 x (12);
    # k=1 16 / 8 and 8 / 4; 3 + 3 operations a row for c' and each d' of
    # the forward pass, 2 for each x
    "tridiag_carry": (
        CSRC + "tridiag_carry.cu",
        "cmcfs_tpu/parallel/pipeline.py:26,45 (lax.scan, no pallas_call)",
        104, (3 + 3 * 3 + 2 * 3) + (3 + 3 + 2)),
    # per (cell, variable): a, b, c, d in, x out; the 2D box's 3 variables
    "tridiag_rows_2d": (
        CSRC + "tridiag_rows.cu", "cmcfs_tpu/ops/pallas_tridiag.py:93",
        20, 8),
    # the bf16 payload mode of each: rhs, out_prev (d) in and out, tn (x)
    # out in bf16, temp, adv, masks and forcing as above; the float32 twin's
    # operations (the conversions aside)
    "pair_sweep_bf16": (
        CSRC + "pair_sweep_bf16.cu",
        "cmcfs_tpu/ops/pallas_sweep_nl.py:1068 (bf16: :172, :225-271)",
        # temp4 16, masks 3, rhs4 8, out_prev4 8, out4 8, tn4 8
        16 + 3 + 8 + 8 + 8 + 8, 2 * 4 * 40),
    "pair_sweep_dual_bf16": (
        CSRC + "pair_sweep_bf16.cu",
        "cmcfs_tpu/ops/pallas_sweep_nl.py:1068 (has_dual, bf16)",
        16 + 3 + 8 + 8 + 8 + 8 + 1, 2 * (4 * 40 + 30)),
    "pcr_sweep_bf16": (
        CSRC + "pcr_sweep_bf16.cu",
        "cmcfs_tpu/ops/pallas_sweep_nl.py:1068 (pcr, bf16)",
        16 + 3 + 8 + 8 + 8 + 8, 2 * (43 + 32 * 8)),
    "stream_sweep_bf16": (
        CSRC + "stream_sweep_bf16.cu",
        "cmcfs_tpu/ops/pallas_sweep_stream.py:400 (bf16: :28, :93-110, "
        ":447-452)",
        # temp4 16, masks 3, forcing 4, rhs4 8, out_prev4 8, out4 8, tn4 8
        16 + 3 + 4 + 8 + 8 + 8 + 8, 4 * 30),
    "stream_sweep_2d_bf16": (
        CSRC + "stream_sweep_bf16.cu",
        "cmcfs_tpu/ops/pallas_sweep_stream.py:400 (merge2d, bf16)",
        # temp3 12, cls and bct 2, forcing 4, rhs3 6, out_prev3 6, out3 6,
        # tn3 6
        12 + 2 + 4 + 6 + 6 + 6 + 6, 3 * 30),
    "line_sweep_bf16": (
        CSRC + "line_sweep_bf16.cu",
        "cmcfs_tpu/ops/pallas_sweep_dma.py:214 (bf16: :38, :79-81, :263), "
        "cmcfs_tpu/ops/pallas_sweep_long.py:293 (bf16: :310, :344-353)",
        # adv 4, pk 1, d4 8, x4 8
        4 + 1 + 8 + 8, 4 * 14),
    "line_sweep_2d_bf16": (
        CSRC + "line_sweep_bf16.cu",
        "cmcfs_tpu/ops/pallas_sweep_dma.py:214, "
        "cmcfs_tpu/ops/pallas_sweep_long.py:293 (t_var=2, bc2d, bf16)",
        # adv 4, pk 1, d3 6, x3 6
        4 + 1 + 6 + 6, 3 * 14),
}
# bytes a cell a call that each kernel's design moves by its source note's
# count, printed beside the compulsory bytes above with the GB/s they give
# at the measured time: an estimate, not a measured rate.  pair_sweep.cu:
# 148 a launch in the 3D pair mode (two launches a pair), 152 in the 3D
# stream mode, 120 in 2D (the cross-line neighbour reads, mostly cache
# hits, left out); line_sweep.cu: 85 in 3D, 69 in 2D (the scratch's six or
# five planes written and read), 147 the fallback iteration (its
# scratch, and temp, out_prev and the masks read again on the way back;
# the cross-line neighbours left out); tridiag_rows.cu: 20 + 16 k, 68 for the
# velocity launch (k = 3), 36 a variable in 2D (k = 1); the dual pair 198
# a launch; pcr_sweep.cu 99 a launch; tridiag_carry.cu the compulsory 104
# (no scratch: c' and d' are its outputs)
MOVED = {"pair_sweep": 2 * 148, "stream_sweep": 152, "stream_sweep_2d": 120,
         "line_sweep": 85, "line_sweep_2d": 69, "line_fallback": 147,
         "tridiag_rows": 68,
         "tridiag_rows_2d": 36, "pair_sweep_dual": 2 * 198,
         "pcr_sweep": 2 * 99, "tridiag_carry": 104}
# the probes: (source, the TPU probe it replaces, the variant whose
# numbers the record carries: each script's first); their bytes and
# operations come from each variant's row (cmcfs_tpu_torch/probes)
PROBE_KERNELS = {
    "probe_rowcost": (CSRC + "probe_rowcost.cu",
                      "scripts/probe_rowcost.py:47", "base"),
    "probe_ilp": (CSRC + "probe_ilp.cu", "scripts/probe_ilp.py:50",
                  "seq@65536"),
    "probe_slabdma": (CSRC + "probe_slabdma.cu",
                      "scripts/probe_slabdma.py:47", "strided@d4"),
    "kernel_probe": (CSRC + "kernel_probe.cu", "scripts/kernel_probe.py:34",
                     "dma"),
    "probe_diss_bitwise": (CSRC + "probe_diss.cu",
                           "scripts/probe_diss_bitwise.py:77",
                           "rounded@256x256x256"),
}
PROBE_REPS = 3
# phase 18's bf16 drift: steps of fused_bf16 beside fused_nl from the start
DRIFT_STEPS = 100
DRIFT_AT = (10, 50, 100)
# phase 24: the wavefront's nBlockZ, and the block counts it times
NBLOCKZ = 8
NB_TIMED = (1, 4, 8, 16)


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


def twin_err(what: str, bf4, f4) -> float:
    """A bf16 backend's step against its float32 twin's from the same
    state: fail unless finite and within BF16_TOL * max(1, max|field|)
    per variable; returns the largest max|delta|."""
    import torch
    if not bool(torch.isfinite(bf4).all()):
        fail(f"{what}: non-finite values")
    errs = [float((a - b).abs().max()) for a, b in zip(bf4, f4)]
    bounds = [BF16_TOL * max(1.0, float(b.abs().max())) for b in f4]
    print(f"{what}: max|delta| per variable {errs}, bounds {bounds}")
    if any(e > b for e, b in zip(errs, bounds)):
        fail(f"{what}: max|delta| {errs} beyond {bounds}")
    return max(errs)


def ptxas_rows(log: str) -> list:
    """(source, registers, spill-store bytes, spill-load bytes, kernel) of
    every kernel in the build's ``ptxas -v`` log (build.py heads each
    source's part with ``== nvcc <source>``), names demangled by the
    toolkit's cu++filt where it has one, template arguments kept."""
    import re
    rows, src, fn, spill = [], "?", None, (0, 0)
    for line in log.splitlines():
        if line.startswith("== nvcc "):
            src = line[len("== nvcc "):].strip()
        elif m := re.search(r"Compiling entry function '([^']+)'", line):
            fn, spill = m.group(1), (0, 0)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", line):
            spill = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", line)) and fn:
            rows.append([src, int(m.group(1)), *spill, fn])
            fn = None
    from cmcfs_tpu_torch.kernels import build
    filt = os.path.join(os.path.dirname(build.nvcc_path()), "cu++filt")
    if rows and os.path.isfile(filt):
        out = subprocess.run([filt], input="\n".join(r[4] for r in rows),
                             capture_output=True, text=True, timeout=60)
        names = out.stdout.splitlines()
        if out.returncode == 0 and len(names) == len(rows):
            for r, nm in zip(rows, names):
                nm = nm.replace("(anonymous namespace)::", "")
                r[4] = nm[:nm.rfind(">(") + 1] if ">(" in nm else nm
    return [tuple(r) for r in rows]


class StepRecorder:
    """While active (``with StepRecorder() as r``), each ADI step's new
    state (the whole grid's stacked fields, ``AdiSolver3D.state``, on the
    host) goes into ``r.states``, its first ``keep`` steps only, and each
    step's error into ``r.errs``.  It wraps ``AdiSolver3D.time_step`` and
    launches no kernel."""

    def __init__(self, keep=None):
        self.states, self.errs, self.keep = [], [], keep

    def __enter__(self):
        import torch
        from cmcfs_tpu_torch.models import solver3d
        self.cls = solver3d.AdiSolver3D
        orig = self.orig = self.cls.time_step

        def time_step(solver, *args, **kw):
            orig(solver, *args, **kw)
            if self.keep is None or len(self.states) < self.keep:
                self.states.append(
                    torch.stack(tuple(solver.state()[0])).cpu())
            self.errs.append(solver.last_err)

        self.cls.time_step = time_step
        return self

    def __exit__(self, *exc):
        self.cls.time_step = self.orig


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
    import numpy as np
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
    rows = ptxas_rows(klib.nvcc_log)
    if not rows:
        print("ptxas -v: the library was built before this run, no log")
    print(f"ptxas -v, {len(rows)} kernels: source, registers a thread, "
          f"spill stores / loads (bytes), kernel")
    for src, regs, st, ld, fn in rows:
        print(f"  {src:<22}{regs:>5}{st:>6}{ld:>6}  {fn}")
    spilled = [r for r in rows
               if (r[0].startswith("pcr_") or "bf16" in r[0]) and r[2] + r[3]]
    if spilled:
        fail(f"PCR or bf16 instantiations spill: {spilled}")

    from scripts.gen_box_case import gen
    from cmcfs_tpu_torch import cli3d
    from cmcfs_tpu_torch.models import adi3d
    from cmcfs_tpu_torch.models.common3d import (NodeType, grid_arrays,
                                                 init_state,
                                                 update_boundaries)
    from cmcfs_tpu_torch.ops import line_sweep as ls
    from cmcfs_tpu_torch.ops import pair_sweep as ps
    from cmcfs_tpu_torch.ops import pcr_sweep as pcs
    from cmcfs_tpu_torch.ops import stream_sweep as ss
    from cmcfs_tpu_torch.ops import tridiag_carry as tc
    from cmcfs_tpu_torch.ops import tridiag_rows as tr
    from cmcfs_tpu_torch.ops.stencil import div_error_3d

    # the pair kernel's dual form and every bf16 mode count their launches
    # apart (the 3D and 2D modes of the line and stream sweeps share theirs)
    def apart(counter):
        return types.SimpleNamespace(launches=counter)

    counters = Counters(pair_sweep=ps, line_sweep=ls, stream_sweep=ss,
                        tridiag_rows=tr,
                        pair_sweep_dual=apart(ps.dual_launches),
                        pcr_sweep=pcs,
                        pair_sweep_bf16=apart(ps.bf16_launches),
                        pair_sweep_dual_bf16=apart(ps.dual_bf16_launches),
                        pcr_sweep_bf16=apart(pcs.bf16_launches),
                        stream_sweep_bf16=apart(ss.bf16_launches),
                        line_sweep_bf16=apart(ls.bf16_launches),
                        line_fallback=apart(ls.fused_launches),
                        tridiag_carry=tc)
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
            if kernel in MOVED:
                print(f"{kernel}: moves about {MOVED[kernel]} B a cell a "
                      f"call by the source's count (compulsory {nbytes}): "
                      f"about {cells * MOVED[kernel] / r['ms'] / 1e6:.1f} "
                      f"GB/s at the measured {r['ms']:.3f} ms ({smi})")

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

    def run_slice(data, cfgp, base, steps, want_dirs, want_launches,
                  backend="auto"):
        counters.reset()
        solver, errs = cli3d.run_case(data, os.path.join(work, base), cfgp,
                                      max_steps=steps, collect_errs=True,
                                      device=dev, backend=backend)
        torch.cuda.synchronize()
        got = counters.read()
        nl = cli3d.Config.load(cfgp).num_local
        rep = solver.dispatch_report(nl)
        print(f"\ndispatch: backend={rep['backend']} pad={rep['pad']} "
              f"pcr={rep['pcr']} bf16={rep['bf16']} dirs={rep['dirs']} "
              f"(num_local={nl})")
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

    def step_vs_plain(solver, dt, nl, kernel_mod, attr, plain, twin=None):
        """One whole step on the solver's backend with the kernels against
        one with ``attr`` of adi3d swapped for its plain version, same
        tensors; a bf16 backend's bit for bit, and against the step of its
        float32 ``twin`` from the same state within BF16_TOL."""
        solver.update_boundaries()
        args = (solver.cur, solver.next, solver.ga, dt, NUM_GLOBAL, nl,
                solver.pa)
        kw = dict(exact=False, compute_error=False, merge_ok=solver.merge_ok,
                  backend=solver.backend)
        new_k, _ = adi3d.adi_timestep_3d(*args, **kw)
        setattr(adi3d, attr, plain)
        try:
            t0 = time.perf_counter()
            new_p, _ = adi3d.adi_timestep_3d(*args, **kw)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
        finally:
            setattr(adi3d, attr, getattr(kernel_mod, attr))
        new_k, new_p = torch.stack(new_k), torch.stack(new_p)
        err = check_close("whole step kernel vs plain", new_k, new_p)
        print(f"whole step kernel vs plain: max|delta| {err:.3e}; plain "
              f"step {plain_s * 1e3:.1f} ms")
        if solver.backend in adi3d.BF16_BACKENDS:
            if not torch.equal(new_k, new_p):
                fail(f"whole {solver.backend} step: kernels and plain "
                     "versions not bit for bit")
            ref = adi3d.adi_timestep_3d(*args, **dict(kw, backend=twin))[0]
            twin_err(f"{solver.backend} step vs {twin} step", new_k,
                     torch.stack(ref))
        return err

    per_step = NUM_GLOBAL * 3 * NUM_LOCAL
    # each step's state, which phase 23's split runs are held to
    with StepRecorder() as p5_steps:
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
    for backend, kernel in (("fused_dma", "line_fallback"),
                            ("fused", "line_fallback"),
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
    # the pair slice's state, step and reference, for phases 10 and 14
    rows_args, rows_kw, rows_ref4 = args, kw, ref4
    del new4, solver, ga

    # ------------------------------------------------------- 7. odd nl
    phase("7. odd num_local: cli3d.run_case, 256^3 box, ng=4 nl=3")
    data3, cfgp3 = gen(os.path.join(work, "b256nl3"), dx=BOX_DX,
                       time_steps=4, num_global=NUM_GLOBAL, num_local=3)
    with StepRecorder(keep=1) as p7_steps:
        solver, got = run_slice(
            data3, cfgp3, "box_nl3", SLICE_STEPS, "pair+stream",
            {"pair_sweep": SLICE_STEPS * NUM_GLOBAL * 3 * 2,
             "stream_sweep": SLICE_STEPS * NUM_GLOBAL * 3, "line_sweep": 0})
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
    with StepRecorder(keep=1) as p8_steps:
        solver, got = run_slice(data_l, cfgp_l, "box383", LONG_STEPS,
                                "fallback",
                                {"line_fallback": LONG_STEPS * per_step,
                                 "line_sweep": 0, "pair_sweep": 0,
                                 "stream_sweep": 0})
    grid_l, params_l = solver.grid, solver.params
    rec["line_fallback"]["launches"] = got["line_fallback"]
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
    err = step_vs_plain(solver, dt_l, NUM_LOCAL, ls, "fallback_iteration",
                        ls.fallback_iteration_ref)
    note("line_fallback", err, [], [], 0)

    # ----------------------------------------- 9. line sweep vs plain
    phase("9. line-sweep kernel vs plain PyTorch: 383^3 X / Y / Z (Z at each "
          "tile), 256^3 X / Y / Z")
    k_ms, p_ms, worst = [], [], 0.0
    z_tiles = {}

    def z_tile_ms(args, xp, tk):
        """{rows: ms} of each Z tile on args, each checked against xp; the
        source's own tile (Z_ROWS[0]) is the one just timed (tk)."""
        adv, pk, d4, scal, _, exact = args
        out = {ls.Z_ROWS[0]: tk}
        for r in ls.Z_ROWS[1:]:
            check_close(f"line 383 Z R={r} {exact}",
                        ls._launch(adv, pk, d4, scal, 2, 2, exact, r), xp)
            out[r] = cuda_ms(lambda: ls._launch(adv, pk, d4, scal, 2, 2,
                                                exact, r), 3)
        return out

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
            if axis == 2:
                z_tiles[exact] = z_tile_ms(args, xp, tk)
        del d4, xk, xp
    note("line_sweep", worst, k_ms, p_ms, math.prod(shape_l))
    print("383^3 Z by tile rows (R; the first is the source's), ms: "
          + "; ".join(f"exact={ex}: " + ", ".join(
              f"R={r} {t:.3f}" for r, t in zs.items())
              for ex, zs in z_tiles.items()) + f" ({smi})")

    # the fallback iteration in one launch, against its plain version and
    # the composition it replaces, out_prev half of rhs
    op4 = rhs4 * 0.5
    vals = (ga_l.val_u, ga_l.val_v, ga_l.val_w, ga_l.val_T)
    hs = (solver.pa.dx, solver.pa.dy, solver.pa.dz)
    k_ms, p_ms = [], []
    print(f"{'grid':<6}{'dir':<4}{'exact':<7}{'fused ms':>10}"
          f"{'plain ms':>10}{'composed ms':>13}")
    for axis in range(3):
        scal = adi3d._nl_scal(axis, solver.pa, dt_l)
        cls = ga_l.cls_a[axis]
        for exact in (True, False):
            fargs = (temp4, rhs4, op4, ga_l.types, ga_l.pk_a[axis], vals,
                     scal[:6], hs, axis, exact)

            def composed():
                d = adi3d.fold_d(*adi3d.fallback_rhs(
                    axis, rhs4, temp4, ga_l, solver.pa, scal[2]), cls)
                x = ls.line_sweep(temp4[axis], ga_l.pk_a[axis], d, scal[:4],
                                  axis, exact)
                out = torch.where(cls != 0, x, op4)
                return out, torch.where(ga_l.types == NodeType.IN,
                                        (temp4 + out) / 2.0, temp4)

            got = ls.fallback_iteration(*fargs)
            for what, want in (("plain", ls.fallback_iteration_ref(*fargs)),
                               ("composed", composed())):
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    e = max(float((a - b).abs().max())
                            for a, b in zip(got, want))
                    fail(f"fallback iteration 383 {axis} {exact} against "
                         f"the {what} version: max|delta| {e}")
            del got, want
            tk, tp = in_turns(lambda: ls.fallback_iteration(*fargs),
                              lambda: ls.fallback_iteration_ref(*fargs), 3, 1)
            t_comp = cuda_ms(composed, 1)
            k_ms.append(tk)
            p_ms.append(tp)
            print(f"{'383':<6}{'XYZ'[axis]:<4}{str(exact):<7}{tk:>10.3f}"
                  f"{tp:>10.2f}{t_comp:>13.2f}", flush=True)
    note("line_fallback", 0.0, k_ms, p_ms, math.prod(shape_l))
    print(f"(fused and plain bit for bit, out and tn; {smi})")
    del op4, vals
    del solver, ga_l, temp4, rhs4
    torch.cuda.empty_cache()
    ga = grid_arrays(grid, dev)
    temp4, rhs4, _ = noisy_state(ga, grid, gen_t)
    for axis in range(3):
        scal = adi3d._nl_scal(axis, pa, dt)
        d4 = adi3d.fold_d(*adi3d.fallback_rhs(axis, rhs4, temp4, ga, pa,
                                              scal[2]), ga.cls_a[axis])
        for exact in (True, False):
            args = (temp4[axis], ga.pk_a[axis], d4, scal[:4], axis, exact)
            xk = ls.line_sweep(*args)
            xp = ls.line_sweep_ref(*args)
            torch.cuda.synchronize()
            e = check_close(f"line 256 {axis} {exact}", xk, xp)
            rec["line_sweep"]["max_abs_err"] = max(
                rec["line_sweep"]["max_abs_err"], e)
            tk, tp = in_turns(lambda: ls.line_sweep(*args),
                              lambda: ls.line_sweep_ref(*args), 3, 1)
            print(f"{'256':<6}{'XYZ'[axis]:<4}{str(exact):<7}{e:>12.3e}"
                  f"{tk:>11.3f}{tp:>10.2f}", flush=True)
    print(f"(one launch per call; {smi})")

    del temp4, rhs4, d4, xk, xp, ga
    torch.cuda.empty_cache()

    # ------------------------------ 10. 2D modes and tridiag_rows vs plain
    phase("10. the 2D line and stream modes and tridiag_rows vs plain "
          "PyTorch")
    from cmcfs_tpu_torch import cli2d
    from cmcfs_tpu_torch.core.params import FluidParams
    from cmcfs_tpu_torch.core.scene2d import Scene2D
    from cmcfs_tpu_torch.geom.raster2d import Grid2D
    from cmcfs_tpu_torch.geom.synthetic import lid_cavity_2d
    from cmcfs_tpu_torch.models import adi2d
    from cmcfs_tpu_torch.models import common2d as c2
    from scripts.gen_box_case import gen_2d

    # bench.py:38: the 2D bench's physical parameters, start_T 1.0
    params2 = FluidParams.physical(0.05, 1000.0, 461.495, 0.6, 4200.0)
    data2, cfgp2 = gen_2d(os.path.join(work, "box2d"), dx=BOX2D_DX,
                          time_steps=8)
    cfg2 = cli3d.Config.load(cfgp2)

    def box2d_grid():
        scene = Scene2D.load(data2, "", dx=cfg2.dx, dy=cfg2.dy)
        g = Grid2D(scene, start_T=cfg2.baseT, bc_noslip=cfg2.bc_noslip,
                   bc_strength=cfg2.bc_strength)
        g.prepare_frame(0, 0.0)
        return g

    def noisy_2d(grid):
        """(ga, pa, cur, temp, out): interior noise, BOUND/VALVE cells at
        their grid values."""
        ga2 = c2.grid_arrays(grid, dev)
        base = torch.stack(tuple(c2.update_boundaries(
            c2.init_state(grid, dev), ga2)))
        is_in = ga2.types == NodeType.IN

        def noisy():
            return c2.State2D(*torch.where(is_in, base + 0.01 * torch.randn(
                base.shape, generator=gen_t, device=dev), base))

        return (ga2, adi2d.make_params(params2, grid.dx, grid.dy, 1.0),
                noisy(), noisy(), noisy())

    def compare(what, kernel, plain, k_reps=5, p_reps=1):
        """Check kernel() against plain() per variable (leading axis of
        each output), then time both in turns; (max err, ms, plain ms)."""
        outs_k, outs_p = kernel(), plain()
        torch.cuda.synchronize()
        if not isinstance(outs_k, tuple):
            outs_k, outs_p = (outs_k,), (outs_p,)
        err = max(check_close(what, a, b) for a, b in zip(outs_k, outs_p))
        tk, tp = in_turns(kernel, plain, k_reps, p_reps)
        return err, tk, tp

    hdr = (f"{'case':<22}{'dir':<4}{'exact':<7}{'max|d|':>11}"
           f"{'kernel ms':>11}{'plain ms':>10}")
    print(hdr)
    box_grid = box2d_grid()
    if (box_grid.dimx, box_grid.dimy) != BOX2D_SHAPE:
        fail(f"2D box is {(box_grid.dimx, box_grid.dimy)}, expected "
             f"{BOX2D_SHAPE}")
    for label, grid2 in (("line 1041 box", box_grid),
                         ("line 2048 lid", lid_cavity_2d(2048, 2048,
                                                         dx=0.001))):
        ga2, pa2, cur2, temp2, _ = noisy_2d(grid2)
        k_ms, p_ms, worst = [], [], 0.0
        for axis in (0, 1):
            largs = adi2d.line_args(axis, cur2, temp2, ga2, DT2, pa2)
            for exact in (True, False):
                e, tk, tp = compare(
                    f"{label} {axis} {exact}",
                    lambda: ls.line_sweep_2d(*largs, axis, exact),
                    lambda: ls.line_sweep_2d_ref(*largs, axis, exact))
                k_ms.append(tk)
                p_ms.append(tp)
                worst = max(worst, e)
                print(f"{label:<22}{'XY'[axis]:<4}{str(exact):<7}{e:>11.3e}"
                      f"{tk:>11.3f}{tp:>10.2f}", flush=True)
        if label.startswith("line 2048"):
            note("line_sweep_2d", worst, k_ms, p_ms, 2048 * 2048)
        else:
            rec["line_sweep_2d"]["max_abs_err"] = max(
                rec["line_sweep_2d"]["max_abs_err"], worst)
    ga2, pa2, cur2, temp2, out2 = noisy_2d(lid_cavity_2d(1024, 1024,
                                                         dx=0.001))
    if adi2d.stream_ok_2d(ga2) != (True, True):
        fail("the 1024^2 lid cavity is not stream-ok")
    k_ms, p_ms, worst = [], [], 0.0
    for axis in (0, 1):
        sargs = adi2d.stream_args(axis, cur2, temp2, out2, ga2, DT2, pa2)
        for first in (True, False):
            for exact in (True, False):
                e, tk, tp = compare(
                    f"stream 1024 {axis} {first} {exact}",
                    lambda: ss.stream_sweep_2d(*sargs, axis, exact, first),
                    lambda: ss.stream_sweep_2d_ref(*sargs, axis, exact,
                                                   first))
                k_ms.append(tk)
                p_ms.append(tp)
                worst = max(worst, e)
                print(f"{'stream 1024 first=' + str(first):<22}"
                      f"{'XY'[axis]:<4}{str(exact):<7}{e:>11.3e}"
                      f"{tk:>11.3f}{tp:>10.2f}", flush=True)
    note("stream_sweep_2d", worst, k_ms, p_ms, 1024 * 1024)
    ga2, pa2, cur2, temp2, _ = noisy_2d(box_grid)
    k_ms, p_ms, worst = [], [], 0.0
    for axis in (0, 1):
        rows = adi2d.row_args(axis, cur2, temp2, ga2, DT2, pa2)
        for form, recip in (("pallas", True), ("scan", False)):
            for exact in (True, False):
                e, tk, tp = compare(
                    f"rows 2D {axis} {form} {exact}",
                    lambda: tr.tridiag_rows(*rows, axis=axis + 1,
                                            exact=exact, recip_row0=recip),
                    lambda: tr.tridiag_rows_ref(*rows, axis=axis + 1,
                                                exact=exact,
                                                recip_row0=recip))
                k_ms.append(tk)
                p_ms.append(tp)
                worst = max(worst, e)
                print(f"{'rows 1041 box ' + form:<22}{'XY'[axis]:<4}"
                      f"{str(exact):<7}{e:>11.3e}{tk:>11.3f}{tp:>10.2f}",
                      flush=True)
    note("tridiag_rows_2d", worst, k_ms, p_ms, 3 * math.prod(BOX2D_SHAPE))
    del ga2, cur2, temp2, out2, rows, largs, sargs
    cur3, nxt3, ga3 = rows_args[:3]
    temp4, rhs4 = torch.stack(tuple(cur3)), torch.stack(tuple(nxt3))
    k_ms, p_ms, worst = [], [], 0.0
    for axis in range(3):
        scal = adi3d._nl_scal(axis, pa, dt)
        d, d_bc = adi3d.fallback_rhs(axis, rhs4, temp4, ga3, pa, scal[2])
        d4 = adi3d.fold_d(d, d_bc, ga3.cls_a[axis])
        # (u, v, w) on the velocities' rows, one launch (k = 3; the record's
        # times), and T on its own (k = 1)
        for label, vi, dk in (("rows 256^3 u,v,w", 0, d4[:3]),
                              ("rows 256^3 T", 3, d4[3])):
            abc = adi3d.row_coeffs(axis, temp4[axis], ga3.cls_a[axis], ga3,
                                   pa, scal, vi)
            for exact in (True, False):
                e, tk, tp = compare(
                    f"{label} {axis} {exact}",
                    lambda: tr.tridiag_rows(*abc, dk, axis=axis, exact=exact,
                                            recip_row0=True).reshape(
                                                (-1,) + shape),
                    lambda: tr.tridiag_rows_ref(*abc, dk, axis=axis,
                                                exact=exact,
                                                recip_row0=True).reshape(
                                                    (-1,) + shape), 3, 1)
                if vi == 0:
                    k_ms.append(tk)
                    p_ms.append(tp)
                worst = max(worst, e)
                print(f"{label:<22}{'XYZ'[axis]:<4}{str(exact):<7}"
                      f"{e:>11.3e}{tk:>11.3f}{tp:>10.2f}", flush=True)
            del abc
        del d, d_bc, d4
    note("tridiag_rows", worst, k_ms, p_ms, math.prod(shape))
    print(f"(one launch per call; {smi})")
    del temp4, rhs4
    torch.cuda.empty_cache()

    # ------------------------------------------- 11./12. 2D bench configs
    def run_2d_config(n, want_path, steps, backend="fused_nl"):
        """bench.py run_bench_2d's step loop at n^2 on ``backend``; the
        bf16 backend's launches count in the bf16 counters and its step is
        held to the plain versions' bit for bit."""
        g = lid_cavity_2d(n, n, dx=0.001)
        ga2 = c2.grid_arrays(g, dev)
        so = adi2d.stream_ok_2d(ga2)
        pa2 = adi2d.make_params(params2, g.dx, g.dy, 1.0)
        rep = adi2d.dispatch_report_2d((n, n), backend, so)
        print(f"dispatch: backend={backend} stream_ok={so} dirs={rep}")
        if set(rep.values()) != {want_path}:
            fail(f"2D dispatch is not all {want_path}: {rep}")
        bf16 = backend == "fused_bf16"
        kernel = {"stream": "stream_sweep", "line": "line_sweep"}[want_path]
        kernel += "_bf16" if bf16 else ""
        kw2 = dict(backend=backend, exact=False, stream_ok=so)
        cur = c2.init_state(g, dev)
        cur, err, _ = adi2d.adi_timestep_2d(cur, ga2, DT2, 2, 1, pa2, **kw2)
        torch.cuda.synchronize()
        counters.reset()
        iters = []
        t0 = time.perf_counter()
        for _ in range(steps):
            cur, err, it = adi2d.adi_timestep_2d(cur, ga2, DT2, 2, 1, pa2,
                                                 **kw2)
            iters.append(it)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counters.read()
        want = {k: 0 for k in got}
        want[kernel] = 2 * sum(iters)
        err = float(err)
        print(f"global iterations per step {iters}; launches {got} "
              f"(expected {want})")
        print(f"{wall / steps * 1e3:.3f} ms/step, "
              f"{n * n * steps / wall:.4e} cell-updates/s over {steps} "
              f"steps; divergence error {err:.6e} ({smi})", flush=True)
        if got != want:
            fail(f"2D launch counts {got} != {want}")
        if not (math.isfinite(err) and err <= 10 * adi2d.ERR_THRESHOLD) or \
                not all(bool(torch.isfinite(f).all()) for f in cur):
            fail(f"2D state not finite or divergence error {err} too big")
        attr = {"stream": "stream_sweep_2d", "line": "line_sweep_2d"}[
            want_path]
        mod = ss if want_path == "stream" else ls
        new_k, _, it_k = adi2d.adi_timestep_2d(cur, ga2, DT2, 2, 1, pa2,
                                               **kw2)
        setattr(adi2d, attr, getattr(mod, attr + "_ref"))
        try:
            t0 = time.perf_counter()
            new_p, _, it_p = adi2d.adi_timestep_2d(cur, ga2, DT2, 2, 1, pa2,
                                                   **kw2)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
        finally:
            setattr(adi2d, attr, getattr(mod, attr))
        if it_k != it_p:
            fail(f"whole 2D step: {it_k} global iterations with the kernel, "
                 f"{it_p} with the plain version")
        new_k, new_p = torch.stack(new_k), torch.stack(new_p)
        e = check_close("whole 2D step kernel vs plain", new_k, new_p)
        if bf16 and not torch.equal(new_k, new_p):
            fail(f"whole 2D {backend} step: kernel and plain not bit for bit")
        print(f"whole step kernel vs plain: max|delta| {e:.3e}; plain step "
              f"{plain_s * 1e3:.1f} ms")
        if bf16:
            ref, _, _ = adi2d.adi_timestep_2d(cur, ga2, DT2, 2, 1, pa2,
                                              **dict(kw2, backend="fused_dma"))
            twin_err(f"2d{n} fused_bf16 vs fused_dma", new_k,
                     torch.stack(ref))
        return got[kernel], wall / steps * 1e3, e

    phase(f"11. 2d1024: lid cavity 1024^2, fused_nl, ng=2 nl=1, "
          f"{TIMED_STEPS_2D} timed steps")
    n_launch, ms_1024, e = run_2d_config(1024, "stream", TIMED_STEPS_2D)
    rec["stream_sweep_2d"]["launches"] = n_launch
    note("stream_sweep_2d", e, [], [], 0)
    timing["2d1024 stream"] = {False: ms_1024}

    phase(f"12. 2d2048: lid cavity 2048^2, fused_nl, ng=2 nl=1, "
          f"{TIMED_STEPS_2D} timed steps")
    n_launch, ms_2048, e = run_2d_config(2048, "line", TIMED_STEPS_2D)
    rec["line_sweep_2d"]["launches"] = n_launch
    note("line_sweep_2d", e, [], [], 0)
    timing["2d2048 line"] = {False: ms_2048}

    # ------------------------------------------------------ 13. 2D CLI
    phase(f"13. 2D CLI: cli2d.run_case, 2D box case {BOX2D_SHAPE}, "
          f"{CLI2D_STEPS} steps")
    counters.reset()
    solver2, errs2, prof2 = cli2d.run_case(
        data2, "", os.path.join(work, "box2d.cdl"), cfgp2,
        max_steps=CLI2D_STEPS, collect_errs=True, device=dev)
    torch.cuda.synchronize()
    got = counters.read()
    rep = solver2.dispatch_report()
    print(f"dispatch: backend={solver2.backend} dirs={rep}; launches {got}")
    if solver2.backend != "fused_dma" or set(rep.values()) != {"line"}:
        fail(f"2D CLI dispatch {solver2.backend} {rep}, expected the line "
             "sweep on fused_dma")
    if got["line_sweep"] < 2 * cfg2.num_global * CLI2D_STEPS or any(
            v for k, v in got.items() if k != "line_sweep"):
        fail(f"2D CLI launch counts {got}")
    if len(errs2) != CLI2D_STEPS or not all(math.isfinite(x)
                                            for x in errs2):
        fail(f"2D CLI divergence errors {errs2}")
    sec = {k: e.total / e.count * 1e3 for k, e in prof2.events.items()}
    print(f"divergence error per step {errs2}; ms per call: "
          f"{json.dumps(sec)} ({smi})")
    print(f"CDL output {os.path.getsize(os.path.join(work, 'box2d.cdl'))} "
          "bytes")
    scene2 = solver2.grid.scene
    dt2 = scene2.cycle_length() / (scene2.num_frames() * cfg2.time_steps)
    solver2.update_boundaries()
    args2 = (solver2.cur, solver2.ga, dt2, cfg2.num_global, cfg2.num_local,
             solver2.pa)
    kw2 = dict(exact=solver2.exact, stream_ok=solver2.stream_ok)
    ref3, _, it_ref = adi2d.adi_timestep_2d(*args2, backend="fused_dma",
                                            **kw2)
    ref3 = torch.stack(ref3)
    # the same state on the CPU: the rows divide adv by 2h (stencil.over),
    # as cmcfs_tpu's rows do, where the line sweep multiplies by the float32
    # 1/(2h), as cmcfs_tpu's kernels do; at this box's physical parameters
    # v_T turns that ulp into about 0.01 on v (ROADMAP C1), on the CPU as
    # on the card, so the row steps are held bit for bit to the CPU's
    t0 = time.perf_counter()
    args2_cpu = (c2.State2D(*(f.cpu() for f in solver2.cur)),
                 c2.GridArrays2D(*(a.cpu() for a in solver2.ga))) + args2[2:]
    ref3_cpu = torch.stack(adi2d.adi_timestep_2d(
        *args2_cpu, backend="fused_dma", **kw2)[0])
    print(f"CPU fused_dma step {time.perf_counter() - t0:.1f} s; the card's "
          f"fused_dma step against it: max|delta| "
          f"{max(max_rel_err(ref3.cpu(), ref3_cpu)[0]):.3e}")
    rows_launches = 0
    for backend in ("pallas", "scan", "pcr"):
        counters.reset()
        it_want = it_ref
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new3, _, it = adi2d.adi_timestep_2d(*args2, backend=backend, **kw2)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        got = counters.read()
        want = {k: 0 for k in got}
        # pcr: cyclic reduction in PyTorch ops, as cmcfs_tpu's XLA ops
        want["tridiag_rows"] = (0 if backend == "pcr"
                                else 2 * cfg2.num_local * it)
        if backend == "pcr":
            # PCR is not Thomas: this box's rows are far from diagonally
            # dominant (dt 0.125, h 1 mm, physical parameters: adv/(2h) up
            # to about 820 against b = 108) and v_T = 461 turns one ulp of
            # T into 115 of v a sweep, so the two part well beyond TOL, as
            # cmcfs_tpu's own pcr does (on the CPU its step lies 0.25 from
            # the port's on v here; tests/test_torch_pcr.py holds the two
            # together on normalized parameters): the step is checked for
            # finite values and its distance printed
            new3 = torch.stack(new3)
            if not bool(torch.isfinite(new3).all()):
                fail("2D pcr step: non-finite values")
            e = max(max_rel_err(new3, ref3)[0])
        else:
            # the card's row step (the tridiag_rows kernel) against the
            # CPU's (its plain version), bit for bit; its distance to the
            # fused_dma step printed beside the CPU's own
            new3 = torch.stack(new3)
            cpu3, _, it_cpu = adi2d.adi_timestep_2d(*args2_cpu,
                                                    backend=backend, **kw2)
            cpu3 = torch.stack(cpu3)
            e_cpu = float((new3.cpu() - cpu3).abs().max())
            if not torch.equal(new3.cpu(), cpu3) or it != it_cpu:
                fail(f"2D {backend} step on the card: max|delta| {e_cpu} "
                     f"from the CPU's, {it} global iterations against "
                     f"{it_cpu}")
            e = max(max_rel_err(new3, ref3)[0])
            print(f"{backend}: the card's step equals the CPU's bit for "
                  f"bit; the CPU's {backend} step against its fused_dma "
                  f"step: max|delta| "
                  f"{max(max_rel_err(cpu3, ref3_cpu)[0]):.3e}")
            it_want = it_cpu
        print(f"{backend}: {it} global iterations, launches {got}, "
              f"max|delta| vs fused_dma step {e:.3e}, {step_ms:.2f} ms for "
              f"the step ({smi})")
        if got != want or (it != it_want and backend != "pcr"):
            fail(f"2D {backend}: launches {got} (expected {want}), "
                 f"{it} global iterations (expected {it_want})")
        rows_launches += got["tridiag_rows"]
        if backend != "pcr":
            note("tridiag_rows_2d", e_cpu, [], [], 0)
    rec["tridiag_rows_2d"]["launches"] = rows_launches
    del solver2, args2, ref3, new3, args2_cpu, ref3_cpu, cpu3

    # ------------------------------------------------- 14. 3D row path
    phase("14. the 3D row path: one step each of pallas, scan and pcr from "
          "the pair slice's state, against the pair step")
    # (u, v, w) and T: two launches a direction and local iteration
    rows_per_step = 2 * 3 * NUM_LOCAL * NUM_GLOBAL
    rows_launches = 0
    for backend in ("pallas", "scan", "pcr"):
        counters.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new4 = torch.stack(adi3d.adi_timestep_3d(*rows_args, backend=backend,
                                                 **rows_kw)[0])
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        got = counters.read()
        e = check_close(f"3D {backend} step vs pair step", new4, rows_ref4)
        print(f"{backend}: launches {got}, max|delta| vs pair step {e:.3e}, "
              f"{step_ms:.2f} ms for the step ({smi})", flush=True)
        want_rows = 0 if backend == "pcr" else rows_per_step
        if got["tridiag_rows"] != want_rows or \
                sum(got.values()) != want_rows:
            fail(f"3D {backend}: launches {got}, expected {want_rows} "
                 "of tridiag_rows")
        rows_launches += got["tridiag_rows"]
        if backend != "pcr":
            note("tridiag_rows", e, [], [], 0)
        del new4
    rec["tridiag_rows"]["launches"] = rows_launches
    del rows_args, rows_ref4
    torch.cuda.empty_cache()

    # ------------------------------------------------------- 15. probes
    phase("15. the probes at their scripts' defaults, every variant's "
          f"kernel against its plain version ({PROBE_REPS} timed calls)")
    from cmcfs_tpu_torch.probes import PROBES
    from cmcfs_tpu_torch.probes import common as probe_common
    probe_counters = Counters(**PROBES)
    probe_counters.reset()
    probe_rows = {}
    for pname, mod in PROBES.items():
        t0 = time.perf_counter()
        rows = mod.run(mod.parse_args(["--reps", str(PROBE_REPS)]))
        probe_common.print_table(pname, rows, dev)
        print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)
        bad = [(r.variant, r.err, r.tol) for r in rows if not r.ok]
        if bad:
            fail(f"{pname}: kernel vs plain beyond its bound: {bad}")
        probe_rows[pname] = rows
    got = probe_counters.read()
    print(f"probe launches: {got}")
    for pname, (src, rep, head) in PROBE_KERNELS.items():
        if got[pname] < 1:
            fail(f"{pname}: no kernel launch counted")
        rows = probe_rows[pname]
        row = next(r for r in rows if r.variant == head)
        worst = max(rows, key=lambda r: r.err)
        rec[pname] = {
            "name": pname, "route": "cuda", "source": src, "replaces": rep,
            "launches": got[pname], "max_abs_err": row.err,
            "ms": row.ms, "plain_ms": row.plain_ms, "bound_ms": row.bound_ms,
            "bound_by": row.bound_by, "library_ms": row.library_ms,
            "variant": head, "worst_variant": [worst.variant, worst.err]}

    # ---------------------------------------------------------- 16. duals
    phase(f"16. duals: the FREE baffle at 256^3, make_solver_3d('ADI', "
          f"'auto'), ng={NUM_GLOBAL} nl={NUM_LOCAL}, {SLICE_STEPS} steps")
    from cmcfs_tpu_torch.geom.baffle import free_baffled
    from cmcfs_tpu_torch.models.common3d import dual_flags
    from cmcfs_tpu_torch.models.solver3d import make_solver_3d
    from cmcfs_tpu_torch.ops import masks as pmasks
    t0 = time.perf_counter()
    bgrid = free_baffled(*shape)
    bsolver = make_solver_3d("ADI", backend="auto", device=dev)
    bsolver.init(bgrid, FluidParams.normalized(200.0, 0.72, 1.4))
    print(f"baffle grid {shape}, its line classes and dual plane built in "
          f"{time.perf_counter() - t0:.2f} s")
    rep = bsolver.dispatch_report(NUM_LOCAL)
    duals = [f is not None for f in bsolver.ga.dual_flags]
    print(f"dispatch: {rep}; dual plane per axis {duals}; merge_ok "
          f"{bsolver.merge_ok}")
    if rep["dirs"] != {"X": "pair", "Y": "pair", "Z": "pair"} or \
            duals != [True, False, False]:
        fail(f"baffle dispatch {rep['dirs']} with duals {duals}, expected "
             "all pair and duals on X")
    counters.reset()
    berrs = []
    with StepRecorder() as p16_steps:
        for _ in range(SLICE_STEPS):
            bsolver.update_boundaries()
            bsolver.time_step(BAFFLE_DT, NUM_GLOBAL, NUM_LOCAL)
            berrs.append(bsolver.last_err)
    torch.cuda.synchronize()
    got = counters.read()
    want = {k: 0 for k in got}
    # X: one dual pair (2 launches) a global iteration; Y and Z dual-free
    want["pair_sweep_dual"] = SLICE_STEPS * NUM_GLOBAL * NUM_LOCAL
    want["pair_sweep"] = SLICE_STEPS * NUM_GLOBAL * 2 * NUM_LOCAL
    print(f"kernel launches over {SLICE_STEPS} steps: {got} (expected "
          f"{want}); divergence error per step {berrs} (threshold "
          f"{adi3d.ERR_THRESHOLD})")
    if got != want:
        fail(f"baffle launch counts {got} != {want}")
    if any(not bool(torch.isfinite(f).all()) for f in bsolver.cur):
        fail("non-finite fields after the baffle slice")
    rec["pair_sweep_dual"]["launches"] = got["pair_sweep_dual"]
    timing["256 baffle"] = time_steps(bsolver, BAFFLE_DT, NUM_LOCAL,
                                      TIMED_STEPS, math.prod(shape))

    def baffle_on(axis, temp4, rhs4, op4):
        """The baffle's operands turned so that its wall is normal to
        ``axis`` (X: as built): (temp4, cls, bcv, bct, rhs4, op4, flags)."""
        perm = ((0, 1, 2), (1, 0, 2), (2, 1, 0))[axis]
        p4 = (0,) + tuple(q + 1 for q in perm)
        turn = (lambda a: np.ascontiguousarray(np.transpose(a, perm)))
        types, bcv, bct = (turn(np.asarray(a)) for a in (
            bgrid.types, bgrid.bc_vel, bgrid.bc_temp))
        lc = pmasks.line_class_3d(types, axis)

        def t(a, dtype=torch.int8):
            return torch.tensor(a, dtype=dtype, device=dev)

        cls = t(lc.cls_a)
        flags = dual_flags(cls, t(lc.cls_b), t(lc.take_b, torch.bool))
        return ((temp4.permute(p4).contiguous(), cls, t(bcv), t(bct),
                 rhs4.permute(p4).contiguous(), op4.permute(p4).contiguous(),
                 flags))

    btemp4, brhs4, bop4 = noisy_state(bsolver.ga, bgrid, gen_t)
    k_ms, p_ms, worst = [], [], 0.0
    print(f"{'dir':<4}{'exact':<7}{'max|d out|':>12}{'max|d tn|':>12}"
          f"{'dual ms':>9}{'dual-free ms':>14}{'plain ms':>10}")
    for axis in range(3):
        temp4a, cls, bcv, bct, rhs4a, op4a, flags = baffle_on(
            axis, btemp4, brhs4, bop4)
        scal = adi3d._nl_scal(axis, bsolver.pa, BAFFLE_DT)
        for exact in (True, False):
            args = (temp4a, cls, bcv, bct, rhs4a, op4a, scal, axis, exact,
                    True)
            ok4, tk4 = ps.pair_sweep(*args, flags)
            op4r, tp4r = ps.pair_sweep_ref(*args, flags)
            torch.cuda.synchronize()
            eo = check_close(f"dual pair {axis} {exact} out", ok4, op4r)
            et = check_close(f"dual pair {axis} {exact} tn", tk4, tp4r)
            worst = max(worst, eo, et)
            tk, tp = in_turns(lambda: ps.pair_sweep(*args, flags),
                              lambda: ps.pair_sweep_ref(*args, flags), 5, 1)
            t_free = cuda_ms(lambda: ps.pair_sweep(*args), 5)
            k_ms.append(tk)
            p_ms.append(tp)
            print(f"{'XYZ'[axis]:<4}{str(exact):<7}{eo:>12.3e}{et:>12.3e}"
                  f"{tk:>9.3f}{t_free:>14.3f}{tp:>10.2f}", flush=True)
        if axis == 0:
            x_args = (temp4a, cls, bcv, bct, rhs4a, op4a, flags)
        del temp4a, rhs4a, op4a, ok4, tk4, op4r, tp4r
    print(f"(times per pair = 2 kernel launches, the dual-free pair on the "
          f"same inputs beside it; {smi})")
    note("pair_sweep_dual", worst, k_ms, p_ms, math.prod(shape))
    bsolver.update_boundaries()
    b_args = (bsolver.cur, bsolver.next, bsolver.ga, BAFFLE_DT, NUM_GLOBAL,
              NUM_LOCAL, bsolver.pa)
    b_kw = dict(exact=False, compute_error=False, merge_ok=bsolver.merge_ok)
    b_ref4 = torch.stack(adi3d.adi_timestep_3d(*b_args, **b_kw)[0])
    new4 = torch.stack(adi3d.adi_timestep_3d(*b_args, backend="fused_dma",
                                             **b_kw)[0])
    e = check_close("baffle step vs the fused_dma step", b_ref4, new4)
    print(f"one step against the fused_dma step (the fallback's two-pass "
          f"stitch): max|delta| {e:.3e}")
    del new4, btemp4, brhs4, bop4

    # ------------------------------------------------------------ 17. PCR
    phase(f"17. PCR: cli3d.run_case, 256^3 box, backend fused_pcr, "
          f"ng={NUM_GLOBAL} nl={NUM_LOCAL}, {SLICE_STEPS} steps")
    want = {k: 0 for k in counters.read()}
    want["pcr_sweep"] = SLICE_STEPS * per_step
    psolver, got = run_slice(data, cfgp, "box_pcr", SLICE_STEPS, "pair",
                             want, backend="fused_pcr")
    if not psolver.dispatch_report(NUM_LOCAL)["pcr"]:
        fail("fused_pcr does not dispatch the PCR pair")
    rec["pcr_sweep"]["launches"] = got["pcr_sweep"]
    timing["256 fused_pcr"] = time_steps(psolver, dt, NUM_LOCAL, TIMED_STEPS,
                                         math.prod(shape))
    temp4, rhs4, op4 = noisy_state(psolver.ga, grid, gen_t)
    # (kernel ms, plain ms) of the float32 and the bf16 payloads
    pcr_ms = {"f32": ([], []), "bf16": ([], [])}
    worst = 0.0
    print(f"{'dir':<12}{'exact':<7}{'payload':<9}{'max|d out|':>12}"
          f"{'max|d tn|':>12}{'kernel ms':>11}{'plain ms':>10}")
    cases = [(axis, exact, None) for axis in range(3)
             for exact in (True, False)] + [(0, exact, "baffle")
                                            for exact in (True, False)]
    for axis, exact, which in cases:
        if which is None:
            ops = (temp4, psolver.ga.cls_a[axis], psolver.ga.bc_vel,
                   psolver.ga.bc_temp, rhs4, op4)
            tail = (adi3d._nl_scal(axis, pa, dt), axis, exact, axis == 0,
                    None)
        else:
            ops = x_args[:6]
            tail = (adi3d._nl_scal(0, bsolver.pa, BAFFLE_DT), 0, exact, True,
                    x_args[6])
        for pay in ("f32", "bf16"):
            args = ops[:4] + (ops[4:] if pay == "f32" else tuple(
                t.bfloat16() for t in ops[4:])) + tail
            ok4, tk4 = pcs.pcr_sweep(*args)
            op4r, tp4r = pcs.pcr_sweep_ref(*args)
            torch.cuda.synchronize()
            label = "XYZ"[axis] + (" baffle" if which else "")
            what = f"pcr {label} {exact} {pay}"
            if pay == "f32":
                eo = check_close(what + " out", ok4, op4r)
                et = check_close(what + " tn", tk4, tp4r)
                worst = max(worst, eo, et)
            elif not all(a.dtype == torch.bfloat16 and torch.equal(a, b)
                         and bool(torch.isfinite(a.float()).all())
                         for a, b in ((ok4, op4r), (tk4, tp4r))):
                fail(f"{what}: the bf16 kernel and its plain version are "
                     "not bit for bit")
            else:
                eo = et = 0.0
            tk, tp = in_turns(lambda: pcs.pcr_sweep(*args),
                              lambda: pcs.pcr_sweep_ref(*args), 5, 1)
            if which is None:
                pcr_ms[pay][0].append(tk)
                pcr_ms[pay][1].append(tp)
            print(f"{label:<12}{str(exact):<7}{pay:<9}{eo:>12.3e}{et:>12.3e}"
                  f"{tk:>11.3f}{tp:>10.2f}", flush=True)
    print(f"(times per pair = 2 kernel launches; {smi})")
    note("pcr_sweep", worst, *pcr_ms["f32"], math.prod(shape))
    print("PCR instantiations at n = 256: registers a thread, local memory "
          "a thread (bytes; 0: no spills), blocks an SM, shared bytes")
    for pay in pcs.PAYLOADS:
        for axis, tile in ((0, "X/Y"), (2, "Z")):
            for exact in (True, False):
                for dual in (False, True):
                    info = pcs.kernel_info(256, axis, exact, dual, pay)
                    print(f"  {pay:<9}{tile:<4}exact={exact!s:<6}"
                          f"dual={dual!s:<6}{json.dumps(info)}")
                    if info["local_bytes"] or info["blocks_per_sm"] < 2:
                        fail(f"PCR {pay} {tile} exact={exact} dual={dual}: "
                             f"{info}")
    del temp4, rhs4, op4, ok4, tk4, op4r, tp4r, x_args, args
    psolver.update_boundaries()
    p_args = (psolver.cur, psolver.next, psolver.ga, dt, NUM_GLOBAL)
    p_kw = dict(exact=False, compute_error=False, merge_ok=psolver.merge_ok)
    for nl, paths in ((NUM_LOCAL, "pair"), (3, "pair+stream")):
        counters.reset()
        new4 = torch.stack(adi3d.adi_timestep_3d(
            *p_args, nl, psolver.pa, backend="fused_pcr", **p_kw)[0])
        torch.cuda.synchronize()
        got = counters.read()
        want = {k: 0 for k in got}
        want["pcr_sweep"] = NUM_GLOBAL * 3 * (nl // 2) * 2
        want["stream_sweep"] = NUM_GLOBAL * 3 * (nl % 2)
        ref4 = torch.stack(adi3d.adi_timestep_3d(
            *p_args, nl, psolver.pa, backend="fused_nl", **p_kw)[0])
        errs, bounds = max_rel_err(new4, ref4)
        print(f"fused_pcr nl={nl} ({paths}) step: launches {got} (expected "
              f"{want}); against the fused_nl (Thomas) step from the same "
              f"state, max|delta| per variable {errs}, bound "
              f"{TOL} * max(1, max|field|) = {bounds}")
        if got != want:
            fail(f"fused_pcr nl={nl}: launches {got} != {want}")
        check_close(f"fused_pcr nl={nl} step vs fused_nl step", new4, ref4)
        del new4, ref4
    counters.reset()
    new4 = torch.stack(adi3d.adi_timestep_3d(*b_args, backend="fused_pcr",
                                             **b_kw)[0])
    torch.cuda.synchronize()
    got = counters.read()
    want = {k: 0 for k in got}
    want["pcr_sweep"] = NUM_GLOBAL * 3 * NUM_LOCAL
    errs, bounds = max_rel_err(new4, b_ref4)
    print(f"fused_pcr on the baffle (PCR with the dual chains on X): "
          f"launches {got} (expected {want}); against its auto step, "
          f"max|delta| per variable {errs}, bounds {bounds}")
    if got != want:
        fail(f"fused_pcr on the baffle: launches {got} != {want}")
    check_close("fused_pcr baffle step vs auto step", new4, b_ref4)
    del new4, b_ref4, bsolver, psolver
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ 18. bf16
    phase("18. bf16 payloads: every bf16 kernel mode against its plain "
          "version bit for bit; the fused_bf16 and fused_pcr_bf16 slices; "
          "bf16 steps against their float32 twins")
    # (bf16 kernel ms, plain ms) by kernel; the bf16 PCR pair's from
    # phase 17
    bf16_ms = {k: ([], []) for k in ("pair_sweep_bf16", "pair_sweep_dual_bf16",
                                     "stream_sweep_bf16",
                                     "stream_sweep_2d_bf16", "line_sweep_bf16",
                                     "line_sweep_2d_bf16")}
    bf16_ms["pcr_sweep_bf16"] = pcr_ms["bf16"]

    def bitwise(kernel, label, run, plain, twin, keep=True, k_reps=5,
                p_reps=1):
        """run() against plain() bit for bit (bf16 tensors, or tuples of
        them); run(), its float32 twin twin() on the same inputs before
        their rounding to bf16, and plain() timed in turns (plain, kernel,
        twin, twin, kernel, plain); the times go to the kernel's record
        where ``keep``."""
        outs_k, outs_p = run(), plain()
        torch.cuda.synchronize()
        if not isinstance(outs_k, tuple):
            outs_k, outs_p = (outs_k,), (outs_p,)
        for a, b in zip(outs_k, outs_p):
            if (a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16
                    or not bool(torch.isfinite(a.float()).all())
                    or not torch.equal(a, b)):
                fail(f"{kernel} {label}: the bf16 kernel and its plain "
                     f"version are not bit for bit "
                     f"({int((a.float() != b.float()).sum())} cells differ)")
        tp = cuda_ms(plain, p_reps)
        tk = cuda_ms(run, k_reps)
        tw = cuda_ms(twin, k_reps)
        tw = (tw + cuda_ms(twin, k_reps)) / 2
        tk = (tk + cuda_ms(run, k_reps)) / 2
        tp = (tp + cuda_ms(plain, p_reps)) / 2
        if keep:
            bf16_ms[kernel][0].append(tk)
            bf16_ms[kernel][1].append(tp)
        print(f"{kernel:<22}{label:<26}{'0':>8}{tk:>11.3f}{tw:>10.3f}"
              f"{tp:>10.2f}", flush=True)

    print(f"{'kernel':<22}{'case':<26}{'max|d|':>8}{'bf16 ms':>11}"
          f"{'f32 ms':>10}{'plain ms':>10}")
    ga = grid_arrays(grid, dev)
    temp4, rhs4, op4 = noisy_state(ga, grid, gen_t)
    rb, ob = rhs4.bfloat16(), op4.bfloat16()
    for axis in range(3):
        scal = adi3d._nl_scal(axis, pa, dt)
        forcing = pa.t_phi * adi3d._DISS[axis](temp4[0], temp4[1], temp4[2],
                                               pa.dx, pa.dy, pa.dz)
        d4f = adi3d.fold_d(*adi3d.fallback_rhs(axis, rhs4, temp4, ga, pa,
                                               scal[2]), ga.cls_a[axis])
        d4 = d4f.bfloat16()
        for exact in (True, False):
            lab = f"256 {'XYZ'[axis]} exact={exact}"
            masks3 = (ga.cls_a[axis], ga.bc_vel, ga.bc_temp)
            args = (temp4, *masks3, rb, ob, scal, axis, exact, axis == 0)
            fargs = (temp4, *masks3, rhs4, op4) + args[6:]
            bitwise("pair_sweep_bf16", lab, lambda: ps.pair_sweep(*args),
                    lambda: ps.pair_sweep_ref(*args),
                    lambda: ps.pair_sweep(*fargs))
            sargs = (temp4, *masks3, rb, ob, forcing, scal[:5], axis, exact)
            sfargs = (temp4, *masks3, rhs4, op4) + sargs[6:]
            bitwise("stream_sweep_bf16", lab,
                    lambda: ss.stream_sweep(*sargs),
                    lambda: ss.stream_sweep_ref(*sargs),
                    lambda: ss.stream_sweep(*sfargs))
            largs = (temp4[axis], ga.pk_a[axis], d4, scal[:4], axis, exact)
            lfargs = largs[:2] + (d4f,) + largs[3:]
            bitwise("line_sweep_bf16", lab, lambda: ls.line_sweep(*largs),
                    lambda: ls.line_sweep_ref(*largs),
                    lambda: ls.line_sweep(*lfargs), keep=False, k_reps=3)
            for r in (ls.Z_ROWS[1:] if axis == 2 else ()):
                bitwise("line_sweep_bf16", lab + f" R={r}",
                        lambda: ls._launch(*largs[:4], 2, 2, exact, r),
                        lambda: ls.line_sweep_ref(*largs),
                        lambda: ls._launch(*lfargs[:4], 2, 2, exact, r),
                        keep=False, k_reps=3)
        del forcing, d4, d4f
    print(f"(pair times per pair = 2 launches; {smi})")
    del temp4, rhs4, op4, rb, ob, ga
    torch.cuda.empty_cache()
    # the FREE baffle turned onto each axis: the dual pair (PCR with its
    # duals: phase 17)
    bsolver = make_solver_3d("ADI", backend="fused_bf16", device=dev)
    bsolver.init(bgrid, FluidParams.normalized(200.0, 0.72, 1.4))
    btemp4, brhs4, bop4 = noisy_state(bsolver.ga, bgrid, gen_t)
    for axis in range(3):
        temp4a, cls, bcv, bct, rhs4a, op4a, flags = baffle_on(
            axis, btemp4, brhs4, bop4)
        scal = adi3d._nl_scal(axis, bsolver.pa, BAFFLE_DT)
        for exact in (True, False):
            lab = f"baffle {'XYZ'[axis]} exact={exact}"
            args = (temp4a, cls, bcv, bct, rhs4a.bfloat16(), op4a.bfloat16(),
                    scal, axis, exact, True, flags)
            fargs = (temp4a, cls, bcv, bct, rhs4a, op4a) + args[6:]
            bitwise("pair_sweep_dual_bf16", lab,
                    lambda: ps.pair_sweep(*args),
                    lambda: ps.pair_sweep_ref(*args),
                    lambda: ps.pair_sweep(*fargs))
        del temp4a, rhs4a, op4a, args, fargs
    del btemp4, brhs4, bop4
    # the 2D modes: the stream sweep at 1024^2, the line sweep at 2048^2
    # and on the 1041^2 box
    ga2, pa2, cur2, temp2, out2 = noisy_2d(lid_cavity_2d(1024, 1024,
                                                         dx=0.001))
    for axis in (0, 1):
        t3, cl3, bct3, r3, o3, f3, s3 = adi2d.stream_args(
            axis, cur2, temp2, out2, ga2, DT2, pa2)
        for first in (True, False):
            for exact in (True, False):
                a2 = (t3, cl3, bct3, r3.bfloat16(), o3.bfloat16(), f3, s3,
                      axis, exact, first)
                f2 = (t3, cl3, bct3, r3, o3) + a2[5:]
                bitwise("stream_sweep_2d_bf16",
                        f"1024 {'XY'[axis]} exact={exact} first={first}",
                        lambda: ss.stream_sweep_2d(*a2),
                        lambda: ss.stream_sweep_2d_ref(*a2),
                        lambda: ss.stream_sweep_2d(*f2))
    for label, grid2 in (("2048", lid_cavity_2d(2048, 2048, dx=0.001)),
                         ("1041 box", box_grid)):
        ga2, pa2, cur2, temp2, _ = noisy_2d(grid2)
        for axis in (0, 1):
            adv2, pk2, d3, s2 = adi2d.line_args(axis, cur2, temp2, ga2, DT2,
                                                pa2)
            for exact in (True, False):
                a2 = (adv2, pk2, d3.bfloat16(), s2, axis, exact)
                f2 = (adv2, pk2, d3) + a2[3:]
                bitwise("line_sweep_2d_bf16",
                        f"{label} {'XY'[axis]} exact={exact}",
                        lambda: ls.line_sweep_2d(*a2),
                        lambda: ls.line_sweep_2d_ref(*a2),
                        lambda: ls.line_sweep_2d(*f2),
                        keep=label == "2048")
    del ga2, cur2, temp2, out2, a2, f2, d3
    torch.cuda.empty_cache()

    # the fused_bf16 slice through the CLI, 256^3: every direction on the
    # bf16 pair, 24 launches a step
    def only(**counts):
        want = {k: 0 for k in counters.read()}
        want.update(counts)
        return want

    solver, got = run_slice(data, cfgp, "box_bf16", SLICE_STEPS, "pair",
                            only(pair_sweep_bf16=SLICE_STEPS * per_step),
                            backend="fused_bf16")
    if not solver.dispatch_report(NUM_LOCAL)["bf16"]:
        fail("fused_bf16 does not report bf16 payloads")
    rec["pair_sweep_bf16"]["launches"] = got["pair_sweep_bf16"]
    timing["256 fused_bf16"] = time_steps(solver, dt, NUM_LOCAL, TIMED_STEPS,
                                          math.prod(shape))
    step_vs_plain(solver, dt, NUM_LOCAL, ps, "pair_sweep", ps.pair_sweep_ref,
                  twin="fused_nl")
    # nl=3: the pairs, then the bf16 stream iteration
    solver.update_boundaries()
    counters.reset()
    nl3_args = (solver.cur, solver.next, solver.ga, dt, NUM_GLOBAL, 3,
                solver.pa)
    nl3_kw = dict(exact=False, compute_error=False, merge_ok=solver.merge_ok)
    rep = adi3d.dispatch_report(shape, (False,) * 3, "fused_bf16", 3,
                                solver.merge_ok)
    t0 = time.perf_counter()
    new4 = torch.stack(adi3d.adi_timestep_3d(*nl3_args, backend="fused_bf16",
                                             **nl3_kw)[0])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    got = counters.read()
    want = only(pair_sweep_bf16=NUM_GLOBAL * 3 * 2,
                stream_sweep_bf16=NUM_GLOBAL * 3)
    print(f"fused_bf16 nl=3: dispatch {rep['dirs']}, launches {got}, "
          f"{step_ms:.2f} ms for the step ({smi})")
    if got != want or set(rep["dirs"].values()) != {"pair+stream"}:
        fail(f"fused_bf16 nl=3: launches {got} (expected {want}), "
             f"dispatch {rep['dirs']}")
    rec["stream_sweep_bf16"]["launches"] = got["stream_sweep_bf16"]
    twin_err("fused_bf16 nl=3 step vs fused_nl", new4, torch.stack(
        adi3d.adi_timestep_3d(*nl3_args, backend="fused_nl", **nl3_kw)[0]))
    del solver, new4, nl3_args

    # the fused_pcr_bf16 slice: the bf16 PCR pair on every direction
    psolver, got = run_slice(data, cfgp, "box_pcr_bf16", SLICE_STEPS, "pair",
                             only(pcr_sweep_bf16=SLICE_STEPS * per_step),
                             backend="fused_pcr_bf16")
    rep = psolver.dispatch_report(NUM_LOCAL)
    if not (rep["pcr"] and rep["bf16"]):
        fail(f"fused_pcr_bf16 reports pcr={rep['pcr']} bf16={rep['bf16']}")
    rec["pcr_sweep_bf16"]["launches"] = got["pcr_sweep_bf16"]
    timing["256 fused_pcr_bf16"] = time_steps(psolver, dt, NUM_LOCAL,
                                              TIMED_STEPS, math.prod(shape))
    step_vs_plain(psolver, dt, NUM_LOCAL, pcs, "pcr_sweep",
                  pcs.pcr_sweep_ref, twin="fused_pcr")
    del psolver

    # the baffle on fused_bf16: X on the bf16 dual pair
    bsolver.update_boundaries()
    b_args = (bsolver.cur, bsolver.next, bsolver.ga, BAFFLE_DT, NUM_GLOBAL,
              NUM_LOCAL, bsolver.pa)
    b_kw = dict(exact=False, compute_error=False, merge_ok=bsolver.merge_ok)
    rep = bsolver.dispatch_report(NUM_LOCAL)
    counters.reset()
    new4 = torch.stack(adi3d.adi_timestep_3d(*b_args, backend="fused_bf16",
                                             **b_kw)[0])
    torch.cuda.synchronize()
    got = counters.read()
    want = only(pair_sweep_dual_bf16=NUM_GLOBAL * NUM_LOCAL,
                pair_sweep_bf16=NUM_GLOBAL * 2 * NUM_LOCAL)
    print(f"baffle fused_bf16: dispatch {rep['dirs']} bf16={rep['bf16']}, "
          f"launches {got} (expected {want})")
    if got != want:
        fail(f"baffle fused_bf16: launches {got} != {want}")
    rec["pair_sweep_dual_bf16"]["launches"] = got["pair_sweep_dual_bf16"]
    twin_err("baffle fused_bf16 step vs auto", new4, torch.stack(
        adi3d.adi_timestep_3d(*b_args, backend="auto", **b_kw)[0]))
    del bsolver, new4, b_args
    torch.cuda.empty_cache()

    # 383^3 on fused_bf16: the fallback, the bf16 line sweep
    lsolver, got = run_slice(data_l, cfgp_l, "box383_bf16", 1, "fallback",
                             only(line_sweep_bf16=per_step),
                             backend="fused_bf16")
    rec["line_sweep_bf16"]["launches"] = got["line_sweep_bf16"]
    timing["383 fused_bf16"] = time_steps(lsolver, dt_l, NUM_LOCAL,
                                          LONG_TIMED_STEPS,
                                          math.prod(BOX383_SHAPE))
    step_vs_plain(lsolver, dt_l, NUM_LOCAL, ls, "line_sweep",
                  ls.line_sweep_ref, twin="fused_nl")
    ga_l = lsolver.ga
    temp4 = torch.stack(tuple(lsolver.cur))
    rhs4 = torch.stack(tuple(lsolver.next))
    for axis in range(3):
        scal = adi3d._nl_scal(axis, lsolver.pa, dt_l)
        d4f = adi3d.fold_d(*adi3d.fallback_rhs(axis, rhs4, temp4, ga_l,
                                               lsolver.pa, scal[2]),
                           ga_l.cls_a[axis])
        for exact in (True, False):
            largs = (temp4[axis], ga_l.pk_a[axis], d4f.bfloat16(), scal[:4],
                     axis, exact)
            lfargs = largs[:2] + (d4f,) + largs[3:]
            bitwise("line_sweep_bf16", f"383 {'XYZ'[axis]} exact={exact}",
                    lambda: ls.line_sweep(*largs),
                    lambda: ls.line_sweep_ref(*largs),
                    lambda: ls.line_sweep(*lfargs), k_reps=3)
        del d4f
    del lsolver, ga_l, temp4, rhs4, largs, lfargs
    torch.cuda.empty_cache()

    # 2D: fused_bf16 runs the line sweep at 2048^2, at 1024^2 (where
    # fused_nl streams) and on the 2D CLI's box
    for n in (2048, 1024):
        n_launch, ms, _ = run_2d_config(n, "line", TIMED_STEPS_2D,
                                        backend="fused_bf16")
        timing[f"2d{n} fused_bf16"] = {False: ms}
        if n == 2048:
            rec["line_sweep_2d_bf16"]["launches"] = n_launch
    counters.reset()
    solver2, errs2, prof2 = cli2d.run_case(
        data2, "", os.path.join(work, "box2d_bf16.cdl"), cfgp2,
        max_steps=CLI2D_STEPS, collect_errs=True, device=dev,
        backend="fused_bf16")
    torch.cuda.synchronize()
    got = counters.read()
    rep = solver2.dispatch_report()
    sec = {k: e.total / e.count * 1e3 for k, e in prof2.events.items()}
    print(f"2D CLI fused_bf16: dirs={rep}; launches {got}; divergence "
          f"error per step {errs2}; ms per call {json.dumps(sec)} ({smi})")
    if (set(rep.values()) != {"line"}
            or got["line_sweep_bf16"] < 2 * cfg2.num_global * CLI2D_STEPS
            or any(v for k, v in got.items() if k != "line_sweep_bf16")
            or len(errs2) != CLI2D_STEPS
            or not all(math.isfinite(x) for x in errs2)):
        fail(f"2D CLI fused_bf16: dirs {rep}, launches {got}, errors {errs2}")
    del solver2

    # bf16 against float32 over 100 steps from the start, the box at about
    # 128^3 (twice the bench's dx): max|du| / max|u| along the way
    data_d, cfgp_d = gen(os.path.join(work, "b128"), dx=2 * BOX_DX,
                         time_steps=4, num_global=NUM_GLOBAL,
                         num_local=NUM_LOCAL)
    cfg_d, params_d, grid_d = cli3d.load_case(data_d, cfgp_d)
    dt_d = grid_d.cycle_len / (grid_d.num_frames * cfg_d.time_steps)
    twins = {}
    for b in ("fused_bf16", "fused_nl"):
        twins[b] = make_solver_3d("ADI", backend=b, device=dev)
        twins[b].init(grid_d, params_d)
    drift = {}
    for step in range(1, DRIFT_STEPS + 1):
        for sv in twins.values():
            sv.update_boundaries()
            sv.time_step(dt_d, NUM_GLOBAL, NUM_LOCAL, compute_error=False)
        if step in DRIFT_AT:
            u_b, u_f = twins["fused_bf16"].cur.u, twins["fused_nl"].cur.u
            drift[step] = float((u_b - u_f).abs().max() / u_f.abs().max())
    print(f"drift of fused_bf16 from fused_nl on the "
          f"{tuple(twins['fused_nl'].cur.u.shape)} box, max|du|/max|u| by "
          f"step: {json.dumps(drift)}")
    if not all(math.isfinite(v) for v in drift.values()):
        fail(f"bf16 drift not finite: {drift}")
    del twins

    for k, (k_ms, p_ms) in bf16_ms.items():
        cells = {"line_sweep_bf16": math.prod(BOX383_SHAPE),
                 "stream_sweep_2d_bf16": 1024 * 1024,
                 "line_sweep_2d_bf16": 2048 * 2048}.get(k, math.prod(shape))
        note(k, 0.0, k_ms, p_ms, cells)
    # adi2d sends fused_bf16 to the line sweep, as cmcfs_tpu does: no
    # dispatch reaches the 2D bf16 stream mode (held to its plain version
    # above)
    rec["stream_sweep_2d_bf16"]["path"] = (
        "none: the 2D fused_bf16 runs the line sweep (adi2d.py:92-134)")

    # --------------------------------------- 19. Explicit and Stable, 3D
    t_phase = time.perf_counter()
    phase(f"19. Explicit and Stable in 3D: make_solver_3d on the lid cavity "
          f"at {SCHEME_N}^3, ng={SCHEME_NG}, and against the CPU at "
          f"{SCHEME_CHECK_N}^3")
    from cmcfs_tpu_torch.geom.synthetic import lid_cavity_3d
    from cmcfs_tpu_torch.models.solver2d import make_solver
    params_s = FluidParams.normalized(200.0, 0.72, 1.4)
    print(f"dt {SCHEME_DT}: the explicit limit dx^2 / (6 nu) at "
          f"{SCHEME_N}^3 is {(1 / SCHEME_N) ** 2 / (6 * params_s.v_vis):.3e}")

    def run_scheme(solver, dt, steps, ng):
        """``steps`` steps of a solver: (ms a step, Poisson iterations of
        each global iteration a step); fails on a kernel launch (no
        kernel backs the schemes), a non-finite field or error."""
        on_card = solver.device.type == "cuda"
        ms, iters = [], []
        counters.reset()
        for _ in range(steps):
            if on_card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            solver.update_boundaries()
            solver.time_step(dt, ng, 1)
            if on_card:
                torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            iters.append(list(getattr(solver, "last_poisson_iters", ())))
        if any(counters.read().values()):
            fail(f"{solver.name}: a kernel was launched {counters.read()}")
        if not (math.isfinite(solver.last_err) and all(
                bool(torch.isfinite(f).all()) for f in solver.cur)):
            fail(f"{solver.name}: non-finite state or error "
                 f"{solver.last_err}")
        return ms, iters

    def scheme_3d(scheme, n, steps, device, shards=1):
        grid = lid_cavity_3d(n, n, n, dx=1.0 / n, lid_velocity=0.2)
        solver = make_solver_3d(scheme, device=device)
        solver.init(grid, params_s)
        if shards > 1:
            from cmcfs_tpu_torch.parallel.mesh import make_x_mesh
            solver.set_plan(make_x_mesh(devices=[device] * shards))
        ms, iters = run_scheme(solver, SCHEME_DT, steps, SCHEME_NG)
        print(f"{scheme} {n}^3 on {solver.device} over {shards} shard(s): "
              f"ms a step {ms}; "
              f"divergence error {solver.last_err:.6e}; Poisson iterations "
              f"a global iteration {iters} ({smi})", flush=True)
        return solver, ms, iters

    def card_vs_cpu(what, card, cpu, it_card, it_cpu):
        errs = [float((a.cpu() - b).abs().max()) for a, b in
                zip(card.cur, cpu.cur)]
        bounds = [SCHEME_REL * max(1.0, float(b.abs().max()))
                  for b in cpu.cur]
        print(f"{what}: card vs CPU max|delta| per variable {errs} (bounds "
              f"{bounds}); Poisson iterations card {it_card}, CPU {it_cpu}")
        if any(e > b for e, b in zip(errs, bounds)) or it_card != it_cpu:
            fail(f"{what}: the card and the CPU disagree")

    # the schemes' divisions (stencil.over) round as the CPU's quotient,
    # bit for bit; a division by the host scalar is printed beside it
    from cmcfs_tpu_torch.ops import stencil
    xg = torch.randn(1 << 22, generator=torch.Generator().manual_seed(0))
    xd = xg.to(dev)
    for s in (np.float32(0.02), np.float32(2.0) * np.float32(1 / 256),
              np.float32(SCHEME_DT), np.float32(3) * np.float32(0.02) ** 4):
        want = xg / s
        n_over = int((stencil.over(xd, s).cpu() != want).sum())
        n_host = int(((xd / s).cpu() != want).sum())
        print(f"divide by {s!r}: stencil.over differs from the CPU on "
              f"{n_over} of {xg.numel()}, a host-scalar division on "
              f"{n_host}")
        if n_over:
            fail(f"stencil.over by {s!r} parts from the CPU's quotient")
    del xg, xd
    # each scheme's last 256^3 state, error and Poisson counts, which
    # phase 25's split steps are held to
    p19 = {}
    for scheme, steps in (("Explicit", EXPLICIT_STEPS), ("Stable", 1)):
        sv, ms, iters = scheme_3d(scheme, SCHEME_N, steps, dev)
        timing[f"{SCHEME_N} {scheme} ng={SCHEME_NG}"] = {True: ms[-1]}
        p19[scheme] = (torch.stack(tuple(sv.cur)).cpu(), sv.last_err, iters)
        del sv
    torch.cuda.empty_cache()
    for scheme, steps in (("Explicit", EXPLICIT_STEPS), ("Stable", 1)):
        card, _, it_card = scheme_3d(scheme, SCHEME_CHECK_N, steps, dev)
        cpu, _, it_cpu = scheme_3d(scheme, SCHEME_CHECK_N, steps, "cpu")
        card_vs_cpu(f"{scheme} {SCHEME_CHECK_N}^3", card, cpu, it_card,
                    it_cpu)
    print(f"phase 19: {time.perf_counter() - t_phase:.1f} s")

    # --------------------------------------- 20. Explicit and Stable, 2D
    t_phase = time.perf_counter()
    phase(f"20. Explicit and Stable in 2D: make_solver on the 2d2048 lid "
          f"cavity, ng={SCHEME_NG}, dt {DT2}; sequential at {SEQ_N}^2; "
          f"against the CPU at {SCHEME_CHECK_N2D}^2")

    def scheme_2d(scheme, n, steps, device, backend="auto", params=params2,
                  dx=0.001, dt=DT2, lid=0.5):
        solver = make_solver(scheme, backend=backend, device=device)
        solver.init(lid_cavity_2d(n, n, dx=dx, lid_velocity=lid), params)
        ms, iters = run_scheme(solver, dt, steps, SCHEME_NG)
        print(f"{scheme} ({backend}) {n}^2 on {solver.device}: ms a step "
              f"{ms}; global iterations {solver.last_iters}; divergence error "
              f"{solver.last_err:.6e}; Poisson iterations a global "
              f"iteration {iters} ({smi})", flush=True)
        return solver, ms, iters

    for scheme, steps in (("Explicit", EXPLICIT_STEPS), ("Stable", 1)):
        _, ms, _ = scheme_2d(scheme, 2048, steps, dev)
        timing[f"2d2048 {scheme} ng={SCHEME_NG}"] = {True: ms[-1]}
    print(f"cut: Stable with the sequential order runs one step at "
          f"{SEQ_N}^2, not 2048^2 (a sweep is about {2 * SEQ_N} waves of a "
          f"few launches each)")
    # the CPU tests' parameters and cavity (tests/torch_schemes.py), dt
    # inside dx^2 / (4 nu) = 0.00375
    p2n = dict(params=FluidParams.normalized(150.0, 0.72, 1.4), dx=0.01,
               dt=0.002, lid=0.4)
    seq, ms, it_seq = scheme_2d("Stable", SEQ_N, 1, dev, "sequential", **p2n)
    timing[f"2d{SEQ_N} Stable sequential ng={SCHEME_NG}"] = {True: ms[-1]}
    cpu, _, it_cpu = scheme_2d("Stable", SEQ_N, 1, "cpu", "sequential", **p2n)
    card_vs_cpu(f"Stable sequential {SEQ_N}^2", seq, cpu, it_seq, it_cpu)
    for scheme, steps in (("Explicit", EXPLICIT_STEPS), ("Stable", 1)):
        card, _, it_card = scheme_2d(scheme, SCHEME_CHECK_N2D, steps, dev,
                                     **p2n)
        cpu, _, it_cpu = scheme_2d(scheme, SCHEME_CHECK_N2D, steps, "cpu",
                                   **p2n)
        card_vs_cpu(f"{scheme} {SCHEME_CHECK_N2D}^2", card, cpu, it_card,
                    it_cpu)
    del seq, card, cpu
    print(f"phase 20: {time.perf_counter() - t_phase:.1f} s")

    # ------------------------------------------------ 21. the CLI flags
    t_phase = time.perf_counter()
    phase(f"21. the CLI flags: cli3d.run_case on the 256^3 box (auto: the "
          f"pair), {2 * CLI_K} steps straight against {CLI_K} with "
          f"checkpoint and {CLI_K} resumed; profile, dump_grid, carried; "
          f"cli2d checkpoint / resume; the schemes through both CLIs")
    from cmcfs_tpu_torch.utils.profiler import Profiler
    every = os.path.join(work, "b256every")
    data_c, cfgp_c = gen(every, dx=BOX_DX, time_steps=2 * CLI_K + 2,
                         num_global=NUM_GLOBAL, num_local=NUM_LOCAL)

    def out_every_step(path, extra=()):
        with open(path) as f:
            text = f.read().replace("out_time_steps \t1000000",
                                    "out_time_steps \t1")
        for old, new in extra:
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)

    out_every_step(cfgp_c)

    def cli(base, **kw):
        return cli3d.run_case(data_c, os.path.join(work, base), cfgp_c,
                              quiet=True, device=dev, **kw)[0]

    def same_state(what, a, b):
        for sa, sb in ((a.cur, b.cur), (a.next, b.next)):
            if not all(torch.equal(x, y) for x, y in zip(sa, sb)):
                fail(f"{what}: the state differs")

    def same_bytes(what, p1, p2):
        with open(p1, "rb") as f1, open(p2, "rb") as f2:
            if f1.read() != f2.read():
                fail(f"{what}: {p1} and {p2} differ")

    counters.reset()
    straight = cli("straight", max_steps=2 * CLI_K)
    torch.cuda.synchronize()
    got = counters.read()
    if got["pair_sweep"] != 2 * CLI_K * per_step:
        fail(f"straight run: launches {got}")
    ck = os.path.join(work, "ck256")
    cli("part", max_steps=CLI_K, checkpoint=ck)
    print(f"checkpoint {os.path.getsize(ck + '.npz')} bytes")
    resumed = cli("part", max_steps=CLI_K, resume=ck + ".npz")
    same_state("resume", straight, resumed)
    same_bytes("resume", os.path.join(work, "straight_res.nc"),
               os.path.join(work, "part_res.nc"))
    print(f"resume: {CLI_K} + {CLI_K} steps equal {2 * CLI_K} straight bit "
          f"for bit (state and NetCDF file)")
    os.remove(ck + ".npz")
    carried_sv = cli("carried", max_steps=2 * CLI_K, carried=True)
    same_state("carried", straight, carried_sv)
    same_bytes("carried", os.path.join(work, "straight_res.nc"),
               os.path.join(work, "carried_res.nc"))
    print("carried: the per-step run's state and records, bit for bit")
    del resumed, carried_sv
    cli("grid", max_steps=1, dump_grid=True)
    bmps = sorted(os.listdir(os.path.join(work, "grid_grid_3d")))
    print(f"dump_grid: {len(bmps)} BMP files, "
          f"{os.path.getsize(os.path.join(work, 'grid_grid_3d', bmps[0]))} "
          f"bytes each")
    if len(bmps) != straight.grid.dimz:
        fail(f"dump_grid wrote {len(bmps)} files for dimz "
             f"{straight.grid.dimz}")
    # profile: through the CLI (its event table), then the same steps'
    # sections against unprofiled steps from the same state
    dt_c = straight.grid.cycle_len / (straight.grid.num_frames
                                      * (2 * CLI_K + 2))
    cli3d.run_case(data_c, os.path.join(work, "prof"), cfgp_c, max_steps=2,
                   profile=True, device=dev)
    prof = Profiler(device=dev)
    for _ in range(TIMED_STEPS):
        straight.update_boundaries()
        with prof.section("TimeStep"):
            straight.time_step(dt_c, NUM_GLOBAL, NUM_LOCAL)
        straight.update_boundaries()
        straight.time_step_profiled(dt_c, NUM_GLOBAL, NUM_LOCAL, prof)
    ev = {k: (e.count, e.total * 1e3) for k, e in prof.events.items()}
    solve = sum(ev[f"SolveSegments_{a}"][1] for a in "XYZ") / TIMED_STEPS
    step_ms = ev["TimeStep"][1] / TIMED_STEPS
    print(prof.report())
    print(f"profile: SolveSegments X + Y + Z {solve:.2f} ms a step, the "
          f"unprofiled TimeStep {step_ms:.2f} ms ({smi})")
    if not 0.7 * step_ms <= solve <= 1.3 * step_ms:
        fail(f"profile: the direction sections ({solve:.2f} ms) are not "
             f"close to the step ({step_ms:.2f} ms)")
    del straight
    # cli2d: checkpoint and resume on the 2D box case
    box2 = os.path.join(work, "box2d_every")
    data2c, cfgp2c = gen_2d(box2, dx=BOX2D_DX, time_steps=2 * CLI_K + 2)
    out_every_step(cfgp2c)

    def cli_2d(out, **kw):
        return cli2d.run_case(data2c, "", os.path.join(box2, out), cfgp2c,
                              quiet=True, device=dev, **kw)[0]

    full2 = cli_2d("full.cdl", max_steps=2 * CLI_K)
    ck2 = os.path.join(box2, "ck")
    cli_2d("p1.cdl", max_steps=CLI_K, checkpoint=ck2)
    part2 = cli_2d("p2.cdl", max_steps=CLI_K, resume=ck2 + ".npz")
    same_state("cli2d resume", full2, part2)

    def cdl_body(out):
        with open(os.path.join(box2, out)) as f:
            return f.read().partition("u = \n")[2]

    if cdl_body("p1.cdl") + cdl_body("p2.cdl") != cdl_body("full.cdl"):
        fail("cli2d resume: the CDL frames differ")
    print(f"cli2d resume: {CLI_K} + {CLI_K} steps equal {2 * CLI_K} straight "
          f"bit for bit (state and CDL frames); legacy layer "
          f"{os.path.getsize(ck2 + '.lastlayer.txt')} bytes")
    del full2, part2
    # the schemes through the CLIs: the config's solver line, a dt inside
    # their explicit limits (3D: the box at 65^3, dx 0.0164, dt 0.005;
    # 2D: the box at dx 0.004, dt 0.01)
    for scheme in ("Explicit", "Stable"):
        d3, c3 = gen(os.path.join(work, f"b65{scheme}"), dx=0.0164,
                     time_steps=200, num_global=SCHEME_NG,
                     num_local=NUM_LOCAL)
        out_every_step(c3, [("solver\t\tADI", f"solver\t\t{scheme}")])
        sv, errs3 = cli3d.run_case(d3, os.path.join(work, f"b65{scheme}"),
                                   c3, quiet=True, max_steps=3,
                                   collect_errs=True, device=dev)
        d2, c2p = gen_2d(os.path.join(work, f"b2d{scheme}"), dx=0.004,
                         time_steps=100)
        out_every_step(c2p, [("solver\t\tADI", f"solver\t\t{scheme}")])
        sv2, errs2 = cli2d.run_case(d2, "",
                                    os.path.join(work, f"{scheme}.cdl"), c2p,
                                    quiet=True, max_steps=3,
                                    collect_errs=True, device=dev)[:2]
        print(f"{scheme}: cli3d {sv.grid.dimx}^3 errors {errs3}, Poisson "
              f"{list(getattr(sv, 'last_poisson_iters', ()))}; cli2d "
              f"{tuple(sv2.ga.types.shape)} errors {errs2}, Poisson "
              f"{list(getattr(sv2, 'last_poisson_iters', ()))}")
        if sv.name != scheme or sv2.name != scheme or not all(
                math.isfinite(e) for e in errs3 + errs2):
            fail(f"{scheme} through the CLIs: {sv.name}, {sv2.name}, "
                 f"{errs3}, {errs2}")
    print(f"phase 21: {time.perf_counter() - t_phase:.1f} s")

    # ------------------------------------------------------- 22. verify
    t_phase = time.perf_counter()
    phase("22. verify: python -m cmcfs_tpu_torch.verify on the 256^3 box, "
          "2 steps, scan against auto")
    out = subprocess.run([sys.executable, "-m", "cmcfs_tpu_torch.verify",
                          data_c, cfgp_c, "scan", "auto", "steps", "2"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    print(out.stdout.strip())
    if out.returncode != 0:
        print(out.stderr[-4000:], file=sys.stderr)
        fail(f"verify returned {out.returncode}")
    print(f"phase 22: {time.perf_counter() - t_phase:.1f} s")

    # ------------------------------------------------- 23. the X split
    t_phase = time.perf_counter()
    phase(f"23. the X split on one card: cli3d.run_case on the 256^3 box "
          f"(auto) over 2 and 4 shards, balance EVEN_VOLUME, the baffle, "
          f"383^3 fallback and nl=3 over 2, cli3d.main shards 2")
    from cmcfs_tpu_torch.parallel.mesh import make_x_mesh
    n_cards = torch.cuda.device_count()
    print(f"torch.cuda.device_count() = {n_cards}")

    def same_steps(what, got, want):
        """Each recorded step of ``got`` bit for bit ``want``'s, each error
        within 1e-6 relative (the sums' order differs over shards)."""
        if not got.states or len(got.states) > len(want.states):
            fail(f"{what}: {len(got.states)} steps recorded")
        for k, (a, b) in enumerate(zip(got.states, want.states)):
            if not torch.equal(a, b):
                fail(f"{what}: step {k + 1} differs from the unsharded "
                     f"step, max|delta| {float((a - b).abs().max())}")
        for a, b in zip(got.errs, want.errs):
            if not abs(a - b) <= 1e-6 * abs(b):
                fail(f"{what}: error {a} against the unsharded {b}")
        print(f"{what}: {len(got.states)} steps bit for bit the unsharded "
              f"steps; errors {got.errs} (unsharded "
              f"{want.errs[:len(got.errs)]})")

    p5_launches = rec["pair_sweep"]["launches"]
    for n in (2, 4):
        counters.reset()
        with StepRecorder() as r:
            ssolver, _ = cli3d.run_case(
                data, os.path.join(work, f"box_x{n}"), cfgp,
                max_steps=SLICE_STEPS, collect_errs=True, device=dev,
                shards=n, devices=[dev] * n)
        torch.cuda.synchronize()
        got = counters.read()
        rep = ssolver.dispatch_report(NUM_LOCAL)
        print(f"\n{n} shards, X cut into {ssolver.x_cuts}: dispatch "
              f"{rep['dirs']} backend {rep['backend']} pad {rep['pad']}; "
              f"launches {got}")
        want = {k: 0 for k in got}
        want["pair_sweep"] = n * p5_launches
        if set(rep["dirs"].values()) != {"pair"} or got != want:
            fail(f"{n} shards: dispatch {rep['dirs']}, launches {got} "
                 f"(expected {want}: {n} x phase 5's)")
        same_steps(f"256^3 auto over {n} shards", r, p5_steps)
        timing[f"256 pair {n} shards"] = time_steps(
            ssolver, dt, NUM_LOCAL, TIMED_STEPS, math.prod(shape))
        del ssolver
    print(f"ms/step (exact / reciprocal) on one card: 1 shard "
          f"{timing['256 pair']}, 2 shards {timing['256 pair 2 shards']}, "
          f"4 shards {timing['256 pair 4 shards']} ({smi})")

    with StepRecorder() as r:
        ssolver, _ = cli3d.run_case(
            data, os.path.join(work, "box_bal"), cfgp, max_steps=SLICE_STEPS,
            device=dev, shards=2, devices=[dev] * 2, balance="EVEN_VOLUME",
            quiet=True)
    print(f"balance EVEN_VOLUME over 2 shards: X cut into "
          f"{ssolver.x_cuts}")
    same_steps("balance EVEN_VOLUME over 2 shards", r, p5_steps)
    del ssolver

    ssolver = make_solver_3d("ADI", backend="auto", device=dev)
    ssolver.init(bgrid, FluidParams.normalized(200.0, 0.72, 1.4))
    ssolver.set_plan(make_x_mesh(devices=[dev] * 2))
    counters.reset()
    with StepRecorder() as r:
        for _ in range(SLICE_STEPS):
            ssolver.update_boundaries()
            ssolver.time_step(BAFFLE_DT, NUM_GLOBAL, NUM_LOCAL)
    torch.cuda.synchronize()
    got = counters.read()
    want = {k: 0 for k in got}
    want["pair_sweep_dual"] = 2 * SLICE_STEPS * NUM_GLOBAL * NUM_LOCAL
    want["pair_sweep"] = 2 * SLICE_STEPS * NUM_GLOBAL * 2 * NUM_LOCAL
    print(f"baffle over 2 shards: dispatch "
          f"{ssolver.dispatch_report(NUM_LOCAL)['dirs']}, launches {got}")
    if got != want:
        fail(f"baffle over 2 shards: launches {got}, expected {want}")
    same_steps("the 256^3 baffle over 2 shards", r, p16_steps)
    del ssolver

    ssolver = make_solver_3d("ADI", backend="auto", device=dev)
    ssolver.init(grid_l, params_l)
    ssolver.set_plan(make_x_mesh(devices=[dev] * 2))
    counters.reset()
    with StepRecorder() as r:
        ssolver.update_boundaries()
        ssolver.time_step(dt_l, NUM_GLOBAL, NUM_LOCAL)
    torch.cuda.synchronize()
    got = counters.read()
    want = {k: 0 for k in got}
    want["line_fallback"] = 2 * per_step
    rep = ssolver.dispatch_report(NUM_LOCAL)
    print(f"383^3 over 2 shards, X cut into {ssolver.x_cuts}: dispatch "
          f"{rep['dirs']} pad {rep['pad']}, launches {got}")
    if set(rep["dirs"].values()) != {"fallback"} or got != want:
        fail(f"383^3 over 2 shards: dispatch {rep['dirs']}, launches {got} "
             f"(expected {want})")
    same_steps("383^3 fallback over 2 shards", r, p8_steps)
    del ssolver, r
    torch.cuda.empty_cache()

    counters.reset()
    with StepRecorder(keep=1) as r:
        ssolver, _ = cli3d.run_case(
            data3, os.path.join(work, "box_nl3_x2"), cfgp3, max_steps=1,
            device=dev, shards=2, devices=[dev] * 2, quiet=True)
    torch.cuda.synchronize()
    got = counters.read()
    rep = ssolver.dispatch_report(3)
    print(f"nl=3 over 2 shards: dispatch {rep['dirs']}, launches {got}")
    if rep["dirs"] != {"X": "fallback", "Y": "pair+stream",
                       "Z": "pair+stream"} or not (
            got["pair_sweep"] and got["stream_sweep"]
            and got["line_fallback"]):
        fail(f"nl=3 over 2 shards: dispatch {rep['dirs']}, launches {got}")
    e = check_close("nl=3 step over 2 shards vs the unsharded step",
                    r.states[0], p7_steps.states[0])
    print(f"nl=3 over 2 shards (X on the fallback): max|delta| vs the "
          f"unsharded step {e:.3e} (bound {TOL} x max(1, max|field|))")
    del ssolver

    buf = io.StringIO()
    with contextlib.redirect_stderr(buf), StepRecorder() as r:
        rc = cli3d.main([data, os.path.join(work, "box_main2"), cfgp,
                         "shards", "2", "quiet"])
    msg = buf.getvalue().strip()
    print(f"cli3d.main([..., 'shards', '2']): returned {rc}; {msg!r}")
    if n_cards < 2:
        if rc == 0 or f"only {n_cards} CUDA device" not in msg or r.states:
            fail("cli3d shards 2 on fewer than 2 cards did not refuse "
                 "naming the visible count")
    else:
        if rc != 0:
            fail(f"cli3d shards 2 returned {rc}")
        r.states, r.errs = (r.states[:SLICE_STEPS], r.errs[:SLICE_STEPS])
        same_steps("cli3d.main shards 2 over 2 cards", r, p5_steps)
    t23 = time.perf_counter() - t_phase
    print(f"phase 23: {t23:.1f} s")
    if t23 > 60:
        fail(f"phase 23 took {t23:.1f} s, over its minute")

    # --------------------------------------------- 24. the wavefront
    t_phase = time.perf_counter()
    phase(f"24. the Z-blocked wavefront X sweep (blocking {NBLOCKZ}) on one "
          f"card: the carry kernels vs plain at a 2-shard slab of the 256^3 "
          f"box; scan over 2 and 4 shards, auto at nl=3 and nl=2 over 2, "
          f"383^3 fused_dma over 2")
    from cmcfs_tpu_torch.parallel.pipeline import _largest_divisor_leq
    # (a) the carry kernels at the wavefront's launch shape: a shard's 128
    # X planes of the 256^3 box's rows, one block of 256 / NBLOCKZ columns
    ga = grid_arrays(grid, dev)
    gen_t = torch.Generator(device=dev).manual_seed(SEED + 24)
    temp4, rhs4, _ = noisy_state(ga, grid, gen_t)
    scal = adi3d._nl_scal(0, pa, dt)
    d4 = adi3d.fold_d(*adi3d.fallback_rhs(0, rhs4, temp4, ga, pa, scal[2]),
                      ga.cls_a[0])
    rows = {vi: adi3d.row_coeffs(0, temp4[0], ga.cls_a[0], ga, pa, scal, vi)
            for vi in (0, 3)}
    del temp4, rhs4
    half = grid.dimx // 2
    blk = grid.dimz // _largest_divisor_leq(grid.dimz, NBLOCKZ)
    z0 = 3 * blk
    lines = grid.dimy * blk
    cells = half * lines

    def carry_case(start, k, first, last):
        """(a, b, c, d, cin_c, cin_d, xin) of the planes from ``start``:
        zero carries into the first shard's forward pass and the last
        shard's backward pass, random ones elsewhere."""
        sl = slice(start, start + half)
        a, b, c = (m[sl] for m in rows[0 if k == 3 else 3])
        d = d4[:3, sl] if k == 3 else d4[3:, sl]

        def carry(shape, zero):
            if zero:
                return torch.zeros(shape, device=dev)
            return torch.randn(shape, generator=gen_t, device=dev)

        return (a, b, c, d, carry((grid.dimy, blk), first),
                carry((k, grid.dimy, blk), first),
                carry((k, grid.dimy, blk), last))

    def carry_run(case, exact, last, kernel=True):
        a, b, c, d, cc, cd, xin = case
        fwd, bwd = ((tc.carry_fwd, tc.carry_bwd) if kernel
                    else (tc.carry_fwd_ref, tc.carry_bwd_ref))
        cp = torch.empty_like(a)
        dp = torch.empty((d.shape[0],) + tuple(a.shape), device=dev)
        x = torch.empty_like(dp)
        oc, od = fwd(a, b, c, d, cc, cd, cp, dp, z0, last, exact)
        ox = bwd(cp, dp, xin, x, z0)
        cols = slice(z0, z0 + blk)
        return (cp[..., cols], dp[..., cols], x[..., cols], oc, od, ox)

    print(f"{'shard':<8}{'k':<3}{'exact':<7}{'max|delta|':>11}")
    worst = 0.0
    for which, start, first, last in (("first", 0, True, False),
                                      ("middle", half // 2, False, False),
                                      ("last", half, False, True)):
        for k in (3, 1):
            case = carry_case(start, k, first, last)
            for exact in (True, False):
                got = carry_run(case, exact, last)
                want = carry_run(case, exact, last, kernel=False)
                torch.cuda.synchronize()
                err = max(float((g - w).abs().max())
                          for g, w in zip(got, want))
                print(f"{which:<8}{k:<3}{str(exact):<7}{err:>11.3e}")
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    fail(f"carry kernels, {which} shard k={k} exact={exact}: "
                         f"not bit for bit their plain versions ({err})")
                worst = max(worst, err)
    # one block's X solve of the 4 variables: forward and backward at k = 3
    # and k = 1, a middle shard's
    solve = [carry_case(half // 2, k, False, False) for k in (3, 1)]
    k_ms, p_ms = [], []
    for exact in (True, False):
        tk, tp = in_turns(
            lambda: [carry_run(c, exact, False) for c in solve],
            lambda: [carry_run(c, exact, False, False) for c in solve], 20, 2)
        k_ms.append(tk)
        p_ms.append(tp)
        print(f"one block's X solve of 4 variables ({half} rows x {lines} "
              f"lines, 4 launches), exact={exact}: kernels {tk:.4f} ms, "
              f"plain {tp:.2f} ms ({smi})")
    note("tridiag_carry", worst, k_ms, p_ms, cells)
    del d4, rows, solve, ga

    # (b) scan at ng=4 nl=2 over 2 and 4 shards: bit for bit the unblocked
    # split (X resharded), in both modes
    def split_solver(backend, shards, g, p):
        s = make_solver_3d("ADI", backend=backend, device=dev)
        s.init(g, p)
        s.set_plan(make_x_mesh(devices=[dev] * shards), nblockz=NBLOCKZ)
        return s, s.state()

    def split_run(s, start, nblockz, exact, steps, nl, dt_):
        """``steps`` steps from ``start``: each step's state on the host."""
        s.set_state(*start)
        s.set_blocking(nblockz)
        s.exact = exact
        out = []
        for _ in range(steps):
            s.update_boundaries()
            s.time_step(dt_, NUM_GLOBAL, nl)
            out.append(torch.stack(tuple(s.state()[0])).cpu())
        torch.cuda.synchronize()
        return out

    def split_ms(s, start, nl, dt_, what):
        """ms/step at each nb of NB_TIMED (1: the reshard), both modes."""
        out = {}
        for nb in NB_TIMED:
            for exact in (True, False):
                s.set_state(*start)
                s.set_blocking(nb)
                s.exact = exact
                s.update_boundaries()
                s.time_step(dt_, NUM_GLOBAL, nl, compute_error=False)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(2):
                    s.update_boundaries()
                    s.time_step(dt_, NUM_GLOBAL, nl, compute_error=False)
                torch.cuda.synchronize()
                out[f"nb={nb} exact={exact}"] = (
                    (time.perf_counter() - t0) / 2 * 1e3)
        print(f"{what}: ms/step {json.dumps(out)} ({smi})")
        return out

    nb_b = grid.dimz // blk
    for n in (2, 4):
        s, start = split_solver("scan", n, grid, params)
        counters.reset()
        blocked = split_run(s, start, NBLOCKZ, True, 2, NUM_LOCAL, dt)
        got = counters.read()
        want = {k: 0 for k in got}
        want["tridiag_carry"] = 2 * NUM_GLOBAL * NUM_LOCAL * 2 * 2 * n * nb_b
        want["tridiag_rows"] = 2 * NUM_GLOBAL * NUM_LOCAL * 2 * 2 * n
        print(f"scan over {n} shards, X cut into {s.x_cuts}, blocking "
              f"{NBLOCKZ} ({nb_b} blocks of {blk}): dispatch "
              f"{s.dispatch_report(NUM_LOCAL)['dirs']}; launches over 2 "
              f"steps {got}")
        if got != want:
            fail(f"scan over {n} shards with blocking: launches {got}, "
                 f"expected {want}")
        if n == 2:
            rec["tridiag_carry"]["launches"] = got["tridiag_carry"]
        plain = split_run(s, start, 0, True, 2, NUM_LOCAL, dt)
        for k, (a, b) in enumerate(zip(blocked, plain)):
            if not torch.equal(a, b):
                fail(f"scan over {n} shards, exact: step {k + 1} with "
                     f"blocking differs from the unblocked split by "
                     f"{float((a - b).abs().max())}")
        print(f"exact: 2 steps with blocking {NBLOCKZ} bit for bit the "
              f"unblocked split over {n} shards")
        if n == 2:
            blocked = split_run(s, start, NBLOCKZ, False, 2, NUM_LOCAL, dt)
            plain = split_run(s, start, 0, False, 2, NUM_LOCAL, dt)
            gap = max(float((a - b).abs().max())
                      for a, b in zip(blocked, plain))
            same = all(torch.equal(a, b) for a, b in zip(blocked, plain))
            print(f"reciprocal: 2 steps with blocking "
                  f"{'bit for bit' if same else 'not bit for bit'} the "
                  f"unblocked split, max|delta| {gap:.3e} (the wavefront "
                  f"multiplies row 0 of each X line by 1/b where the "
                  f"reshard's scan rows divide: equal wherever b = 1 or 2)")
            check_close("scan reciprocal, blocking vs unblocked",
                        blocked[-1], plain[-1])
            timing["256 scan 2 shards"] = split_ms(s, start, NUM_LOCAL, dt,
                                                   "scan over 2 shards")
        del s, start, blocked, plain

    # (c) auto at nl=3 over 2 shards: X on the wavefront, Y and Z on the
    # pair and stream kernels, against the unblocked split (X on the
    # fallback iteration); (d) auto at nl=2 with blocking: X stays on the
    # pair kernel
    s, start = split_solver("auto", 2, grid, params)
    counters.reset()
    blocked = split_run(s, start, NBLOCKZ, True, 1, 3, dt)
    got = counters.read()
    rep = s.dispatch_report(3)["dirs"]
    print(f"auto nl=3 over 2 shards, blocking {NBLOCKZ}: dispatch {rep}; "
          f"launches {got}")
    if rep != {"X": "fallback", "Y": "pair+stream", "Z": "pair+stream"} \
            or got["line_sweep"] or not (got["tridiag_carry"]
                                         and got["pair_sweep"]
                                         and got["stream_sweep"]):
        fail(f"auto nl=3 with blocking: dispatch {rep}, launches {got}")
    plain = split_run(s, start, 0, True, 1, 3, dt)
    e = check_close("auto nl=3 over 2 shards, blocking vs unblocked",
                    blocked[0], plain[0])
    print(f"auto nl=3 over 2 shards: the wavefront step within {e:.3e} of "
          f"the unblocked split's (X on the fallback iteration; bound "
          f"{TOL} x max(1, max|field|))")
    # the X direction alone at nl=3, from a noisy state whose out layer is
    # stored in bf16 as the pair and stream kernels leave it: auto's
    # wavefront (float32 rows, exact) bit for bit the single device's
    # scan X direction, whose recurrence the carry kernels compute
    ga1 = grid_arrays(grid, dev)
    temp4, rhs4, op4 = noisy_state(ga1, grid, gen_t)
    op4 = op4.bfloat16()
    scal = adi3d._nl_scal(0, s.pa, dt)
    one = adi3d.x_direction("fallback", [rhs4], [temp4], [op4], ga1, s.pa,
                            scal, 3, True, False, "scan")
    slabs = [s.plan.split(f, -3, s.x_cuts) for f in (rhs4, temp4, op4)]
    del ga1, temp4, rhs4, op4
    s.set_blocking(NBLOCKZ)
    split = adi3d.x_direction("fallback", *slabs, s.ga, s.pa, scal, 3, True,
                              False, adi3d.resolve_backend("auto", s.plan),
                              s.plan)
    for what, a, b in zip(("temp", "out"), split, one):
        a = s.plan.gather(a, -3)
        if a.dtype != torch.float32 or not torch.equal(a, b[0]):
            fail(f"auto nl=3 wavefront X direction, {what}: {a.dtype}, "
                 f"max|delta| {float((a.float() - b[0]).abs().max())} "
                 f"against the single device's scan X direction")
    print("auto nl=3 over 2 shards: the wavefront X direction (temp, out) "
          "bit for bit the single device's scan X direction, float32")
    del one, slabs, split
    timing["256 nl=3 2 shards"] = split_ms(s, start, 3, dt,
                                           "auto nl=3 over 2 shards")
    counters.reset()
    blocked = split_run(s, start, NBLOCKZ, True, 1, NUM_LOCAL, dt)
    got = counters.read()
    rep = s.dispatch_report(NUM_LOCAL)["dirs"]
    print(f"auto nl=2 over 2 shards, blocking {NBLOCKZ}: dispatch {rep}; "
          f"launches {got}")
    if rep["X"] != "pair" or got["tridiag_carry"] or \
            not torch.equal(blocked[0], p5_steps.states[0]):
        fail(f"auto nl=2 with blocking: dispatch {rep}, launches {got}, "
             f"or the step differs from phase 5's")
    print("auto nl=2 with blocking: X stays on the pair kernel, the step "
          "bit for bit phase 5's first")
    del s, start, blocked, plain
    torch.cuda.empty_cache()

    # (e) 383^3 fused_dma over 2 shards: X on the wavefront (383 columns
    # divide only by 1 and 383: one block), Y and Z on the fallback
    # iteration; the step timed on its own (synchronised, the state's copy
    # to the host left out), beside the unblocked split's
    s, start = split_solver("fused_dma", 2, grid_l, params_l)
    step_ms = {}
    for nblockz in (0, NBLOCKZ):
        s.set_state(*start)
        s.set_blocking(nblockz)
        s.exact = True
        counters.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.update_boundaries()
        s.time_step(dt_l, NUM_GLOBAL, NUM_LOCAL)
        torch.cuda.synchronize()
        step_ms[nblockz] = (time.perf_counter() - t0) * 1e3
    got = counters.read()
    blocked = torch.stack(tuple(s.state()[0])).cpu()
    e = check_close("383^3 fused_dma over 2 shards with blocking vs phase 8",
                    blocked, p8_steps.states[0])
    print(f"383^3 fused_dma over 2 shards, blocking {NBLOCKZ} "
          f"({_largest_divisor_leq(grid_l.dimz, NBLOCKZ)} block): dispatch "
          f"{s.dispatch_report(NUM_LOCAL)['dirs']}, launches {got}; "
          f"{step_ms[NBLOCKZ]:.1f} ms for the step, unblocked "
          f"{step_ms[0]:.1f} (exact, {smi}); max|delta| vs phase 8's step "
          f"{e:.3e}")
    if not (got["tridiag_carry"] and got["line_fallback"]):
        fail(f"383^3 fused_dma with blocking: launches {got}")
    del s, start, blocked
    torch.cuda.empty_cache()
    print(f"phase 24: {time.perf_counter() - t_phase:.1f} s")

    # --------------------------------- 25. the schemes split over X
    t_phase = time.perf_counter()
    phase(f"25. Explicit and Stable split over X on one card: the "
          f"{SCHEME_CHECK_N}^3 lid cavity over 2 and 4 shards, the "
          f"{SCHEME_N}^3 one over 2, against the unsharded steps")

    def same_scheme(what, sv, state, err, iters, it_sv):
        got = torch.stack(tuple(sv.state()[0])).cpu()
        if not torch.equal(got, state) or it_sv != iters or not (
                abs(sv.last_err - err) <= 1e-6 * abs(err)):
            fail(f"{what}: max|delta| {float((got - state).abs().max())}, "
                 f"Poisson {it_sv} against {iters}, error {sv.last_err} "
                 f"against {err}")
        print(f"{what}: bit for bit the unsharded steps, Poisson iterations "
              f"{it_sv}, error {sv.last_err:.6e}")

    for scheme, steps in (("Explicit", EXPLICIT_STEPS), ("Stable", 1)):
        one, _, it_one = scheme_3d(scheme, SCHEME_CHECK_N, steps, dev)
        ref = (torch.stack(tuple(one.cur)).cpu(), one.last_err, it_one)
        del one
        for n in (2, 4):
            sv, _, its = scheme_3d(scheme, SCHEME_CHECK_N, steps, dev, n)
            same_scheme(f"{scheme} {SCHEME_CHECK_N}^3 over {n} shards", sv,
                        *ref, its)
            del sv
    for scheme, steps in (("Explicit", EXPLICIT_STEPS), ("Stable", 1)):
        sv, ms, its = scheme_3d(scheme, SCHEME_N, steps, dev, 2)
        timing[f"{SCHEME_N} {scheme} ng={SCHEME_NG} 2 shards"] = {
            True: ms[-1]}
        same_scheme(f"{scheme} {SCHEME_N}^3 over 2 shards", sv, *p19[scheme],
                    its)
        print(f"{scheme} {SCHEME_N}^3: ms a step over 2 shards {ms}, "
              f"unsharded (phase 19) "
              f"{timing[f'{SCHEME_N} {scheme} ng={SCHEME_NG}'][True]:.1f}")
        del sv
    torch.cuda.empty_cache()
    print(f"phase 25: {time.perf_counter() - t_phase:.1f} s")

    # ------------------------------------------------------------ result
    phase("result")
    print(f"ms/step by slice and exact mode: {json.dumps(timing)}")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(rec.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
