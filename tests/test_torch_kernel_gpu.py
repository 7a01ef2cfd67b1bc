"""The CUDA kernels (pair, stream and line sweeps, in their 3D and 2D
modes, the pair sweep's dual form, the PCR pair sweep, the tridiag_rows
Thomas solve, and the five measurement probes of cmcfs_tpu_torch/probes)
against their plain PyTorch versions, on the card.

Marked ``gpu``: each test decides inside itself whether a CUDA device is
present and skips otherwise.  This file imports no JAX, so it also runs on
a machine that has only PyTorch:

    python -m pytest -m gpu tests/test_torch_kernel_gpu.py

Bound per variable 1e-5 * max(1, max|plain|), as chip_smoke.py's: nvcc
contracts mul-adds into FMAs where eager PyTorch rounds every op; the
diagonally dominant Thomas rows do not amplify ulp-level differences.
The probes round as their plain versions do and are held to them bit for
bit, but for the variants that measure contraction (1e-6 relative) and
cyclic reduction against Thomas (1e-5).  So are the pair, stream, line
and row kernels on the edges of their tiles (``*_edges_bitwise``: ragged
chunks and blocks, grid-edge lines, random classes or whole segments;
the line sweep's alternative Z tiles; the row kernel's k-form), the dual
pair kernel (the FREE baffle turned onto each axis, and random classes and
flags on the tiles' edges) and the PCR kernel (n from 1 to 256 across
every boundary of a warp's layout on each axis, with and without duals;
no instantiation spills).  The bf16 payload mode of every kernel
(``*_bf16_bitwise``: bf16 rhs, out_prev or d in, bf16 out and tn or x out,
float32 in between) is held to its plain version bit for bit on the same
edges, with its launches counted apart (``bf16_launches``), and with its
bf16 inputs starting on either half of a 4-byte word
(``test_bf16_loader_offsets*``: the staged loader's run offsets).  The
row path's step equals the CPU's bit for bit
(``test_row_step_card_equals_cpu``), and the step split over X equals
the single card's bit for bit, over shards emulated on one card and over
real cards where two or more are visible (``test_sharded_step_*``).  The
wavefront's carry kernels equal their plain versions bit for bit
(``test_tridiag_carry_kernels_bitwise``), and the split ``scan`` step
with ``blocking`` equals the unblocked split's
(``test_wavefront_step_bitwise``).
"""
import numpy as np
import pytest
import torch

from cmcfs_tpu_torch.core.params import FluidParams
from cmcfs_tpu_torch.core.types import BCtype, NodeType
from cmcfs_tpu_torch.geom.baffle import free_baffled
from cmcfs_tpu_torch.geom.synthetic import lid_cavity_2d, lid_cavity_3d
from cmcfs_tpu_torch.models import adi2d, adi3d
from cmcfs_tpu_torch.models import common2d
from cmcfs_tpu_torch.models.common3d import (dual_flags, grid_arrays,
                                             init_state, merge_ok,
                                             update_boundaries)
from cmcfs_tpu_torch.ops import line_sweep as ls
from cmcfs_tpu_torch.ops import masks
from cmcfs_tpu_torch.ops import pair_sweep as ps
from cmcfs_tpu_torch.ops import pcr_sweep as pcs
from cmcfs_tpu_torch.ops import stream_sweep as ss
from cmcfs_tpu_torch.ops import tridiag_rows as tr
from cmcfs_tpu_torch.ops.sweep_common import pack_masks
from cmcfs_tpu_torch.probes import kernel_probe as kp
from cmcfs_tpu_torch.probes import probe_diss_bitwise as pdb
from cmcfs_tpu_torch.probes import probe_ilp as pil
from cmcfs_tpu_torch.probes import probe_rowcost as prc
from cmcfs_tpu_torch.probes import probe_slabdma as psd


def _within(k4, p4):
    for k, p in zip(k4, p4):
        bound = 1e-5 * max(1.0, float(p.abs().max()))
        assert float((k - p).abs().max()) <= bound


def _baffle(grid):
    """The FREE-bc baffle with a hole (__graft_entry__._setup): X lines
    keep FREE dual endpoints."""
    nx, ny, _ = grid.types.shape
    bf = np.zeros(grid.types.shape, dtype=bool)
    bf[nx // 2, 2:-2, 2:-2] = True
    grid.types[bf] = NodeType.BOUND
    grid.types[nx // 2, ny // 2 - 1:ny // 2 + 1, 2:-2] = NodeType.IN
    grid.bc_temp[bf] = BCtype.FREE
    return grid


def _case(device, seed=0, baffle=False):
    grid = lid_cavity_3d(24, 20, 18)
    if baffle:
        grid = _baffle(grid)
    ga = grid_arrays(grid, device)
    pa = adi3d.make_params(FluidParams.normalized(200.0, 0.72, 1.4),
                           grid.dx, grid.dy, grid.dz)
    base = torch.stack(tuple(update_boundaries(init_state(grid, device), ga)))
    rng = np.random.default_rng(seed)
    is_in = ga.types == NodeType.IN

    def noisy():
        n = torch.tensor(rng.standard_normal(tuple(base.shape)),
                         dtype=torch.float32, device=device)
        return torch.where(is_in, base + 0.1 * n, base)

    return ga, pa, noisy(), noisy(), noisy()


@pytest.mark.gpu
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_kernel_matches_plain(axis, exact):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ga, pa, temp4, rhs4, op4 = _case("cuda")
    assert merge_ok(ga)[axis]
    args = (temp4, ga.cls_a[axis], ga.bc_vel, ga.bc_temp, rhs4, op4,
            adi3d._nl_scal(axis, pa, 0.01), axis, exact, axis == 0)
    before = ps.launches.count
    out_k, tn_k = ps.pair_sweep(*args)
    assert ps.launches.count == before + 2
    out_p, tn_p = ps.pair_sweep_ref(*args)
    torch.cuda.synchronize()
    for k4, p4 in ((out_k, out_p), (tn_k, tn_p)):
        for k, p in zip(k4, p4):
            bound = 1e-5 * max(1.0, float(p.abs().max()))
            assert float((k - p).abs().max()) <= bound


@pytest.mark.gpu
def test_step_on_gpu_matches_cpu():
    """One whole ADI step on the card (kernel) against the same step on
    the CPU (plain version)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    steps = {}
    for dev in ("cpu", "cuda"):
        ga, pa, temp4, _, _ = _case(dev, seed=1)
        cur = tuple(temp4)
        new, err = adi3d.adi_timestep_3d(cur, cur, ga, 0.01, 2, 2, pa,
                                         exact=True, merge_ok=merge_ok(ga))
        steps[dev] = (torch.stack(tuple(new)).cpu(), float(err))
    (x_c, e_c), (x_g, e_g) = steps["cpu"], steps["cuda"]
    assert np.isfinite(e_g) and abs(e_g - e_c) <= 1e-4 * abs(e_c)
    for c, g in zip(x_c, x_g):
        bound = 1e-5 * max(1.0, float(c.abs().max()))
        assert float((g - c).abs().max()) <= bound


@pytest.mark.gpu
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("shape, axis", [((23, 19, 17), 0), ((23, 19, 17), 1),
                                         ((23, 19, 17), 2), ((300, 7, 9), 0),
                                         ((9, 7, 300), 2)])
def test_line_sweep_kernel_matches_plain(shape, axis, exact):
    """Odd lengths, every axis, and 300-cell lines (past the TPU kernels'
    288-cell VMEM cap): random classes and BC codes, FREE rows included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(axis + 5 * exact)
    pk = torch.tensor(rng.choice([0, 1, 2, 3], shape, p=[.1, .1, .1, .7])
                      + 4 * rng.integers(0, 2, shape)
                      + 8 * rng.integers(0, 2, shape), dtype=torch.int8,
                      device="cuda")
    adv = torch.tensor(0.2 * rng.standard_normal(shape), dtype=torch.float32,
                       device="cuda")
    d4 = torch.tensor(rng.standard_normal((4,) + shape), dtype=torch.float32,
                      device="cuda")
    scal = np.array([0.5, 0.7, 30.0, 5.0], dtype=np.float32)
    before = ls.launches.count
    x_k = ls.line_sweep(adv, pk, d4, scal, axis, exact)
    assert ls.launches.count == before + 1
    x_p = ls.line_sweep_ref(adv, pk, d4, scal, axis, exact)
    torch.cuda.synchronize()
    _within(x_k, x_p)


@pytest.mark.gpu
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_stream_kernel_matches_plain(axis, exact):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ga, pa, temp4, rhs4, op4 = _case("cuda", seed=2)
    rng = np.random.default_rng(axis)
    forcing = torch.tensor(0.1 * rng.standard_normal(tuple(ga.types.shape)),
                           dtype=torch.float32, device="cuda")
    args = (temp4, ga.cls_a[axis], ga.bc_vel, ga.bc_temp, rhs4, op4, forcing,
            adi3d._nl_scal(axis, pa, 0.01)[:5], axis, exact)
    before = ss.launches.count
    out_k, tn_k = ss.stream_sweep(*args)
    assert ss.launches.count == before + 1
    out_p, tn_p = ss.stream_sweep_ref(*args)
    torch.cuda.synchronize()
    _within(out_k, out_p)
    _within(tn_k, tn_p)


@pytest.mark.gpu
@pytest.mark.parametrize("backend, num_local, baffle",
                         [("fused_dma", 2, False), ("fused", 2, False),
                          ("fused_full", 2, False), ("auto", 3, False),
                          ("auto", 1, False), ("auto", 3, True),
                          ("auto", 2, True), ("fused_pcr", 2, False),
                          ("fused_pcr", 2, True), ("fused_pcr", 3, False),
                          ("pcr", 2, False)])
def test_step_paths_on_gpu_match_cpu(backend, num_local, baffle):
    """One whole ADI step on each path, on the card (kernels) against the
    same step on the CPU (plain versions)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    steps = {}
    for dev in ("cpu", "cuda"):
        ga, pa, temp4, _, _ = _case(dev, seed=3, baffle=baffle)
        cur = tuple(temp4)
        new, err = adi3d.adi_timestep_3d(cur, cur, ga, 0.01, 2, num_local,
                                         pa, backend=backend, exact=False,
                                         merge_ok=merge_ok(ga))
        steps[dev] = (torch.stack(tuple(new)).cpu(), float(err))
    (x_c, e_c), (x_g, e_g) = steps["cpu"], steps["cuda"]
    assert np.isfinite(e_g) and abs(e_g - e_c) <= 1e-4 * abs(e_c)
    _within(x_g, x_c)


@pytest.mark.gpu
@pytest.mark.parametrize("recip_row0", [True, False])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("shape, axis", [((37, 300), 0), ((3, 41, 29), 1),
                                         ((3, 29, 41), 2), ((19, 7, 5), 0)])
def test_tridiag_rows_kernel_matches_plain(shape, axis, exact, recip_row0):
    """Every axis of a contiguous array (rows by stride), odd lengths,
    identity rows mixed in, both exact modes and both row-0 forms."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(len(shape) + axis)
    a = rng.uniform(-1, 1, shape)
    c = rng.uniform(-1, 1, shape)
    b = np.abs(a) + np.abs(c) + rng.uniform(1, 3, shape)
    d = rng.standard_normal(shape)
    ident = rng.random(shape) < 0.15
    a[ident], c[ident], b[ident] = 0, 0, 1
    rows = [torch.tensor(t, dtype=torch.float32, device="cuda")
            for t in (a, b, c, d)]
    before = tr.launches.count
    x_k = tr.tridiag_rows(*rows, axis=axis, exact=exact,
                          recip_row0=recip_row0)
    assert tr.launches.count == before + 1
    x_p = tr.tridiag_rows_ref(*rows, axis=axis, exact=exact,
                              recip_row0=recip_row0)
    torch.cuda.synchronize()
    _within(x_k[None], x_p[None])


def _segments(rng, shape, axis):
    """Line classes made of whole segments along ``axis`` (BC0, interior
    rows, BC1), identity cells between."""
    n = shape[axis]
    lines = np.zeros((int(np.prod(shape)) // n, n), dtype=np.int8)
    for line in lines:
        i = 0
        while i < n:
            seg = int(rng.integers(3, 12))
            if rng.random() < 0.15 or i + seg > n:
                i += 1
                continue
            line[i], line[i + 1:i + seg - 1], line[i + seg - 1] = 1, 3, 2
            i += seg
    rest = tuple(m for ax, m in enumerate(shape) if ax != axis)
    return np.ascontiguousarray(np.moveaxis(lines.reshape(rest + (n,)), -1,
                                            axis))


@pytest.mark.gpu
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("shape, axis", [((23, 19), 0), ((23, 19), 1),
                                         ((300, 9), 0), ((9, 300), 1)])
def test_line_sweep_2d_kernel_matches_plain(shape, axis, exact):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(axis + 3 * exact)
    # whole segments: random classes can make a 2D FREE system singular
    cls = torch.tensor(_segments(rng, shape, axis), device="cuda")
    bct = torch.tensor(rng.integers(0, 2, shape), dtype=torch.int8,
                       device="cuda")
    pk = pack_masks(cls, bct, bct)
    adv = torch.tensor(0.2 * rng.standard_normal(shape), dtype=torch.float32,
                       device="cuda")
    d3 = torch.tensor(rng.standard_normal((3,) + shape), dtype=torch.float32,
                      device="cuda")
    scal = np.array([0.5, 0.7, 30.0, 5.0], dtype=np.float32)
    before = ls.launches.count
    x_k = ls.line_sweep_2d(adv, pk, d3, scal, axis, exact)
    assert ls.launches.count == before + 1
    x_p = ls.line_sweep_2d_ref(adv, pk, d3, scal, axis, exact)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(x_p).all())
    _within(x_k, x_p)


def _case2d(device, seed):
    grid = lid_cavity_2d(40, 36, dx=0.002)
    grid.cur_bct[38, 2:-2] = BCtype.FREE
    ga = common2d.grid_arrays(grid, device)
    pa = adi2d.make_params(FluidParams.normalized(200.0, 0.72, 1.4),
                           grid.dx, grid.dy, grid.start_T)
    base = torch.stack(tuple(common2d.update_boundaries(
        common2d.init_state(grid, device), ga)))
    rng = np.random.default_rng(seed)
    is_in = ga.types == NodeType.IN

    def noisy():
        n = torch.tensor(rng.standard_normal(tuple(base.shape)),
                         dtype=torch.float32, device=device)
        return torch.where(is_in, base + 0.01 * n, base)

    return ga, pa, noisy(), noisy(), noisy()


@pytest.mark.gpu
@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("axis", [0, 1])
def test_stream_sweep_2d_kernel_matches_plain(axis, exact, first):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ga, pa, temp3, rhs3, op3 = _case2d("cuda", seed=axis)
    assert adi2d.stream_ok_2d(ga) == (True, True)
    rng = np.random.default_rng(7 + axis)
    forcing = torch.tensor(0.1 * rng.standard_normal(tuple(ga.types.shape)),
                           dtype=torch.float32, device="cuda")
    scal = np.array([30.0, 20.0, 1000.0, 250.0, 1.0], dtype=np.float32)
    args = (temp3, ga.cls_x if axis == 0 else ga.cls_y, ga.bct, rhs3, op3,
            forcing, scal, axis, exact, first)
    before = ss.launches.count
    out_k, tn_k = ss.stream_sweep_2d(*args)
    assert ss.launches.count == before + 1
    out_p, tn_p = ss.stream_sweep_2d_ref(*args)
    torch.cuda.synchronize()
    _within(out_k, out_p)
    _within(tn_k, tn_p)


@pytest.mark.gpu
@pytest.mark.parametrize("backend, num_local", [
    ("fused_dma", 1), ("fused_full", 2), ("fused_nl", 1), ("scan", 2),
    ("pallas", 1)])
def test_step_2d_on_gpu_matches_cpu(backend, num_local):
    """One whole 2D ADI step per backend on the card (kernels) against the
    same step on the CPU (plain versions)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    steps = {}
    for dev in ("cpu", "cuda"):
        ga, pa, temp3, _, _ = _case2d(dev, seed=4)
        new, err, it = adi2d.adi_timestep_2d(
            common2d.State2D(*temp3), ga, 0.001, 2, num_local, pa,
            backend=backend, exact=False, stream_ok=adi2d.stream_ok_2d(ga))
        steps[dev] = (torch.stack(tuple(new)).cpu(), float(err), it)
    (x_c, e_c, i_c), (x_g, e_g, i_g) = steps["cpu"], steps["cuda"]
    assert i_c == i_g
    assert np.isfinite(e_g) and abs(e_g - e_c) <= 1e-4 * abs(e_c)
    _within(x_g, x_c)


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["scan", "pallas"])
def test_step_rows_3d_on_gpu_matches_cpu(backend):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    steps = {}
    for dev in ("cpu", "cuda"):
        ga, pa, temp4, _, _ = _case(dev, seed=5, baffle=True)
        cur = tuple(temp4)
        before = tr.launches.count
        new, err = adi3d.adi_timestep_3d(cur, cur, ga, 0.01, 1, 1, pa,
                                         backend=backend, exact=False,
                                         merge_ok=merge_ok(ga))
        # (u, v, w) and T x 3 directions, plus pass B on the dual X lines
        assert tr.launches.count - before == (8 if dev == "cuda" else 0)
        steps[dev] = (torch.stack(tuple(new)).cpu(), float(err))
    (x_c, e_c), (x_g, e_g) = steps["cpu"], steps["cuda"]
    assert np.isfinite(e_g) and abs(e_g - e_c) <= 1e-4 * abs(e_c)
    _within(x_g, x_c)


def _edge_fields(rng, shape, nvars, segments_axis=None):
    """Random classes (INTERIOR never on a face of the grid, where the
    kernel clamps neighbours that the plain version wraps) or, along
    ``segments_axis``, whole segments (2D FREE rows); random FREE codes;
    noisy temp, rhs and out_prev; and a forcing."""
    if segments_axis is None:
        cls = rng.choice([0, 1, 2, 3], shape, p=[.1, .1, .1, .7])
        face = np.zeros(shape, dtype=bool)
        for ax in range(len(shape)):
            idx = [slice(None)] * len(shape)
            for end in (0, -1):
                idx[ax] = end
                face[tuple(idx)] = True
        cls[face] = rng.integers(0, 3, int(face.sum()))
    else:
        cls = _segments(rng, shape, segments_axis)

    def t(a, dtype=torch.float32):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                            device="cuda")

    fields = [t(0.3 * rng.standard_normal((nvars,) + shape))
              for _ in range(3)]
    masks = [t(cls, torch.int8)] + [t(rng.integers(0, 2, shape), torch.int8)
                                    for _ in range(2)]
    return masks, fields, t(0.1 * rng.standard_normal(shape))


# the tiles of pair_sweep.cu (lines x rows): 3D X/Y 64 x 2, Z 64 x 8, 2D
# 32 x 8; lines of 5, 37 and 256 rows, 33 and 100 lines along the block's
# axis (nz on X and Y, ny on Z), so chunks and blocks run ragged (Z at
# (3, 100, 37): a full 64-line block and a ragged one, each with full
# 8-row chunks and a ragged last one); every line at the grid's faces is
# an edge line whose cross neighbours are clamped
_EDGE_3D = [((37, 7, 33), 0), ((256, 3, 33), 0), ((6, 5, 100), 1),
            ((4, 256, 33), 1), ((9, 33, 37), 2), ((4, 100, 5), 2),
            ((3, 100, 37), 2), ((3, 33, 256), 2)]
_PAIR_SCAL = np.array([0.5, 0.7, 30.0, 5.0, 0.3, 0.01, 4.0, 6.0],
                      dtype=np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("gmerge", [True, False])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("shape, axis", _EDGE_3D)
def test_pair_kernel_edges_bitwise(shape, axis, exact, gmerge):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(sum(shape) + 10 * axis)
    (cls, bcv, bct), (temp4, rhs4, op4), _ = _edge_fields(rng, shape, 4)
    args = (temp4, cls, bcv, bct, rhs4, op4, _PAIR_SCAL, axis, exact, gmerge)
    before = ps.launches.count
    out_k, tn_k = ps.pair_sweep(*args)
    assert ps.launches.count == before + 2
    for g, w in zip((out_k, tn_k), ps.pair_sweep_ref(*args)):
        assert _max_err(g, w) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("shape, axis", _EDGE_3D)
def test_stream_kernel_edges_bitwise(shape, axis, exact):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(sum(shape) + 10 * axis + 1)
    (cls, bcv, bct), (temp4, rhs4, op4), forcing = _edge_fields(rng, shape,
                                                                 4)
    args = (temp4, cls, bcv, bct, rhs4, op4, forcing, _PAIR_SCAL[:5], axis,
            exact)
    out_k, tn_k = _counted(ss, lambda: ss.stream_sweep(*args))
    for g, w in zip((out_k, tn_k), ss.stream_sweep_ref(*args)):
        assert _max_err(g, w) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("shape, axis", [((37, 100), 0), ((100, 37), 1),
                                         ((256, 33), 0), ((33, 256), 1),
                                         ((5, 1024), 0), ((1024, 5), 1)])
def test_stream_sweep_2d_kernel_edges_bitwise(shape, axis, exact, first):
    """The 2D tile (32 lines, 8 rows): 33, 100 and 1,024 lines, lines of
    5, 37 and 256 rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(sum(shape) + 10 * axis + 2)
    (cls, _, bct), (temp3, rhs3, op3), forcing = _edge_fields(
        rng, shape, 3, segments_axis=axis)
    scal = np.array([30.0, 20.0, 1000.0, 250.0, 1.0], dtype=np.float32)
    args = (temp3, cls, bct, rhs3, op3, forcing, scal, axis, exact, first)
    out_k, tn_k = _counted(ss, lambda: ss.stream_sweep_2d(*args))
    for g, w in zip((out_k, tn_k), ss.stream_sweep_2d_ref(*args)):
        assert _max_err(g, w) == 0.0


# the tiles of line_sweep.cu (lines x rows): 3D X/Y 64 x 2, Z 64 x 16 (and
# the Z alternatives of Z_ROWS), 2D 8 x 8; lines of 1, 2, 5, 37, 256, 300
# and 383 rows, none a multiple of 16 but 256; 33 and 100 lines along the
# block's axis (nz on X and Y, ny on Z), so chunks and blocks run ragged
_LINE_EDGE_3D = [((1, 3, 33), 0), ((2, 5, 100), 0), ((37, 3, 33), 0),
                 ((383, 2, 33), 0), ((3, 5, 100), 1), ((2, 256, 33), 1),
                 ((2, 300, 100), 1), ((3, 33, 1), 2), ((2, 100, 2), 2),
                 ((3, 100, 5), 2), ((2, 33, 37), 2), ((2, 100, 256), 2),
                 ((2, 33, 300), 2), ((1, 100, 383), 2)]


def _line_case(shape, axis, nvars, seed):
    """Whole random segments along ``axis`` (random FREE bits), noisy adv
    and right-hand sides, on the card."""
    rng = np.random.default_rng(seed)
    cls = torch.tensor(_segments(rng, shape, axis), device="cuda")
    bcv, bct = (torch.tensor(rng.integers(0, 2, shape), dtype=torch.int8,
                             device="cuda") for _ in range(2))
    pk = pack_masks(cls, bcv if nvars == 4 else bct, bct)
    adv = torch.tensor(0.2 * rng.standard_normal(shape), dtype=torch.float32,
                       device="cuda")
    d = torch.tensor(rng.standard_normal((nvars,) + shape),
                     dtype=torch.float32, device="cuda")
    return adv, pk, d, np.array([0.5, 0.7, 30.0, 5.0], dtype=np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("shape, axis", _LINE_EDGE_3D)
def test_line_sweep_kernel_edges_bitwise(shape, axis, exact):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    adv, pk, d4, scal = _line_case(shape, axis, 4, sum(shape) + 10 * axis)
    x_k = _counted(ls, lambda: ls.line_sweep(adv, pk, d4, scal, axis, exact))
    assert _max_err(x_k, ls.line_sweep_ref(adv, pk, d4, scal, axis,
                                           exact)) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("z_rows", ls.Z_ROWS[1:])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("shape", [s for s, ax in _LINE_EDGE_3D if ax == 2])
def test_line_sweep_z_tiles_bitwise(shape, exact, z_rows):
    """The Z tiles timed beside the source's own (chip_smoke.py phase 9)
    solve the same systems."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    adv, pk, d4, scal = _line_case(shape, 2, 4, sum(shape) + 20)
    x_k = _counted(ls, lambda: ls._launch(adv, pk, d4, scal, 2, 2, exact,
                                          z_rows))
    assert _max_err(x_k, ls.line_sweep_ref(adv, pk, d4, scal, 2, exact)) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("shape", [(23, 19), (300, 9), (9, 300), (1041, 37)])
def test_line_sweep_2d_kernel_edges_bitwise(shape, axis, exact):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    adv, pk, d3, scal = _line_case(shape, axis, 3, sum(shape) + 10 * axis)
    x_k = _counted(ls, lambda: ls.line_sweep_2d(adv, pk, d3, scal, axis,
                                                exact))
    assert _max_err(x_k, ls.line_sweep_2d_ref(adv, pk, d3, scal, axis,
                                              exact)) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("recip_row0", [True, False])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("k", [None, 1, 3])
@pytest.mark.parametrize("shape, axis", [((37, 100), 0), ((3, 41, 29), 1),
                                         ((70, 300), 1), ((3, 33, 37), 2),
                                         ((5, 256, 33), 1), ((100, 5), 1)])
def test_tridiag_rows_kernel_edges_bitwise(shape, axis, k, exact,
                                           recip_row0):
    """tridiag_rows.cu's tiles (32 lines x 2 rows; post == 1, 32 x 16):
    lines along the contiguous axis at 70, 99 and 100 lines (ragged
    blocks) of 300, 37 and 5 rows; one right-hand side (``k`` None: d
    shaped as the rows) and the k-form at k = 1 and 3 (one launch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(sum(shape) + axis + (k or 0))
    a = rng.uniform(-1, 1, shape)
    c = rng.uniform(-1, 1, shape)
    b = np.abs(a) + np.abs(c) + rng.uniform(1, 3, shape)
    ident = rng.random(shape) < 0.15
    a[ident], c[ident], b[ident] = 0, 0, 1
    d = rng.standard_normal(shape if k is None else (k,) + shape)
    rows = [torch.tensor(t, dtype=torch.float32, device="cuda")
            for t in (a, b, c, d)]
    x_k = _counted(tr, lambda: tr.tridiag_rows(*rows, axis=axis, exact=exact,
                                               recip_row0=recip_row0))
    assert x_k.shape == rows[3].shape
    assert _max_err(x_k, tr.tridiag_rows_ref(
        *rows, axis=axis, exact=exact, recip_row0=recip_row0)) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("k, launches", [(2, 2), (4, 2), (7, 3)])
def test_tridiag_rows_k_runs_as_launches_of_3_and_1(k, launches):
    """The kernel takes k = 1 or 3; other k run as launches of 3, then 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(k)
    shape = (3, 70, 37)
    a = rng.uniform(-1, 1, shape)
    c = rng.uniform(-1, 1, shape)
    b = np.abs(a) + np.abs(c) + rng.uniform(1, 3, shape)
    rows = [torch.tensor(t, dtype=torch.float32, device="cuda")
            for t in (a, b, c, rng.standard_normal((k,) + shape))]
    before = tr.launches.count
    x_k = tr.tridiag_rows(*rows, axis=2, exact=False, recip_row0=True)
    assert tr.launches.count - before == launches
    assert _max_err(x_k, tr.tridiag_rows_ref(*rows, axis=2, exact=False,
                                             recip_row0=True)) == 0.0


def _cuda_gen(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(seed)


def _counted(mod, fn):
    """fn()'s result, checking that it launched the module's kernel once."""
    before = mod.launches.count
    out = fn()
    assert mod.launches.count == before + 1
    return out


def _max_err(got, want):
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    return float((got - want).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("variant", list(prc.VARIANTS))
def test_probe_rowcost_matches_plain(variant):
    gen = _cuda_gen(11)
    n, nb = 32, 3
    sub, lanes = prc.VARIANTS[variant][:2]
    a, r, d = prc.inputs((n * nb, sub, lanes), gen, torch.device("cuda"))
    if variant == "strided":
        a, r, d = (prc.chain_major(x, n) for x in (a, r, d))
    got = _counted(prc, lambda: prc.chain(a, r, d, n, variant))
    want = prc.chain_ref(a, r, d, n, variant)
    tol = 1e-6 * float(want.abs().max()) if variant == "base_fma" else 0.0
    assert _max_err(got, want) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("ilp", [False, True])
def test_probe_ilp_matches_plain(ilp, k):
    gen = _cuda_gen(12)
    dev = torch.device("cuda")
    n, nb = 32, 2
    a = prc.common.uniform((n * nb, 8, 128), 0.1, 0.2, gen, dev)
    r = prc.common.uniform((n * nb, 8, 128), 0.9, 1.1, gen, dev)
    d = prc.common.uniform((k, n * nb, 8, 128), 0.0, 1.0, gen, dev)
    got = _counted(pil, lambda: pil.chains(a, r, d, n, ilp))
    assert _max_err(got, pil.chains_ref(a, r, d, n, ilp)) == 0.0
    assert _max_err(got, pil.chains_ref(a, r, d, n, not ilp)) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("depth", psd.DEPTHS)
@pytest.mark.parametrize("mode", list(psd.MODES))
@pytest.mark.parametrize("n", [128, 256])
def test_probe_slabdma_matches_plain(n, mode, depth):
    gen = _cuda_gen(13)
    dense = torch.rand((n, n, n), generator=gen, device="cuda")
    x = psd.blocked_of(dense) if mode == "blocked" else dense
    got = _counted(psd, lambda: psd.slab_copy(x, mode, depth))
    assert got.shape == (n, 8, 128)
    assert _max_err(got, psd.slab_copy_ref(x, mode)) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("shape", [(128, 128, 128), (3, 50, 64)])
def test_probe_lines_match_plain(shape, tiled):
    """Whole and ragged last blocks of 128 lines."""
    gen = _cuda_gen(14)
    x = torch.rand(shape, generator=gen, device="cuda")
    got = _counted(psd, lambda: psd.line_sums(x, tiled))
    assert _max_err(got, psd.line_sums_ref(x)) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("mode", list(kp.MODES))
def test_kernel_probe_matches_plain(mode):
    gen = _cuda_gen(15)
    n = 64
    temp4, rhs4, forc = kp.inputs(n, gen, torch.device("cuda"))
    got = _counted(kp, lambda: kp.probe(temp4, rhs4, forc, mode))
    want = kp.probe_ref(temp4, rhs4, forc, mode)
    if mode in ("dma", "full"):
        for g, w in zip(got, want):
            assert _max_err(g, w) == 0.0
        return
    thomas = kp.probe_ref(temp4, rhs4, forc, "comp")
    if mode == "pcr":
        assert _max_err(got, thomas) <= 1e-5 * max(
            1.0, float(thomas.abs().max()))
    else:
        assert _max_err(got, want) == 0.0
        assert _max_err(got, thomas) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("rounded", [True, False],
                         ids=["rounded", "contracted"])
@pytest.mark.parametrize("shape", [(16, 8, 128), (33, 17, 40), (1, 5, 7)])
def test_probe_diss_matches_plain(shape, rounded):
    gen = _cuda_gen(16)
    dev = torch.device("cuda")
    u, v, w = (pdb.common.uniform(shape, -1.0, 1.0, gen, dev)
               for _ in range(3))
    scal = pdb.inv2h()
    got = _counted(pdb, lambda: pdb.diss(u, v, w, scal, rounded))
    want = pdb.diss_ref(u, v, w, scal)
    tol = 0.0 if rounded else 1e-6 * max(1.0, float(want.abs().max()))
    assert _max_err(got, want) <= tol


def _rotated_baffle(axis, seed):
    """The FREE baffle (``geom.baffle.free_baffled`` at 24 x 20 x 18) with
    its wall turned normal to ``axis``: its dual plane along ``axis`` and
    noisy fields, on the card."""
    grid = free_baffled(24, 20, 18)
    perm = ((0, 1, 2), (1, 0, 2), (2, 1, 0))[axis]

    def turn(a):
        return np.ascontiguousarray(np.transpose(np.asarray(a), perm))

    types, bcv, bct = (turn(a) for a in (grid.types, grid.bc_vel,
                                         grid.bc_temp))
    lc = masks.line_class_3d(types, axis)
    assert lc.cls_b is not None

    def t(a, dtype=torch.int8):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                            device="cuda")

    cls = t(lc.cls_a)
    flags = dual_flags(cls, t(lc.cls_b), t(lc.take_b, torch.bool))
    rng = np.random.default_rng(seed)
    fields = [t(0.3 * rng.standard_normal((4,) + types.shape), torch.float32)
              for _ in range(3)]
    return (cls, t(bcv), t(bct)), fields, flags


def _edge_flags(rng, cls):
    """Random dual planes on random classes: the BC0 start role in pass B
    (bit 0) on some BC1 cells, the take bit (1) anywhere."""
    c = cls.cpu().numpy()
    dual = (c == 2) & (rng.random(c.shape) < 0.5)
    take = rng.random(c.shape) < 0.3
    return torch.tensor(dual + 2 * take, dtype=torch.int8, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("gmerge", [True, False])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_pair_kernel_dual_bitwise(axis, exact, gmerge):
    """The dual pair kernel against its plain version on the FREE baffle
    turned onto each axis."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    (cls, bcv, bct), (temp4, rhs4, op4), flags = _rotated_baffle(axis,
                                                                 3 + axis)
    args = (temp4, cls, bcv, bct, rhs4, op4, _PAIR_SCAL, axis, exact, gmerge,
            flags)
    before = (ps.launches.count, ps.dual_launches.count)
    out_k, tn_k = ps.pair_sweep(*args)
    assert (ps.launches.count, ps.dual_launches.count) == (before[0],
                                                           before[1] + 2)
    for g, w in zip((out_k, tn_k), ps.pair_sweep_ref(*args)):
        assert _max_err(g, w) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("shape, axis", _EDGE_3D)
def test_pair_kernel_dual_edges_bitwise(shape, axis, exact):
    """Ragged chunks and blocks of the dual instantiations' tiles (X/Y 64 x
    2, Z 64 x 8), random classes and dual planes, gmerge on."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(sum(shape) + 10 * axis + 7)
    (cls, bcv, bct), (temp4, rhs4, op4), _ = _edge_fields(rng, shape, 4)
    args = (temp4, cls, bcv, bct, rhs4, op4, _PAIR_SCAL, axis, exact, True,
            _edge_flags(rng, cls))
    before = ps.dual_launches.count
    out_k, tn_k = ps.pair_sweep(*args)
    assert ps.dual_launches.count == before + 2
    for g, w in zip((out_k, tn_k), ps.pair_sweep_ref(*args)):
        assert _max_err(g, w) == 0.0


# line lengths of the PCR kernel's tests: a warp holds a line as rows of 32
# cells (lane q: cells q + 32 j), levels s < 32 by shuffles and s = 32, 64,
# 128 in registers; n = 1 and 2 (one lane, one level), 31 / 32 / 33 (a
# lane row short, full, one past), 40, 65 and 129 (one past the register
# levels' boundaries), 200, 255 and the cap 256
_PCR_N = [1, 2, 31, 32, 33, 40, 65, 129, 200, 255, 256]


@pytest.mark.gpu
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("n", _PCR_N)
def test_pcr_kernel_bitwise(n, axis, dual, exact):
    """The PCR kernel against its plain version: lines of n cells along
    each axis (_PCR_N: every boundary of a warp's layout, 32 cells a row
    of lanes, and the cap 256), 55 lines in blocks of 8 (a ragged last
    block), random classes, with and without random dual planes; gmerge
    on X."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    shape = [5, 11]
    shape.insert(axis, n)
    rng = np.random.default_rng(n + 10 * axis + 100 * dual)
    (cls, bcv, bct), (temp4, rhs4, op4), _ = _edge_fields(rng, tuple(shape),
                                                          4)
    args = (temp4, cls, bcv, bct, rhs4, op4, _PAIR_SCAL, axis, exact,
            axis == 0, _edge_flags(rng, cls) if dual else None)
    before = pcs.launches.count
    out_k, tn_k = pcs.pcr_sweep(*args)
    assert pcs.launches.count == before + 2
    for g, w in zip((out_k, tn_k), pcs.pcr_sweep_ref(*args)):
        assert _max_err(g, w) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_pcr_kernel_baffle_bitwise(axis, exact):
    """PCR with the dual chains on the FREE baffle turned onto each axis."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    (cls, bcv, bct), (temp4, rhs4, op4), flags = _rotated_baffle(axis,
                                                                 9 + axis)
    args = (temp4, cls, bcv, bct, rhs4, op4, _PAIR_SCAL, axis, exact, True,
            flags)
    out_k, tn_k = pcs.pcr_sweep(*args)
    for g, w in zip((out_k, tn_k), pcs.pcr_sweep_ref(*args)):
        assert _max_err(g, w) == 0.0


def _from_rest(n=96):
    """The FREE baffle at n^3 from rest (zero velocity on its walls), 0.01
    noise on IN cells from a CUDA generator, on the card."""
    grid = free_baffled(n, n, n)
    ga = grid_arrays(grid, "cuda")
    pa = adi3d.make_params(FluidParams.normalized(200.0, 0.72, 1.4),
                           grid.dx, grid.dy, grid.dz)
    gen = torch.Generator(device="cuda").manual_seed(0)
    base = torch.stack(tuple(update_boundaries(init_state(grid, "cuda"),
                                               ga)))
    is_in = ga.types == NodeType.IN

    def noisy():
        return torch.where(is_in, base + 0.01 * torch.randn(
            base.shape, generator=gen, device="cuda"), base)

    return ga, pa, noisy(), noisy(), noisy()


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["pair", "pcr"])
@pytest.mark.parametrize("axis, exact", [(0, True), (1, False), (1, True),
                                         (2, False)])
def test_gmerge_subnormal_bitwise(kernel, axis, exact):
    """The gmerge fold rounds (tn + out) before halving it.  Contracted
    into an FMA with the NODE_IN merge's half, it parted both kernels from
    their plain versions by 1.4e-45 where that half is subnormal: 368 to
    33,488 cells of this input (96^3 from rest) for the pair kernel, more
    for PCR, whose decaying coefficients make subnormals of their own."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ga, pa, temp4, rhs4, op4 = _from_rest()
    flags = ga.dual_flags[axis]
    run, ref = ((ps.pair_sweep, ps.pair_sweep_ref) if kernel == "pair"
                else (pcs.pcr_sweep, pcs.pcr_sweep_ref))
    args = (temp4, ga.cls_a[axis], ga.bc_vel, ga.bc_temp, rhs4, op4,
            adi3d._nl_scal(axis, pa, 0.01), axis, exact, True, flags)
    for g, w in zip(run(*args), ref(*args)):
        assert _max_err(g, w) == 0.0


# the bf16 payload mode: the payloads rounded to bf16, each kernel's bf16
# entry against its plain version (upcast in, float32 arithmetic, rounded
# out) bit for bit, launches counted in the module's bf16 counters only
def _bf16(*ts):
    return tuple(t.bfloat16() for t in ts)


def _bf16_run(counters, n, fn):
    """fn()'s result, checking that it made n launches on the first of
    ``counters`` and none on the others."""
    before = [c.count for c in counters]
    out = fn()
    assert [c.count - b for c, b in zip(counters, before)] == \
        [n] + [0] * (len(counters) - 1)
    return out


def _bitwise(got, want):
    torch.cuda.synchronize()
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.dtype == w.dtype == torch.bfloat16
        assert bool(torch.isfinite(g.float()).all())
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("gmerge", [True, False])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("shape, axis", _EDGE_3D)
def test_pair_kernel_bf16_bitwise(shape, axis, exact, gmerge):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(sum(shape) + 10 * axis + 30)
    (cls, bcv, bct), (temp4, rhs4, op4), _ = _edge_fields(rng, shape, 4)
    args = (temp4, cls, bcv, bct, *_bf16(rhs4, op4), _PAIR_SCAL, axis, exact,
            gmerge)
    got = _bf16_run((ps.bf16_launches, ps.launches, ps.dual_bf16_launches),
                    2, lambda: ps.pair_sweep(*args))
    _bitwise(got, ps.pair_sweep_ref(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("shape, axis", _EDGE_3D)
def test_pair_kernel_dual_bf16_bitwise(shape, axis, exact):
    """The dual pair's bf16 mode on random classes and dual planes, gmerge
    on, and on the FREE baffle turned onto each axis."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(sum(shape) + 10 * axis + 31)
    (cls, bcv, bct), (temp4, rhs4, op4), _ = _edge_fields(rng, shape, 4)
    cases = [(temp4, cls, bcv, bct, *_bf16(rhs4, op4), _edge_flags(rng, cls))]
    if shape == _EDGE_3D[0][0]:
        (cls, bcv, bct), (temp4, rhs4, op4), flags = _rotated_baffle(axis, 5)
        cases.append((temp4, cls, bcv, bct, *_bf16(rhs4, op4), flags))
    for t4, c, bv, bt, r4, o4, fl in cases:
        args = (t4, c, bv, bt, r4, o4, _PAIR_SCAL, axis, exact,
                True, fl)
        got = _bf16_run((ps.dual_bf16_launches, ps.dual_launches,
                         ps.bf16_launches), 2, lambda: ps.pair_sweep(*args))
        _bitwise(got, ps.pair_sweep_ref(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("n", _PCR_N)
def test_pcr_kernel_bf16_bitwise(n, axis, dual, exact):
    """The PCR kernel's bf16 mode, shapes as test_pcr_kernel_bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    shape = [5, 11]
    shape.insert(axis, n)
    rng = np.random.default_rng(n + 10 * axis + 100 * dual + 1)
    (cls, bcv, bct), (temp4, rhs4, op4), _ = _edge_fields(rng, tuple(shape),
                                                          4)
    args = (temp4, cls, bcv, bct, *_bf16(rhs4, op4), _PAIR_SCAL, axis, exact,
            axis == 0, _edge_flags(rng, cls) if dual else None)
    got = _bf16_run((pcs.bf16_launches, pcs.launches), 2,
                    lambda: pcs.pcr_sweep(*args))
    _bitwise(got, pcs.pcr_sweep_ref(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("shape, axis", _EDGE_3D)
def test_stream_kernel_bf16_bitwise(shape, axis, exact):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(sum(shape) + 10 * axis + 32)
    (cls, bcv, bct), (temp4, rhs4, op4), forcing = _edge_fields(rng, shape,
                                                                4)
    args = (temp4, cls, bcv, bct, *_bf16(rhs4, op4), forcing, _PAIR_SCAL[:5],
            axis, exact)
    got = _bf16_run((ss.bf16_launches, ss.launches), 1,
                    lambda: ss.stream_sweep(*args))
    _bitwise(got, ss.stream_sweep_ref(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("shape, axis", [((37, 100), 0), ((100, 37), 1),
                                         ((256, 33), 0), ((33, 256), 1),
                                         ((5, 1024), 0), ((1024, 5), 1)])
def test_stream_sweep_2d_kernel_bf16_bitwise(shape, axis, exact, first):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(sum(shape) + 10 * axis + 33)
    (cls, _, bct), (temp3, rhs3, op3), forcing = _edge_fields(
        rng, shape, 3, segments_axis=axis)
    scal = np.array([30.0, 20.0, 1000.0, 250.0, 1.0], dtype=np.float32)
    args = (temp3, cls, bct, *_bf16(rhs3, op3), forcing, scal, axis, exact,
            first)
    got = _bf16_run((ss.bf16_launches, ss.launches), 1,
                    lambda: ss.stream_sweep_2d(*args))
    _bitwise(got, ss.stream_sweep_2d_ref(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("shape, axis", _LINE_EDGE_3D)
def test_line_sweep_kernel_bf16_bitwise(shape, axis, exact):
    """The line sweep's bf16 mode on the edges of its tiles; on Z also at
    each tile of Z_ROWS.  Odd lengths put bf16 rows on 2-byte
    boundaries."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    adv, pk, d4, scal = _line_case(shape, axis, 4, sum(shape) + 10 * axis + 3)
    d4 = d4.bfloat16()
    want = ls.line_sweep_ref(adv, pk, d4, scal, axis, exact)
    counters = (ls.bf16_launches, ls.launches)
    _bitwise(_bf16_run(counters, 1, lambda: ls.line_sweep(
        adv, pk, d4, scal, axis, exact)), want)
    for z_rows in (ls.Z_ROWS[1:] if axis == 2 else ()):
        _bitwise(_bf16_run(counters, 1, lambda: ls._launch(
            adv, pk, d4, scal, 2, 2, exact, z_rows)), want)


@pytest.mark.gpu
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("shape", [(23, 19), (300, 9), (9, 300), (1041, 37)])
def test_line_sweep_2d_kernel_bf16_bitwise(shape, axis, exact):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    adv, pk, d3, scal = _line_case(shape, axis, 3, sum(shape) + 10 * axis + 4)
    d3 = d3.bfloat16()
    got = _bf16_run((ls.bf16_launches, ls.launches), 1,
                    lambda: ls.line_sweep_2d(adv, pk, d3, scal, axis, exact))
    _bitwise(got, ls.line_sweep_2d_ref(adv, pk, d3, scal, axis, exact))


@pytest.mark.gpu
@pytest.mark.parametrize("payload", list(pcs.PAYLOADS))
@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("axis", [0, 2])
def test_pcr_kernel_no_spills(axis, exact, dual, payload):
    """Every PCR instantiation (X/Y and Z, both division modes, with and
    without duals, each payload type) keeps its chains in registers: no
    local memory, and two blocks an SM or more at n = 256."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    info = pcs.kernel_info(256, axis, exact, dual, payload)
    assert info["local_bytes"] == 0, info
    assert info["blocks_per_sm"] >= 2, info


def _at_offset(x, k):
    """x copied into a contiguous tensor that starts k elements past its
    allocation's start: k = 1 puts a bf16 tensor's rows on 2-byte
    boundaries where k = 0 puts them on 4-byte ones."""
    buf = torch.empty(x.numel() + k, dtype=x.dtype, device=x.device)
    v = buf[k:].view(x.shape)
    v.copy_(x)
    return v


# the bf16 loader's runs (tile.cuh): innermost lengths odd and even (so
# the variables' planes, fs apart, start on both word halves), rows not a
# multiple of any tile's R (partial chunks) and lines not of its L, on X,
# Y and Z
_LOADER_3D = [((37, 5, 33), 0), ((38, 4, 34), 0), ((5, 37, 33), 1),
              ((4, 38, 34), 1), ((5, 7, 45), 2), ((4, 6, 46), 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("entry", ["line", "pair", "dual_pair", "stream"])
@pytest.mark.parametrize("shape, axis", _LOADER_3D)
def test_bf16_loader_offsets_bitwise(shape, axis, entry, offset):
    """Each 3D bf16 entry whose bf16 planes go through the staged loader,
    with its bf16 inputs starting on each half of a 4-byte word; the line
    sweep on Z at each tile of Z_ROWS."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    seed = sum(shape) + 10 * axis + 40 + offset
    if entry == "line":
        adv, pk, d4, scal = _line_case(shape, axis, 4, seed)
        d4 = _at_offset(d4.bfloat16(), offset)
        want = ls.line_sweep_ref(adv, pk, d4, scal, axis, False)
        for z_rows in ((0,) + ls.Z_ROWS[1:] if axis == 2 else (0,)):
            _bitwise(_bf16_run((ls.bf16_launches, ls.launches), 1,
                               lambda: ls._launch(adv, pk, d4, scal, axis,
                                                  axis, False, z_rows)),
                     want)
        return
    rng = np.random.default_rng(seed)
    (cls, bcv, bct), (temp4, rhs4, op4), forcing = _edge_fields(rng, shape,
                                                                4)
    rb, ob = (_at_offset(t.bfloat16(), offset) for t in (rhs4, op4))
    if entry == "stream":
        args = (temp4, cls, bcv, bct, rb, ob, forcing, _PAIR_SCAL[:5], axis,
                True)
        _bitwise(_bf16_run((ss.bf16_launches, ss.launches), 1,
                           lambda: ss.stream_sweep(*args)),
                 ss.stream_sweep_ref(*args))
        return
    dual = entry == "dual_pair"
    args = (temp4, cls, bcv, bct, rb, ob, _PAIR_SCAL, axis, True, True) + (
        (_edge_flags(rng, cls),) if dual else ())
    counters = ((ps.dual_bf16_launches, ps.bf16_launches) if dual else
                (ps.bf16_launches, ps.dual_bf16_launches))
    _bitwise(_bf16_run(counters + (ps.launches,), 2,
                       lambda: ps.pair_sweep(*args)),
             ps.pair_sweep_ref(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("entry", ["line", "stream"])
@pytest.mark.parametrize("shape, axis", [((37, 33), 0), ((38, 34), 0),
                                         ((33, 45), 1), ((34, 46), 1)])
def test_bf16_loader_offsets_2d_bitwise(shape, axis, entry, offset):
    """The 2D bf16 line and stream entries, inputs on each half of a word:
    X with odd and even lines, Y (the transposing tile) with partial
    chunks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    seed = sum(shape) + 10 * axis + 50 + offset
    if entry == "line":
        adv, pk, d3, scal = _line_case(shape, axis, 3, seed)
        d3 = _at_offset(d3.bfloat16(), offset)
        _bitwise(_bf16_run((ls.bf16_launches, ls.launches), 1,
                           lambda: ls.line_sweep_2d(adv, pk, d3, scal, axis,
                                                    False)),
                 ls.line_sweep_2d_ref(adv, pk, d3, scal, axis, False))
        return
    rng = np.random.default_rng(seed)
    (cls, _, bct), (temp3, rhs3, op3), forcing = _edge_fields(
        rng, shape, 3, segments_axis=axis)
    scal = np.array([30.0, 20.0, 1000.0, 250.0, 1.0], dtype=np.float32)
    args = (temp3, cls, bct, *(_at_offset(t.bfloat16(), offset)
                               for t in (rhs3, op3)), forcing, scal, axis,
            False, False)
    _bitwise(_bf16_run((ss.bf16_launches, ss.launches), 1,
                       lambda: ss.stream_sweep_2d(*args)),
             ss.stream_sweep_2d_ref(*args))


_PLAIN_3D = {"pair_sweep": ps.pair_sweep_ref, "pcr_sweep": pcs.pcr_sweep_ref,
             "stream_sweep": ss.stream_sweep_ref,
             "line_sweep": ls.line_sweep_ref}


@pytest.mark.gpu
@pytest.mark.parametrize("backend, num_local, baffle", [
    ("fused_bf16", 2, False), ("fused_bf16", 3, False),
    ("fused_bf16", 2, True), ("fused_pcr_bf16", 2, False),
    ("fused_pcr_bf16", 2, True), ("fused_bf16", 1, True)])
def test_step_bf16_kernels_match_plain(backend, num_local, baffle,
                                       monkeypatch):
    """One whole step of each bf16 backend on the card with the bf16
    kernels against the same step with their plain versions, bit for bit:
    pair, pair+stream, the dual pair (the baffle at nl 2) and the fallback
    (the baffle at nl 1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ga, pa, cur, _, nxt = _case("cuda", seed=4, baffle=baffle)

    def step():
        new, _ = adi3d.adi_timestep_3d(
            tuple(cur), tuple(nxt), ga, 0.01, 2, num_local, pa,
            backend=backend, exact=False, compute_error=False,
            merge_ok=merge_ok(ga))
        return torch.stack(tuple(new))

    counters = (ps.bf16_launches, ps.dual_bf16_launches, pcs.bf16_launches,
                ss.bf16_launches, ls.bf16_launches)
    before = sum(c.count for c in counters)
    got = step()
    assert sum(c.count for c in counters) > before
    for name, ref in _PLAIN_3D.items():
        monkeypatch.setattr(adi3d, name, ref)
    want = step()
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all()) and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("exact", [True, False])
def test_step_2d_bf16_kernels_match_plain(exact, monkeypatch):
    """Two 2D ``fused_bf16`` steps on the card with the bf16 line sweep
    against the same steps with its plain version, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = lid_cavity_2d(48, 40, dx=0.01)
    ga = common2d.grid_arrays(g, "cuda")
    pa = adi2d.make_params(FluidParams.normalized(200.0, 0.72, 1.4), g.dx,
                           g.dy, 1.0)

    def steps():
        cur = common2d.init_state(g, "cuda")
        for _ in range(2):
            cur = common2d.update_boundaries(cur, ga)
            cur, _, _ = adi2d.adi_timestep_2d(cur, ga, 0.001, 2, 2, pa,
                                              backend="fused_bf16",
                                              exact=exact)
        return torch.stack(tuple(cur))

    before = ls.bf16_launches.count
    got = steps()
    assert ls.bf16_launches.count > before
    monkeypatch.setattr(adi2d, "line_sweep_2d", ls.line_sweep_2d_ref)
    want = steps()
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all()) and torch.equal(got, want)


def _row_step(dim, device, exact):
    """One ``scan`` step of the row path on ``device``: the 3D lid cavity
    of ``_case`` or the 2D lid cavity at 48 x 40, both with interior noise
    on normalized parameters; (fields on the host, err)."""
    if dim == 3:
        ga, pa, temp4, _, nxt4 = _case(device, seed=5)
        new, err = adi3d.adi_timestep_3d(tuple(temp4), tuple(nxt4), ga, 0.01,
                                         2, 2, pa, backend="scan",
                                         exact=exact, merge_ok=merge_ok(ga))
    else:
        g = lid_cavity_2d(48, 40, dx=0.01)
        ga = common2d.grid_arrays(g, device)
        pa = adi2d.make_params(FluidParams.normalized(200.0, 0.72, 1.4),
                               g.dx, g.dy, 1.0)
        cur = common2d.update_boundaries(common2d.init_state(g, device), ga)
        rng = np.random.default_rng(5)
        is_in = ga.types == NodeType.IN
        cur = common2d.State2D(*(torch.where(is_in, f + 0.1 * torch.tensor(
            rng.standard_normal(tuple(f.shape)), dtype=torch.float32,
            device=device), f) for f in cur))
        new, err, _ = adi2d.adi_timestep_2d(cur, ga, 0.001, 2, 2, pa,
                                            backend="scan", exact=exact)
    return torch.stack(tuple(new)).cpu(), float(err)


@pytest.mark.gpu
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("dim", [3, 2])
def test_row_step_card_equals_cpu(dim, exact):
    """The row path (``scan``: materialized rows, the tridiag_rows kernel
    on the card, its plain version on the CPU) gives the CPU's step bit for
    bit: the rows' advection term adv/(2h) is a correctly rounded quotient
    on both devices (``stencil.over``), as cmcfs_tpu's rows divide."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    (x_c, e_c), (x_g, e_g) = (_row_step(dim, d, exact)
                              for d in ("cpu", "cuda"))
    gap = [float((g - c).abs().max()) for g, c in zip(x_g, x_c)]
    assert torch.equal(x_g, x_c), f"max|card - cpu| per variable {gap}"
    assert abs(e_g - e_c) <= 1e-6 * abs(e_c)


def _split_runs(backend, baffle, plan):
    """Three steps of the 25 x 20 x 18 lid cavity (with the FREE baffle)
    on cuda:0 and over ``plan``: each run's (states on the host, errors,
    pair launches, dual pair launches included)."""
    from cmcfs_tpu_torch.models.solver3d import AdiSolver3D
    grid = lid_cavity_3d(25, 20, 18)
    if baffle:
        grid = _baffle(grid)
    runs = []
    for p in (None, plan):
        s = AdiSolver3D(backend=backend, device="cuda")
        s.init(grid, FluidParams.normalized(200.0, 0.72, 1.4))
        if p is not None:
            s.set_plan(p)
        before = ps.launches.count + ps.dual_launches.count
        states, errs = [], []
        for _ in range(3):
            s.update_boundaries()
            s.time_step(0.01, 2, 2)
            states.append(torch.stack(tuple(s.state()[0])).cpu())
            errs.append(s.last_err)
        torch.cuda.synchronize()
        runs.append((states, errs,
                     ps.launches.count + ps.dual_launches.count - before))
    (s1, e1, n1), (sn, en, nn) = runs
    for a, b in zip(s1, sn):
        assert torch.equal(a, b)
    for a, b in zip(e1, en):
        assert abs(a - b) <= 1e-6 * abs(a)
    assert nn == plan.n * n1


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [2, 3])
@pytest.mark.parametrize("backend, baffle", [("fused_nl", False),
                                             ("fused_dma", False),
                                             ("fused_nl", True)])
def test_sharded_step_bitwise(backend, baffle, shards):
    """Three steps split over X into ``shards`` shards on one card (the
    MGPU_EMU analogue: ``["cuda:0"] * shards``) give the unsharded steps'
    states bit for bit: the pair kernel on every direction (X resharded
    to Y slabs), the line sweep (``fused_dma``), and the dual pair kernel
    on the baffle's X lines; the pair kernel launches ``shards`` times as
    often, and the error agrees within 1e-6 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cmcfs_tpu_torch.parallel.mesh import make_x_mesh
    _split_runs(backend, baffle, make_x_mesh(devices=["cuda:0"] * shards))


@pytest.mark.gpu
@pytest.mark.parametrize("backend, baffle", [("fused_nl", False),
                                             ("fused_dma", False),
                                             ("fused_nl", True)])
def test_sharded_step_across_cards(backend, baffle):
    """The same over 2 up to 4 real cards (``make_x_mesh(n)``: halos and
    reshards copied between cards): bit for bit the single card's."""
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_cards < 2:
        pytest.skip(f"needs two or more CUDA devices, {n_cards} visible")
    from cmcfs_tpu_torch.parallel.mesh import make_x_mesh
    for n in range(2, min(n_cards, 4) + 1):
        _split_runs(backend, baffle, make_x_mesh(n))


def _carry_case(shape, k, seed):
    """Rows (n, Y, Z) with b about 6, k right-hand sides laid out as the
    3D X path lays them (the owned planes of a (4, n + 2, Y, Z) slab:
    d[j] planes (n + 2) Y Z apart), random carries of a block."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*s):
        return torch.randn(s, generator=g, device="cuda")

    n = shape[0]
    a, c = rnd(*shape), rnd(*shape)
    b = rnd(*shape) + 6.0
    d = rnd(4, n + 2, *shape[1:])[:k, 1:-1]
    return a, b, c, d


@pytest.mark.gpu
@pytest.mark.parametrize("shape, z0, nz", [((7, 5, 40), 8, 24),
                                           ((1, 3, 33), 0, 33),
                                           ((64, 17, 96), 80, 16)])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("last", [False, True])
def test_tridiag_carry_kernels_bitwise(shape, z0, nz, k, exact, last):
    """The wavefront's carry kernels (``ops/tridiag_carry.py``) against
    their plain versions bit for bit: one block of columns of rows with
    d strided as the X path gives it, from random carries; the columns
    outside the block are left alone; one launch a pass counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cmcfs_tpu_torch.ops import tridiag_carry as tc
    a, b, c, d = _carry_case(shape, k, seed=nz + k)
    g = torch.Generator(device="cuda").manual_seed(1)
    cin_c = torch.randn(shape[1:-1] + (nz,), generator=g, device="cuda")
    cin_d = torch.randn((k,) + shape[1:-1] + (nz,), generator=g,
                        device="cuda")
    xin = torch.randn_like(cin_d)
    outs = []
    before = tc.launches.count
    for fwd, bwd in ((tc.carry_fwd, tc.carry_bwd),
                     (tc.carry_fwd_ref, tc.carry_bwd_ref)):
        cp = torch.full_like(a, 7.0)
        dp = torch.full((k,) + shape, 7.0, device="cuda")
        x = torch.full_like(dp, 7.0)
        oc, od = fwd(a, b, c, d, cin_c, cin_d, cp, dp, z0, last, exact)
        ox = bwd(cp, dp, xin, x, z0)
        outs.append((cp, dp, oc, od, x, ox))
    torch.cuda.synchronize()
    assert tc.launches.count - before == 2
    for got, want in zip(*outs):
        assert torch.equal(got, want), float((got - want).abs().max())
    assert bool((outs[0][4][..., :z0] == 7.0).all())


def _wavefront_runs(plan, exact):
    """One ``scan`` step of the 25 x 20 x 18 lid cavity over ``plan``
    without and with ``blocking`` 4: each run's (state on the host, carry
    launches)."""
    from cmcfs_tpu_torch.models.solver3d import AdiSolver3D
    from cmcfs_tpu_torch.ops import tridiag_carry as tc
    grid = lid_cavity_3d(25, 20, 18)
    runs = []
    for nblockz in (0, 4):
        s = AdiSolver3D(backend="scan", exact=exact, device="cuda")
        s.init(grid, FluidParams.normalized(200.0, 0.72, 1.4))
        s.set_plan(plan, nblockz=nblockz)
        before = tc.launches.count
        s.update_boundaries()
        s.time_step(0.01, 2, 2)
        for d in set(s.plan.devices):
            torch.cuda.synchronize(d)
        runs.append((torch.stack(tuple(s.state()[0])).cpu(),
                     tc.launches.count - before))
    (x0, n0), (x4, n4) = runs
    assert torch.equal(x0, x4)
    # 18 Z columns in 3 blocks of 6 (the largest divisor of 18 up to 4)
    assert n0 == 0 and n4 == 2 * 2 * plan.n * 3 * 2 * 2


@pytest.mark.gpu
@pytest.mark.parametrize("shards, exact", [(2, True), (3, False)])
def test_wavefront_step_bitwise(shards, exact):
    """The split ``scan`` step with ``blocking`` 4 over shards emulated on
    one card: bit for bit the unblocked split's (X resharded), the carry
    kernels launched 2 x 2 passes x shards x blocks x nl x ng times."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cmcfs_tpu_torch.parallel.mesh import make_x_mesh
    _wavefront_runs(make_x_mesh(devices=["cuda:0"] * shards), exact)


@pytest.mark.gpu
@pytest.mark.parametrize("exact", [True, False])
def test_wavefront_step_across_cards(exact):
    """The same over 2 up to 4 real cards: the carry planes copied from
    card to card between the stages, bit for bit the unblocked split."""
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_cards < 2:
        pytest.skip(f"needs two or more CUDA devices, {n_cards} visible")
    from cmcfs_tpu_torch.parallel.mesh import make_x_mesh
    for n in range(2, min(n_cards, 4) + 1):
        _wavefront_runs(make_x_mesh(n), exact)
