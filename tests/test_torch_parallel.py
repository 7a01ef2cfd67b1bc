"""The port's 3D step split over X (``parallel/mesh.py``,
``AdiSolver3D.set_plan``) against its single-device step, on CPU shards.

The CPU counterpart of cmcfs_tpu's virtual-mesh tests (the MGPU_EMU
analogue): ``make_x_mesh(devices=["cpu"] * N)`` runs N shards in one
process.  Each case runs two steps of a small grid on one device and over
N shards from the same state; the fields must be bit for bit
(``torch.equal``) and the divergence error within 1e-6 relative (its sums
run in another order over the shards).  Covered: every solver path
(``fused_nl`` at nl 2 and 4, ``fused_dma``, ``fused``, ``fused_full``,
``scan``, ``pallas``, ``pcr``, ``fused_pcr``, ``fused_bf16``,
``fused_pcr_bf16``), the FREE baffle's dual endpoints (X lines stitched
across the reshard), X extents that do not divide by N, and the balanced
cuts (``EVEN_SEGMENTS``, ``EVEN_VOLUME``) on a grid whose padding lands
mid-domain.  At nl=3 X leaves the pair kernel under a split, as cmcfs_tpu
dispatches it; that case is held to cmcfs_tpu's bound for it
(tests/test_parallel.py:122).
"""
import numpy as np
import pytest
import torch

from cmcfs_tpu_torch.core.params import FluidParams
from cmcfs_tpu_torch.geom.baffle import free_baffled
from cmcfs_tpu_torch.geom.grid3d import Grid3D
from cmcfs_tpu_torch.geom.synthetic import lid_cavity_3d
from cmcfs_tpu_torch.models.solver3d import AdiSolver3D
from cmcfs_tpu_torch.parallel.mesh import make_x_mesh

STEPS = 2


def twin_cavity(nx1=13, nx2=14, ny=14, nz=12) -> Grid3D:
    """Two lid cavities side by side along X: their OUT borders meet
    mid-domain, where balanced padding may insert planes."""
    a, b = lid_cavity_3d(nx1, ny, nz), lid_cavity_3d(nx2, ny, nz)
    g = Grid3D(nx1 + nx2, ny, nz, a.dx, a.dy, a.dz, a.base_T)
    for name in ("types", "bc_vel", "bc_temp", "vel", "T"):
        setattr(g, name, np.concatenate([getattr(a, name),
                                         getattr(b, name)]))
    g.bbox_min, g.bbox_max = a.bbox_min, a.bbox_max
    g.num_frames, g.cycle_len = 1, 1.0
    return g


GRIDS = {
    "lid": lambda: lid_cavity_3d(18, 16, 14),
    "lid17": lambda: lid_cavity_3d(17, 15, 13),
    "baffle": lambda: free_baffled(20, 18, 16),
    "lid53": lambda: lid_cavity_3d(53, 12, 10),
    "twin": twin_cavity,
}


def run(grid, backend, num_local, shards=1, balance=None, steps=STEPS):
    """``steps`` steps from the grid's initial state: (each step's state
    stacked, each step's error, the solver)."""
    s = AdiSolver3D(backend=backend, device="cpu")
    s.init(grid, FluidParams.normalized(200.0, 0.72, 1.4))
    if shards > 1:
        s.set_plan(make_x_mesh(devices=["cpu"] * shards), balance=balance)
    states, errs = [], []
    for _ in range(steps):
        s.update_boundaries()
        s.time_step(0.01, 2, num_local)
        states.append(torch.stack(tuple(s.state()[0])))
        errs.append(s.last_err)
    return states, errs, s


CASES = [
    ("lid", "fused_nl", 2, 2, None), ("lid", "fused_nl", 2, 3, None),
    ("lid", "fused_nl", 2, 4, None), ("lid", "fused_nl", 4, 3, None),
    ("lid17", "fused_dma", 2, 3, None), ("lid", "fused", 2, 2, None),
    ("lid17", "fused_full", 2, 4, None), ("lid", "scan", 2, 2, None),
    ("lid17", "pallas", 2, 3, None), ("lid", "pcr", 2, 4, None),
    ("lid17", "fused_pcr", 2, 2, None), ("lid", "fused_bf16", 2, 3, None),
    ("lid17", "fused_pcr_bf16", 2, 4, None),
    ("lid", "fused_nl", 1, 2, None),
    ("baffle", "fused_nl", 2, 2, None), ("baffle", "fused_nl", 2, 3, None),
    ("baffle", "fused_dma", 2, 4, None), ("baffle", "scan", 2, 3, None),
    ("baffle", "fused_bf16", 2, 2, None),
    ("lid53", "fused_nl", 2, 4, None), ("lid53", "scan", 2, 3, None),
    ("twin", "fused_nl", 2, 4, "EVEN_SEGMENTS"),
    ("twin", "fused_dma", 2, 4, "EVEN_VOLUME"),
    ("twin", "scan", 2, 2, "EVEN_VOLUME"),
    ("lid17", "fused_nl", 2, 3, "EVEN_X"),
]


@pytest.mark.parametrize("grid, backend, num_local, shards, balance", CASES)
def test_sharded_step_bitwise(grid, backend, num_local, shards, balance):
    g = GRIDS[grid]()
    one, e1, s1 = run(g, backend, num_local)
    split, en, sn = run(g, backend, num_local, shards, balance)
    assert sn.plan.n == shards and sum(sn.x_cuts) == g.dimx
    for a, b in zip(one, split):
        assert torch.equal(a, b), float((a - b).abs().max())
    for a, b in zip(e1, en):
        assert abs(a - b) <= 1e-6 * abs(a)
    if grid == "baffle":
        assert sn.ga.duals[0] and all(g.cls_b[0] is not None
                                      for g in sn.ga.y)


def test_balanced_padding_cuts_mid_domain():
    """``EVEN_SEGMENTS`` puts the twin cavity's padding plane mid-domain,
    beside the OUT planes where the cavities meet, so the second shard
    owns one plane fewer; the trailing padding shortens the last."""
    g = twin_cavity()
    _, _, s = run(g, "fused_nl", 2, 4, "EVEN_SEGMENTS", steps=0)
    out = np.nonzero((s.padded_types == 1).all(axis=(1, 2)))[0]
    assert s.padded_types.shape[0] == 28
    assert list(out) == [0, 12, 13, 14, 27]
    assert s.x_cuts == [7, 6, 7, 7]
    _, _, s = run(g, "fused_nl", 2, 4, steps=0)
    assert s.x_cuts == [7, 7, 7, 6]


def test_nl3_x_falls_back_under_a_plan():
    """At nl=3 X runs the fallback (the line sweep) under a split, where
    one device runs pair+stream (cmcfs_tpu adi3d.py:467-471): held to the
    single device's step at cmcfs_tpu's bound for that case,
    rtol 2e-5, atol 1e-6 (tests/test_parallel.py:122)."""
    g = lid_cavity_3d(18, 16, 14)
    one, e1, s1 = run(g, "fused_nl", 3)
    split, en, sn = run(g, "fused_nl", 3, 2)
    assert s1.dispatch_report(3)["dirs"]["X"] == "pair+stream"
    assert sn.dispatch_report(3)["dirs"] == {
        "X": "fallback", "Y": "pair+stream", "Z": "pair+stream"}
    for a, b in zip(one, split):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-5,
                                   atol=1e-6)
    for a, b in zip(e1, en):
        assert abs(a - b) <= 1e-6 * abs(a)


def test_state_round_trip_and_update_boundaries():
    """``set_state`` / ``state`` give back the whole grid's fields, and the
    split ``update_boundaries`` equals the single device's."""
    g = lid_cavity_3d(17, 15, 13)
    _, _, s1 = run(g, "fused_nl", 2, steps=1)
    _, _, s3 = run(g, "fused_nl", 2, 3, steps=0)
    rng = np.random.default_rng(0)
    cur = rng.standard_normal((4,) + g.types.shape).astype(np.float32)
    nxt = rng.standard_normal((4,) + g.types.shape).astype(np.float32)
    for s in (s1, s3):
        s.set_state(cur, nxt)
        s.update_boundaries()
    for a, b in zip(s1.state(), s3.state()):
        assert torch.equal(torch.stack(tuple(a)), torch.stack(tuple(b)))
