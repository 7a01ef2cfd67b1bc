"""The port's 2D ops against cmcfs_tpu's on the CPU: the 2D stencils (the
``div_error_2d`` precedence quirk included), the ``bc2d`` row forms, and
the materialized-row Thomas solve (``ops/tridiag_rows``'s plain version)
against ``pallas_tridiag.tridiag_pallas`` in interpret mode (as
tests/test_ops.py runs it) and against the ``scan`` backend, in both
``exact`` modes, at lengths and batches that are not multiples of the TPU
tiles.

Inputs are seeded with numpy and given to both packages.  Tolerances:
stencils and rows 1e-6 * max(1, max|ref|) (the same float32 expressions;
XLA may contract a mul-add into an FMA where eager PyTorch rounds twice);
the Thomas solves 1e-6 * max(1, max|x|) on diagonally dominant rows (the
same recurrence in the same order; ``scan`` against ``scan`` measured
bitwise).  The divergence error 1e-5 relative (a full-grid float32 sum
reduced in another order).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cmcfs_tpu.core.types import BCtype, NodeType
from cmcfs_tpu.models import common2d as jc2
from cmcfs_tpu.ops import stencil as jst
from cmcfs_tpu.ops import sweep_common as jsc
from cmcfs_tpu.ops import tridiag as jtd
from cmcfs_tpu.ops.masks import BC0, BC1, IDENTITY, INTERIOR
from cmcfs_tpu_torch.models import adi2d as tadi
from cmcfs_tpu_torch.ops import stencil as tst
from cmcfs_tpu_torch.ops import sweep_common as tsc
from cmcfs_tpu_torch.ops import tridiag as ttd
from cmcfs_tpu_torch.ops import tridiag_rows as tr

SHAPE2 = (23, 19)
DX, DY = np.float32(0.002), np.float32(0.0025)


def _close(got, want, tol=1e-6):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _fields(seed):
    rng = np.random.default_rng(seed)
    u, v = (rng.standard_normal(SHAPE2).astype(np.float32) for _ in range(2))
    types = rng.choice([NodeType.IN, NodeType.OUT, NodeType.BOUND], SHAPE2,
                       p=[0.8, 0.1, 0.1]).astype(np.int8)
    return u, v, types


@pytest.mark.parametrize("name", ["diss_x_2d", "diss_y_2d"])
def test_dissipation_2d(name):
    u, v, _ = _fields(1)
    got = getattr(tst, name)(torch.tensor(u), torch.tensor(v), DX, DY)
    want = getattr(jst, name)(jnp.asarray(u), jnp.asarray(v), DX, DY)
    _close(got, want)


def test_div_error_2d():
    u, v, types = _fields(2)
    got = tst.div_error_2d(torch.tensor(u), torch.tensor(v),
                           torch.tensor(types), DX, DY)
    want = jst.div_error_2d(jnp.asarray(u), jnp.asarray(v),
                            jnp.asarray(types), DX, DY)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - float(want)) <= 1e-5 * float(want)


def test_div_error_2d_keeps_precedence_quirk():
    """One all-IN quad: the metric is |dy*(u10-u00) + (u11-u01)/2 +
    dx*(v01-v00) + (v11-v10)/2|, not the mathematically intended form."""
    types = torch.full((2, 2), NodeType.IN, dtype=torch.int8)
    u = torch.tensor([[1.0, 2.0], [4.0, 8.0]])
    v = torch.tensor([[0.5, 1.5], [3.0, 7.0]])
    dx, dy = np.float32(0.5), np.float32(0.25)
    want = abs(dy * (4 - 1) + (8 - 2) / 2 + dx * (1.5 - 0.5) + (7 - 3) / 2)
    assert float(tst.div_error_2d(u, v, types, dx, dy)) == pytest.approx(
        want, rel=1e-6)
    empty = torch.full((2, 2), NodeType.OUT, dtype=torch.int8)
    assert float(tst.div_error_2d(u, v, empty, dx, dy)) == 0.0


def _masks(seed):
    rng = np.random.default_rng(seed)
    cls = rng.choice([IDENTITY, BC0, BC1, INTERIOR], SHAPE2).astype(np.int8)
    free = rng.integers(0, 2, SHAPE2).astype(bool)
    adv = (0.3 * rng.standard_normal(SHAPE2)).astype(np.float32)
    return cls, free, adv


@pytest.mark.parametrize("bc2d", [True, False])
def test_build_abc_row_forms(bc2d):
    """The 2D FREE rows are (1, -1 | +1, -1); the 3D ones (2, -1 | -1, 2)."""
    cls, free, adv = _masks(3 + bc2d)
    vis, b_int = np.float32(0.7), np.float32(31.4)
    got = tsc.build_abc(torch.tensor(cls), torch.tensor(free),
                        torch.tensor(adv), vis, b_int, bc2d=bc2d)
    want = jsc.build_abc(jnp.asarray(cls), jnp.asarray(free),
                         jnp.asarray(adv), vis, b_int, bc2d)
    for g, w in zip(got, want):
        _close(g, w)
    _close(tsc.build_a(torch.tensor(cls), torch.tensor(free),
                       torch.tensor(adv), vis, bc2d=bc2d),
           jsc.build_a(jnp.asarray(cls), jnp.asarray(free), jnp.asarray(adv),
                       vis, bc2d=bc2d))
    if bc2d:
        free_bc1 = torch.tensor((cls == BC1) & free)
        assert torch.all(got[0][free_bc1] == 1.0)
        assert torch.all(got[1][free_bc1] == -1.0)


def test_bc_rows_2d():
    """cmcfs_tpu's ``bc_rows_2d`` (b0, c0, d0, a1, b1, d1) against the rows
    the port's 2D row path builds on BC0 and BC1 cells (``build_abc`` with
    ``bc2d`` and ``adi2d._fold``)."""
    rng = np.random.default_rng(5)
    val = rng.standard_normal(SHAPE2).astype(np.float32)
    bct = rng.integers(0, 2, SHAPE2).astype(np.int8)
    b0, c0, d0, a1, b1, d1 = jc2.bc_rows_2d(jnp.asarray(val),
                                            jnp.asarray(bct))
    free = torch.tensor(bct) == BCtype.FREE
    adv = torch.tensor(rng.standard_normal(SHAPE2).astype(np.float32))
    d_int = torch.tensor(rng.standard_normal(SHAPE2).astype(np.float32))
    rows = {}
    for code in (BC0, BC1):
        cls = torch.full(SHAPE2, code, dtype=torch.int8)
        rows[code] = tsc.build_abc(cls, free, adv, np.float32(0.7),
                                   np.float32(31.4), bc2d=True) + (
            tadi._fold(cls, free, d_int, torch.tensor(val)),)
    for got, want in ((rows[BC0][1], b0), (rows[BC0][2], c0),
                      (rows[BC0][3], d0), (rows[BC1][0], a1),
                      (rows[BC1][1], b1), (rows[BC1][3], d1)):
        _close(got, want)
    assert torch.all(rows[BC0][0] == 0) and torch.all(rows[BC1][2] == 0)


def _rows(shape, seed):
    """Diagonally dominant rows with identity rows mixed in."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, shape).astype(np.float32)
    c = rng.uniform(-1, 1, shape).astype(np.float32)
    b = (np.abs(a) + np.abs(c) + rng.uniform(1, 3, shape)).astype(np.float32)
    d = rng.standard_normal(shape).astype(np.float32)
    ident = rng.random(shape) < 0.15
    a[ident], c[ident], b[ident] = 0, 0, 1
    return a, b, c, d


def _port(backend, rows, axis, exact):
    before = tr.launches.count
    x = ttd.tridiag_solve(*(torch.tensor(t) for t in rows), axis=axis,
                          exact=exact, backend=backend)
    assert tr.launches.count == before        # CPU tensors: plain version
    return x


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("shape", [(19, 200), (37, 3, 41)])
def test_pallas_backend_matches_tridiag_pallas(shape, exact):
    from jax.experimental.pallas import tpu as pltpu
    from cmcfs_tpu.ops.pallas_tridiag import tridiag_pallas
    rows = _rows(shape, seed=len(shape) + 2 * exact)
    with pltpu.force_tpu_interpret_mode():
        want = tridiag_pallas(*(jnp.asarray(t) for t in rows), exact=exact,
                              n_tile=8, s_tile=8)
    _close(_port("pallas", rows, 0, exact), want)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_scan_backend_matches_scan(axis, exact):
    rows = _rows((13, 11, 9), seed=7 + axis)
    want = jtd.tridiag_solve(*(jnp.asarray(t) for t in rows), axis=axis,
                             exact=exact, backend="scan")
    _close(_port("scan", rows, axis, exact), want)


def test_backends_differ_only_in_row0_reciprocal():
    """exact=True: scan and pallas are the same solve; exact=False: row 0
    divides under scan and multiplies by its reciprocal under pallas."""
    rows = _rows((17, 50), seed=11)
    assert torch.equal(_port("scan", rows, 0, True),
                       _port("pallas", rows, 0, True))
    t = [torch.tensor(r) for r in rows]
    want = tr.tridiag_rows_ref(*t, exact=False, recip_row0=True)
    assert torch.equal(_port("pallas", rows, 0, False), want)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "axis",
                                 "device"])
def test_tridiag_rows_checks_inputs(bad):
    a, b, c, d = (torch.tensor(t) for t in _rows((9, 7), seed=1))
    axis = 0
    if bad == "dtype":
        a = a.double()
    elif bad == "shape":
        c = c[:, :5]
    elif bad == "contiguous":
        d = d.t().contiguous().t()
    elif bad == "axis":
        axis = 2
    else:
        b = b.to("meta")
    with pytest.raises((TypeError, ValueError)):
        tr.tridiag_rows(a, b, c, d, axis=axis)


def test_tridiag_rows_no_fallback_off_cpu():
    meta = [torch.tensor(t).to("meta") for t in _rows((9, 7), seed=2)]
    with pytest.raises(RuntimeError, match="no kernel"):
        tr.tridiag_rows(*meta)


@pytest.mark.parametrize("exact", [True, False])
def test_pcr_backend_raises(exact):
    """Backend ``pcr`` used to raise; it is ported (``ops/pcr.py``, no
    kernel launched) and matches cmcfs_tpu's ``_solve_leading_axis_pcr``
    within the tolerance of this module's Thomas solves."""
    rows = _rows((9, 7), seed=3)
    want = jtd._solve_leading_axis_pcr(*(jnp.asarray(t) for t in rows),
                                       exact)
    _close(_port("pcr", rows, 0, exact), want)
