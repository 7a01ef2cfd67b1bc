"""The port's ops (cmcfs_tpu_torch.ops) against cmcfs_tpu on identical
seeded inputs, on the CPU.

Tolerances: both sides compute in float32.  Elementwise stencils and row
builds round the same operations in the same order, but XLA may contract
a mul-add into an FMA where eager PyTorch rounds twice (PARITY.md 7), so
each op is held to <= 1e-6 absolute on O(1) inputs.  The Thomas solve
runs the same recurrence in the same order: <= 1e-6 absolute on
diagonally dominant rows with O(1) solutions.  The divergence metric is a
full-grid float32 sum reduced in another order: <= 1e-4 relative.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cmcfs_tpu.ops import stencil as jst
from cmcfs_tpu.ops import sweep_common as jsc
from cmcfs_tpu.ops import tridiag as jtd
from cmcfs_tpu.ops.masks import BC0, BC1, IDENTITY, INTERIOR
from cmcfs_tpu_torch.ops import stencil as tst
from cmcfs_tpu_torch.ops import sweep_common as tsc
from cmcfs_tpu_torch.ops import tridiag as ttd

SHAPE = (12, 10, 9)
H = (np.float32(0.013), np.float32(0.011), np.float32(0.017))
ATOL = 1e-6


def _fields(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(SHAPE).astype(np.float32) for _ in range(n)]


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_d1(axis):
    (f,) = _fields(1)
    # the derivative divides O(1) differences by 2h ~ 0.03: O(100) values,
    # so the bound scales with them (one ulp of the quotient)
    out = tst.d1(torch.tensor(f), H[axis], axis)
    ref = jst.d1(jnp.asarray(f), jnp.float32(H[axis]), axis)
    _close(out, ref, atol=ATOL * float(np.abs(np.asarray(ref)).max()))


@pytest.mark.parametrize("name", ["diss_x_3d", "diss_y_3d", "diss_z_3d"])
def test_dissipation(name):
    u, v, w = (0.01 * f for f in _fields(3, seed=1))
    out = getattr(tst, name)(*(torch.tensor(f) for f in (u, v, w)), *H)
    ref = getattr(jst, name)(*(jnp.asarray(f) for f in (u, v, w)),
                             *(jnp.float32(h) for h in H))
    _close(out, ref, atol=ATOL * max(1.0, float(np.abs(np.asarray(ref)).max())))


def test_div_error_3d():
    u, v, w = _fields(3, seed=2)
    types = np.random.default_rng(3).integers(0, 4, SHAPE).astype(np.int8)
    out = float(tst.div_error_3d(*(torch.tensor(f) for f in (u, v, w)),
                                 torch.tensor(types), *H))
    ref = float(jst.div_error_3d(*(jnp.asarray(f) for f in (u, v, w)),
                                 jnp.asarray(types),
                                 *(jnp.float32(h) for h in H)))
    assert ref > 0
    assert abs(out - ref) <= 1e-4 * ref


def _rows(seed, n=40, batch=(7, 5)):
    """Diagonally dominant rows with identity and boundary blocks."""
    rng = np.random.default_rng(seed)
    shape = (n,) + batch
    a = rng.uniform(-1, 1, shape).astype(np.float32)
    c = rng.uniform(-1, 1, shape).astype(np.float32)
    b = (np.abs(a) + np.abs(c) + rng.uniform(1, 3, shape)).astype(np.float32)
    d = rng.standard_normal(shape).astype(np.float32)
    ident = rng.random(shape) < 0.15
    a[ident] = 0
    c[ident] = 0
    b[ident] = 1
    return a, b, c, d


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_tridiag_solve(exact, axis):
    a, b, c, d = (np.moveaxis(x, 0, axis) for x in _rows(4 + axis))
    out = ttd.tridiag_solve(*(torch.tensor(x) for x in (a, b, c, d)),
                            axis=axis, exact=exact)
    ref = jtd.tridiag_solve(*(jnp.asarray(x) for x in (a, b, c, d)),
                            axis=axis, exact=exact, backend="scan")
    _close(out, ref)


def test_tridiag_last_c_ignored():
    """The reference zeroes c[n-1] (Algorithms.h:23): its value is unused."""
    a, b, c, d = _rows(9)
    x0 = ttd.tridiag_solve(*(torch.tensor(t) for t in (a, b, c, d)))
    c[-1] = 123.0
    x1 = ttd.tridiag_solve(*(torch.tensor(t) for t in (a, b, c, d)))
    assert torch.equal(x0, x1)


def _masks(seed):
    rng = np.random.default_rng(seed)
    cls = rng.choice([IDENTITY, BC0, BC1, INTERIOR], SHAPE).astype(np.int8)
    bcv = rng.integers(0, 2, SHAPE).astype(np.int8)
    bct = rng.integers(0, 2, SHAPE).astype(np.int8)
    return cls, bcv, bct


@pytest.mark.parametrize("free_bit", [0, 1])
def test_build_abc(free_bit):
    cls, bcv, bct = _masks(5)
    free = (bcv if free_bit == 0 else bct) == 1
    (adv,) = _fields(1, seed=6)
    vis, b_int = np.float32(0.37), np.float32(12.5)
    out = tsc.build_abc(torch.tensor(cls), torch.tensor(free),
                        torch.tensor(adv), vis, b_int)
    ref = jsc.build_abc(jnp.asarray(cls), jnp.asarray(free),
                        jnp.asarray(adv), vis, b_int, bc2d=False)
    for o, r in zip(out, ref):
        _close(o, r, atol=0)
    _close(tsc.build_a(torch.tensor(cls), torch.tensor(free),
                       torch.tensor(adv), vis),
           jsc.build_a(jnp.asarray(cls), jnp.asarray(free),
                       jnp.asarray(adv), vis), atol=0)


def test_pack_decode_masks():
    cls, bcv, bct = _masks(7)
    pk = tsc.pack_masks(*(torch.tensor(m) for m in (cls, bcv, bct)))
    _close(pk, jsc.pack_masks(*(jnp.asarray(m) for m in (cls, bcv, bct))),
           atol=0)
    for got, want in zip(tsc.decode_pk(pk), (cls, bcv, bct)):
        assert np.array_equal(got.numpy(), want.astype(np.float32))
