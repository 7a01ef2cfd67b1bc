"""The port's line sweep (cmcfs_tpu_torch.ops.line_sweep) against the TPU
kernels it replaces, run in interpret mode on the CPU as the JAX package's
own tests run them: ``pallas_sweep_dma.fused_sweep_dma`` and
``pallas_sweep.fused_sweep`` here, ``pallas_sweep_long.fused_sweep_long``
in test_torch_line_sweep_long.py (its interpreted chunk loops are slow).

Inputs are seeded with numpy: random line classes and BC codes (FREE rows
included), a small advection field and O(1) right-hand sides.  Lengths
are not multiples of 8 (the TPU kernels pad with identity rows, the port
runs the true length), every axis is swept (Z through the 1<->2 swap, as
adi3d does), in both ``exact`` modes.

Tolerance 1e-6 * max(1, max|x|): the same row build and recurrence in the
same order on both sides; XLA may contract a mul-add into an FMA where
eager PyTorch rounds twice (PARITY.md 7).  Measured 0 or a few ulps.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cmcfs_tpu.ops.masks import BC0, BC1, IDENTITY, INTERIOR
from cmcfs_tpu.ops.pallas_sweep import fused_sweep
from cmcfs_tpu.ops.pallas_sweep_dma import fused_sweep_dma
from cmcfs_tpu_torch.ops import line_sweep as ls
from cmcfs_tpu_torch.ops.sweep_common import pack_masks

SCAL = np.array([0.5, 0.7, 30.0, 5.0], dtype=np.float32)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    cls = rng.choice([IDENTITY, BC0, BC1, INTERIOR], shape,
                     p=[0.1, 0.1, 0.1, 0.7]).astype(np.int8)
    bcv = rng.integers(0, 2, shape).astype(np.int8)
    bct = rng.integers(0, 2, shape).astype(np.int8)
    adv = (0.2 * rng.standard_normal(shape)).astype(np.float32)
    d4 = rng.standard_normal((4,) + shape).astype(np.float32)
    return adv, cls, bcv, bct, d4


def _jax(kernel, adv, cls, bcv, bct, d4, axis, exact, **kw):
    """cmcfs_tpu's call convention (adi3d.py:280-303): Z swaps 1<->2."""
    args = [jnp.asarray(a) for a in (adv, cls, bcv, bct)]
    d = jnp.asarray(d4)
    if axis == 2:
        args = [jnp.swapaxes(a, 1, 2) for a in args]
        d = jnp.swapaxes(d, 2, 3)
    x = kernel(*args, d, jnp.asarray(SCAL), sweep_axis=min(axis, 1),
               exact=exact, **kw)
    return np.asarray(jnp.swapaxes(x, 2, 3) if axis == 2 else x)


def _port(adv, cls, bcv, bct, d4, axis, exact):
    pk = pack_masks(*(torch.tensor(m) for m in (cls, bcv, bct)))
    before = ls.launches.count
    x = ls.line_sweep(torch.tensor(adv), pk, torch.tensor(d4), SCAL, axis,
                      exact)
    assert ls.launches.count == before      # CPU tensors: plain version
    return x.numpy()


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * max(1.0, float(np.abs(want).max())))


KERNELS = {"dma": fused_sweep_dma, "blockspec": fused_sweep}


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("kernel", ["dma", "blockspec"])
def test_line_sweep_matches_pallas(kernel, axis, exact):
    ins = _inputs((13, 11, 10), seed=axis + 3 * exact)
    _close(_port(*ins, axis, exact), _jax(KERNELS[kernel], *ins, axis, exact))


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "scal",
                                 "axis"])
def test_line_sweep_checks_inputs(bad):
    adv, cls, bcv, bct, d4 = (torch.tensor(a)
                              for a in _inputs((9, 7, 5), seed=1))
    pk, scal, axis = pack_masks(cls, bcv, bct), SCAL, 0
    if bad == "dtype":
        pk = pk.to(torch.int32)
    elif bad == "shape":
        d4 = d4[:3]
    elif bad == "contiguous":
        d4 = d4.transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "scal":
        scal = scal[:3]
    else:
        axis = 3
    with pytest.raises((TypeError, ValueError)):
        ls.line_sweep(adv, pk, d4, scal, axis, True)


def test_line_sweep_no_fallback_off_cpu():
    """Tensors on a device other than the CPU never take the plain version:
    a device with no kernel raises."""
    adv, cls, bcv, bct, d4 = (torch.tensor(a)
                              for a in _inputs((9, 7, 5), seed=2))
    meta = [t.to("meta") for t in (adv, pack_masks(cls, bcv, bct), d4)]
    with pytest.raises(RuntimeError, match="no kernel"):
        ls.line_sweep(*meta, SCAL, 1, True)
