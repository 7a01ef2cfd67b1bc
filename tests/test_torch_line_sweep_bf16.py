"""The line sweep's bf16 payload mode against cmcfs_tpu's, on the CPU.

* 3D: the port's line sweep with a bf16 d4 against
  ``pallas_sweep_dma.fused_sweep_dma`` with the same bf16 d4 (interpret
  mode), on test_torch_line_sweep.py's random classes, BC codes and
  right-hand sides: X exact, Z reciprocal (through the 1<->2 swap).
* 2D, a line over 288 cells: the 2D ``fused_bf16`` solve of X lines of
  320 cells (``models/adi2d._build_and_solve``: the folded d3 rounded to
  bf16, the line sweep, x upcast) against cmcfs_tpu's, which runs
  ``pallas_sweep_long.fused_sweep_long`` there (adi2d.py:123-134), on the
  320 x 160 lid cavity of test_backends2d.py with seeded noise and
  normalized parameters.

Every cell equal or one bf16 ulp apart (tests/torch_bf16.py); measured:
3D no cell differs; 2D 3 cells of u and 1 of v of 51,200 one ulp apart,
T none.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmcfs_tpu.models import adi2d as jadi2
from cmcfs_tpu.ops.pallas_sweep_dma import fused_sweep_dma
from cmcfs_tpu_torch.models import adi2d as tadi2
from cmcfs_tpu_torch.models.common2d import from_jax_numpy
from cmcfs_tpu_torch.ops import line_sweep as ls
from cmcfs_tpu_torch.ops.sweep_common import pack_masks

from test_torch_line_sweep import SCAL, _inputs
from test_torch_slice2d import PARAMS
from test_torch_stream_sweep2d import setup_case
from torch_bf16 import assert_one_ulp


@pytest.mark.parametrize("axis, exact", [(0, True), (2, False)])
def test_line_sweep_bf16_matches_pallas_dma(axis, exact):
    adv, cls, bcv, bct, d4 = _inputs((13, 11, 10), seed=20 + axis)
    args = [jnp.asarray(a) for a in (adv, cls, bcv, bct)]
    d = jnp.asarray(d4).astype(jnp.bfloat16)
    if axis == 2:
        args = [jnp.swapaxes(a, 1, 2) for a in args]
        d = jnp.swapaxes(d, 2, 3)
    x = fused_sweep_dma(*args, d, jnp.asarray(SCAL), sweep_axis=min(axis, 1),
                        exact=exact)
    assert x.dtype == jnp.bfloat16
    x = np.asarray((jnp.swapaxes(x, 2, 3) if axis == 2 else x).astype(
        jnp.float32))
    pk = pack_masks(*(torch.tensor(m) for m in (cls, bcv, bct)))
    before = ls.bf16_launches.count
    got = ls.line_sweep(torch.tensor(adv), pk,
                        torch.tensor(d4).bfloat16(), SCAL, axis, exact)
    assert ls.bf16_launches.count == before     # CPU tensors: plain version
    assert got.dtype == torch.bfloat16
    assert_one_ulp(got, x, "x")


def test_line_sweep_2d_bf16_long_lines_match_pallas_long():
    ga, pa, temp3, rhs3, _ = setup_case(seed=3, nx=320, ny=160, noise=0.01,
                                        params=PARAMS)
    cur, temp = (jadi2.State2D(*(jnp.asarray(f) for f in a))
                 for a in (rhs3, temp3))
    want = jadi2._build_and_solve(0, cur, temp, ga, jnp.float32(0.001), pa,
                                  "fused_bf16", False)
    st, tga, tpa = from_jax_numpy(tuple(temp3), ga, pa, "cpu")
    tcur = tadi2.State2D(*(torch.tensor(f) for f in rhs3))
    got = tadi2._build_and_solve(0, tcur, st, tga, np.float32(0.001), tpa,
                                 "fused_bf16", False)
    assert tga.cls_x.shape[0] == 320 > 288
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert_one_ulp(g, np.asarray(w), "x")


@pytest.mark.parametrize("bad", ["adv", "d"])
def test_line_sweep_bf16_checks_inputs(bad):
    """d is float32 or bf16; adv stays float32."""
    adv, cls, bcv, bct, d4 = (torch.tensor(a)
                              for a in _inputs((9, 7, 5), seed=1))
    pk = pack_masks(cls, bcv, bct)
    if bad == "adv":
        adv, d4 = adv.bfloat16(), d4.bfloat16()
    else:
        d4 = d4.double()
    with pytest.raises(TypeError):
        ls.line_sweep(adv, pk, d4, SCAL, 0, True)
