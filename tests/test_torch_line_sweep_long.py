"""The port's line sweep against ``pallas_sweep_long.fused_sweep_long``,
the TPU kernel for lines longer than 288 cells, in interpret mode on the
CPU (ROADMAP B3's test).  Inputs and tolerance as in
test_torch_line_sweep.py (1e-6 * max(1, max|x|)).

* Lines of 300 cells, past the 288-cell cap of the VMEM-resident kernels,
  on X and Y, both ``exact`` modes, at the kernel's own chunking.
* The chunked kernel's HBM staging: test_torch_line_sweep_staged.py.
"""
import pytest

from cmcfs_tpu.ops import pallas_sweep_long as psl

from test_torch_line_sweep import _close, _inputs, _jax, _port


@pytest.mark.parametrize("axis, exact", [(0, True), (1, False)])
def test_line_sweep_matches_pallas_long_300(axis, exact):
    shape = (300, 3, 5) if axis == 0 else (3, 300, 5)
    ins = _inputs(shape, seed=7 + axis)
    _close(_port(*ins, axis, exact),
           _jax(psl.fused_sweep_long, *ins, axis, exact))
