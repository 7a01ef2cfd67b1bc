"""The port's line sweep against ``pallas_sweep_long.fused_sweep_long``
with ``chunk=8`` and the VMEM budget squeezed to 1 byte, as
tests/test_ops.py squeezes it: 21-cell X lines split into 3 chunks and the
ring falls to depth 2, so the first chunk's (c', d') round-trip through
the HBM staging.  Interpret mode on the CPU; one case, since its
interpreted chunk loops take ~25 s.  Inputs and tolerance as in
test_torch_line_sweep.py (1e-6 * max(1, max|x|)).
"""
import pytest

from cmcfs_tpu.ops import pallas_sweep_long as psl

from test_torch_line_sweep import _close, _inputs, _jax, _port


@pytest.mark.parametrize("axis, exact", [(0, True)])
def test_line_sweep_matches_pallas_long_staged(axis, exact, monkeypatch):
    monkeypatch.setattr(psl, "VMEM_BUDGET", 1)
    psl.fused_sweep_long.clear_cache()        # the budget is read at trace
    try:
        ins = _inputs((21, 6, 5), seed=5 + axis)
        want = _jax(lambda *a, **k: psl.fused_sweep_long(*a, chunk=8, **k),
                    *ins, axis, exact)
    finally:
        monkeypatch.undo()
        psl.fused_sweep_long.clear_cache()
    _close(_port(*ins, axis, exact), want)
