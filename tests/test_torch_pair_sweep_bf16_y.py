"""The pair sweep's bf16 payload mode against cmcfs_tpu's on the Y
direction, exact Thomas (X with the gmerge fold, the rounding points and
the input checks: test_torch_pair_sweep_bf16.py; Z:
test_torch_pair_sweep_bf16_z.py), against
``adi3d._solve_nl_fused(..., bf16=True)`` in interpret mode, within one
bf16 ulp a cell (tests/torch_bf16.py).  Measured: no cell differs.
"""
from cmcfs_tpu_torch.ops import pair_sweep as ps

from test_torch_pair_sweep_bf16 import check_pair


def test_pair_sweep_bf16_matches_pallas_pair_kernel_y():
    check_pair(ps.pair_sweep, ps.bf16_launches, 1, True, False)
