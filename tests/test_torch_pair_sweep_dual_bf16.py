"""The dual pair sweep's bf16 payload mode against cmcfs_tpu's: the FREE
baffle's X direction (test_torch_pair_sweep_dual.py's grid, its dual
plane) with the gmerge fold, reciprocal Thomas, against
``adi3d._solve_nl_fused(..., bf16=True)`` with ``cls_b``/``take_b`` in
interpret mode, within one bf16 ulp a cell (tests/torch_bf16.py).
Measured: no cell differs (9,216 cells of out and of tn).
"""
from cmcfs_tpu_torch.ops import pair_sweep as ps

from test_torch_pair_sweep_bf16 import check_pair


def test_dual_pair_sweep_bf16_matches_pallas_pair_kernel():
    check_pair(ps.pair_sweep, ps.dual_bf16_launches, 0, False, True,
               baffle=True)
