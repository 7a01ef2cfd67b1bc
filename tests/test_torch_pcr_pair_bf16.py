"""The PCR pair sweep's bf16 payload mode (backend ``fused_pcr_bf16``)
against cmcfs_tpu's Pallas pair kernel with ``pcr=True, bf16=True``
(``adi3d._solve_nl_fused``, interpret mode) on each axis of
test_torch_pair_sweep.py's lid cavity: X exact with the gmerge fold, Y
and Z reciprocal; within one bf16 ulp a cell (tests/torch_bf16.py).
Measured: X and Z no cell differs; Y 1 cell of tn of 34,560 one ulp
apart, out none.
"""
import pytest

from cmcfs_tpu_torch.ops import pcr_sweep as pcs

from test_torch_pair_sweep_bf16 import check_pair


@pytest.mark.parametrize("axis, exact, gmerge", [(0, True, True),
                                                 (1, False, False),
                                                 (2, False, False)])
def test_pcr_pair_bf16_matches_pallas_pcr_kernel(axis, exact, gmerge):
    check_pair(pcs.pcr_sweep, pcs.bf16_launches, axis, exact, gmerge,
               pcr=True)
