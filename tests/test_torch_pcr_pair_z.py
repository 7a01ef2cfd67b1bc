"""The PCR pair sweep against cmcfs_tpu's Pallas pair kernel with
``pcr=True`` on the Z axis (exact), as test_torch_pcr_pair.py does on X and
Y, with its fixture and its tolerance (1e-6 absolute); cmcfs_tpu runs the
Z lines transposed onto its kernel's sweep axis (the xmode layout), the
port along the contiguous axis.
"""
import test_torch_pcr_pair as xy


def test_pcr_pair_z_matches_pallas_pcr_kernel():
    xy.test_pcr_pair_matches_pallas_pcr_kernel(2, True, False)
