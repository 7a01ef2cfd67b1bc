"""The pair sweep's dual form against cmcfs_tpu's Pallas pair kernel
``fused_sweep_nl`` with ``cls_b`` and ``take_b`` (its second elimination
chain), run in interpret mode on the CPU as the JAX package's own tests run
it, on the FREE baffle's X direction with the gmerge fold and the
reciprocal Thomas form the bench runs.  Tolerance 1e-6 absolute on fields
of magnitude <= 1.2, the upper end of test_duals.py's 5e-7 to 1e-6 for the
same kernel against ``scan``: the kernel's rows 0 multiply by a reciprocal
where the port divides, and XLA contracts FMAs.
"""
import jax.numpy as jnp

from cmcfs_tpu.models import adi3d as jadi

from test_torch_pair_sweep_dual import SHAPE, _close, _port, baffle_case


def test_dual_pair_sweep_matches_pallas_pair_kernel():
    """cmcfs_tpu's pair kernel runs its second chain in-kernel (dispatch
    ``pair`` on the dual X lines, interpret mode on the CPU)."""
    temp, rhs, out, ga, pa = baffle_case(seed=1)
    assert jadi._dir_path(0, SHAPE[0], "fused_nl", True, False, 2,
                          None) == "pair"
    t_j, o_j = jadi._solve_direction_3d(0, rhs, temp, out, ga,
                                        jnp.float32(0.01), 2, pa, "fused_nl",
                                        False, merge_ok=True, gmerge=True)
    _close(_port(temp, rhs, out, ga, pa, False, True), o_j, t_j)
