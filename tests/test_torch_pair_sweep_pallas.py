"""The port's pair sweep against cmcfs_tpu's Pallas pair kernel
(``fused_sweep_nl``, run in interpret mode on the CPU as the JAX package's
own tests run it), on one case: the X direction with the gmerge fold and
the reciprocal Thomas form the bench runs.  The two read Dirichlet values
from temp and multiply by the same reciprocal spacings; the port's rows 0
divide where the TPU kernel multiplies by a reciprocal, and XLA contracts
FMAs.  Tolerance 1e-6 absolute on fields of magnitude <= 1.2.
"""
import numpy as np
import jax.numpy as jnp
import torch

from cmcfs_tpu.models import adi3d as jadi
from cmcfs_tpu_torch.models import adi3d as tadi
from cmcfs_tpu_torch.models.common3d import from_jax_numpy
from cmcfs_tpu_torch.ops import pair_sweep as ps

from test_torch_pair_sweep import _stack, setup_case


def test_pair_sweep_matches_pallas_pair_kernel():
    temp, rhs, out, ga, pa = setup_case(seed=3)
    dt = jnp.float32(0.01)
    t_j, o_j = jadi._solve_direction_3d(0, rhs, temp, out, ga, dt, 2, pa,
                                        "fused_nl", False, merge_ok=True,
                                        gmerge=True)
    st, tga, tpa = from_jax_numpy(temp, ga, pa, "cpu")
    o_t, t_t = ps.pair_sweep(torch.stack(tuple(st)), tga.cls_a[0],
                             tga.bc_vel, tga.bc_temp, _stack(rhs),
                             _stack(out), tadi._nl_scal(0, tpa, dt), 0,
                             False, True)
    for k in range(4):
        np.testing.assert_allclose(o_t[k].numpy(), np.asarray(o_j[k]),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(t_t[k].numpy(), np.asarray(t_j[k]),
                                   rtol=0, atol=1e-6)
