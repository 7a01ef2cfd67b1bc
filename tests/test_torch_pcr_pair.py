"""The PCR pair sweep (``ops/pcr_sweep.py``, the port of the pair kernel's
pcr mode) against cmcfs_tpu's Pallas pair kernel with ``pcr=True``
(``adi3d._solve_nl_fused``, run in interpret mode on the CPU as the JAX
package's own tests run it), on the CPU.

One pair on each axis of the lid cavity at 40 x 19 x 21 with seeded noise
on IN cells (the X sweep at n = 40 is test_backends3d.py's
non-power-of-two case; cmcfs_tpu reduces the Y and Z lines padded to 24
rows, whose identity rows leave the solution unchanged), exact with the
gmerge fold on X, reciprocal on Y (Z: test_torch_pcr_pair_z.py).
Tolerance 1e-6 absolute on fields of
magnitude <= 1.2: both packages reduce in the same order and multiply by
the same reciprocal spacings; XLA contracts FMAs where eager PyTorch
rounds twice.  The whole ``fused_pcr`` step, with and without duals:
test_torch_pcr_pair_step.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as entry
from cmcfs_tpu.core.types import NodeType
from cmcfs_tpu.models import common3d as jc
from cmcfs_tpu_torch.models import adi3d as tadi
from cmcfs_tpu_torch.models.common3d import from_jax_numpy, merge_ok
from cmcfs_tpu_torch.ops import pcr_sweep as pcs

ATOL = 1e-6


def _case(seed):
    jadi, ga, cur, pa = entry._setup(40, 19, 21, "scan")
    rng = np.random.default_rng(seed)
    is_in = np.asarray(ga.types) == NodeType.IN

    def noisy():
        return jc.State3D(*(jnp.asarray(np.where(
            is_in, np.asarray(f) + 0.1 * rng.standard_normal(f.shape),
            np.asarray(f)).astype(np.float32)) for f in cur))

    return jadi, ga, pa, noisy(), noisy(), noisy()


def _stack(state):
    return torch.stack([torch.tensor(np.asarray(f)) for f in state])


@pytest.mark.parametrize("axis, exact, gmerge", [(0, True, True),
                                                 (1, False, False)])
def test_pcr_pair_matches_pallas_pcr_kernel(axis, exact, gmerge):
    jadi, ga, pa, temp, rhs, out = _case(seed=axis)
    dt = jnp.float32(0.01)
    t_j, o_j = jadi._solve_nl_fused(axis, rhs, temp, out, ga, dt, pa,
                                    exact=exact, gmerge=gmerge, pcr=True)
    st, tga, tpa = from_jax_numpy(temp, ga, pa, "cpu")
    assert merge_ok(tga)[axis] and tga.dual_flags[axis] is None
    before = pcs.launches.count
    o_t, t_t = pcs.pcr_sweep(torch.stack(tuple(st)), tga.cls_a[axis],
                             tga.bc_vel, tga.bc_temp, _stack(rhs),
                             _stack(out), tadi._nl_scal(axis, tpa, dt), axis,
                             exact, gmerge)
    assert pcs.launches.count == before        # CPU tensors: plain version
    for k in range(4):
        np.testing.assert_allclose(o_t[k].numpy(), np.asarray(o_j[k]),
                                   rtol=0, atol=ATOL)
        np.testing.assert_allclose(t_t[k].numpy(), np.asarray(t_j[k]),
                                   rtol=0, atol=ATOL)


def test_pcr_sweep_no_fallback_off_cpu():
    """Tensors on a device other than the CPU never take the plain version:
    a device with no kernel raises."""
    jadi, ga, pa, temp, rhs, out = _case(seed=5)
    st, tga, tpa = from_jax_numpy(temp, ga, pa, "cpu")
    meta = [t.to("meta") for t in (torch.stack(tuple(st)), tga.cls_a[0],
                                   tga.bc_vel, tga.bc_temp, _stack(rhs),
                                   _stack(out))]
    with pytest.raises(RuntimeError, match="no kernel"):
        pcs.pcr_sweep(*meta, tadi._nl_scal(0, tpa, 0.01), 0, True, False)
