"""The stream sweep's bf16 payload mode against cmcfs_tpu's, on the CPU:
one stream iteration of the port (``models/adi3d._stream_iteration`` with
``bf16``: rhs and out_prev rounded in, out and tn rounded out and upcast,
its forcing from ``ops/stencil``) against
``adi3d._solve_stream_fused(..., bf16=True)``, whose Pallas stream kernel
runs in interpret mode, on X and Y of test_torch_pair_sweep.py's lid
cavity with seeded noise (Z: test_torch_stream_sweep_bf16_z.py).  Within
one bf16 ulp a cell (tests/torch_bf16.py); measured: no cell differs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmcfs_tpu.models import adi3d as jadi
from cmcfs_tpu_torch.models import adi3d as tadi
from cmcfs_tpu_torch.models.common3d import from_jax_numpy, merge_ok
from cmcfs_tpu_torch.ops import stream_sweep as ss

from test_torch_pair_sweep import _stack, setup_case
from torch_bf16 import assert_one_ulp

DT = jnp.float32(0.01)


def check_stream(axis, exact):
    """One bf16 stream iteration of the port against cmcfs_tpu's."""
    temp, rhs, out, ga, pa = setup_case(seed=7 + axis)
    t_j, o_j = jadi._solve_stream_fused(axis, rhs, temp, out, ga, DT, pa,
                                        exact, bf16=True)
    st, tga, tpa = from_jax_numpy(temp, ga, pa, "cpu")
    assert merge_ok(tga)[axis]
    before = (ss.bf16_launches.count, ss.launches.count)
    t_t, o_t = tadi._stream_iteration(
        axis, _stack(rhs), torch.stack(tuple(st)), _stack(out), tga, tpa,
        tadi._nl_scal(axis, tpa, DT), exact, bf16=True)
    # CPU tensors: the plain version
    assert (ss.bf16_launches.count, ss.launches.count) == before
    assert_one_ulp(o_t, np.stack([np.asarray(f) for f in o_j]), "out")
    assert_one_ulp(t_t, np.stack([np.asarray(f) for f in t_j]), "tn")


@pytest.mark.parametrize("axis, exact", [(0, False), (1, True)])
def test_stream_sweep_bf16_matches_pallas(axis, exact):
    check_stream(axis, exact)


def test_stream_sweep_bf16_returns_payload_dtype():
    """bf16 payloads in, bf16 out and tn out; mixed payloads refused."""
    temp, rhs, out, ga, pa = setup_case(seed=1)
    st, tga, tpa = from_jax_numpy(temp, ga, pa, "cpu")
    args = [torch.stack(tuple(st)), tga.cls_a[0], tga.bc_vel, tga.bc_temp,
            _stack(rhs).bfloat16(), _stack(out).bfloat16(),
            torch.zeros(tuple(tga.types.shape)),
            tadi._nl_scal(0, tpa, DT)[:5], 0, True]
    o, t = ss.stream_sweep(*args)
    assert o.dtype == t.dtype == torch.bfloat16
    args[5] = args[5].float()
    with pytest.raises(TypeError):
        ss.stream_sweep(*args)
