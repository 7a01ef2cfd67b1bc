"""The pair sweep's bf16 payload mode against cmcfs_tpu's, on the CPU: the
port's plain bf16 pair (``ops/pair_sweep.pair_sweep`` with bf16 rhs and
out_prev) against ``adi3d._solve_nl_fused(..., bf16=True)``, whose Pallas
pair kernel runs in interpret mode as the JAX package's own tests run it,
on the X direction with the gmerge fold, reciprocal Thomas (the bench's
form), test_torch_pair_sweep.py's lid cavity with seeded noise.

Tolerance (tests/torch_bf16.py): every cell of out and tn equal or one
bf16 ulp apart; measured: no cell differs (34,560 cells of out and of tn).

The rounding points: the pair rounds rhs and out_prev on the way in and
out and tn on the way out, and keeps the first iteration's out1 and tn1
in float32 (pallas_sweep_nl.py:269-273, :808, :834).  A variant of the
port's plain pair that rounds out1 and tn1 to bf16 parts from the port
and from cmcfs_tpu on 8.6 % of the cells of out and 11.6 % of tn
(measured), on 1,344 cells of tn by more than one ulp.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmcfs_tpu.models import adi3d as jadi
from cmcfs_tpu_torch.models import adi3d as tadi
from cmcfs_tpu_torch.models.common3d import from_jax_numpy
from cmcfs_tpu_torch.ops import pair_sweep as ps

from test_torch_pair_sweep import _stack, setup_case
from test_torch_pair_sweep_dual import baffle_case
from torch_bf16 import assert_one_ulp, ulps

DT = jnp.float32(0.01)


@functools.lru_cache(maxsize=None)
def pair_case(axis, exact, gmerge, pcr=False, baffle=False, seed=5):
    """(the port's pair operands, cmcfs_tpu's (tn4, out4) as float32
    arrays) of one bf16 pair: the lid cavity of test_torch_pair_sweep.py,
    or with ``baffle`` the FREE baffle of test_torch_pair_sweep_dual.py
    (its X lines' dual plane)."""
    temp, rhs, out, ga, pa = (baffle_case if baffle else setup_case)(
        seed=seed)
    t_j, o_j = jadi._solve_nl_fused(axis, rhs, temp, out, ga, DT, pa, exact,
                                    gmerge=gmerge, bf16=True, pcr=pcr)
    st, tga, tpa = from_jax_numpy(temp, ga, pa, "cpu")
    assert (tga.dual_flags[axis] is not None) == baffle
    args = (torch.stack(tuple(st)), tga.cls_a[axis], tga.bc_vel, tga.bc_temp,
            _stack(rhs).bfloat16(), _stack(out).bfloat16(),
            tadi._nl_scal(axis, tpa, DT), axis, exact, gmerge,
            tga.dual_flags[axis])
    return args, (np.stack([np.asarray(f) for f in t_j]),
                  np.stack([np.asarray(f) for f in o_j]))


def check_pair(sweep, counter, axis, exact, gmerge, pcr=False,
               baffle=False):
    """The port's bf16 pair (``sweep``: pair_sweep or pcr_sweep) against
    cmcfs_tpu's, within one bf16 ulp; no launch on the CPU."""
    args, (t_j, o_j) = pair_case(axis, exact, gmerge, pcr, baffle)
    before = counter.count
    o_t, t_t = sweep(*args)
    assert counter.count == before          # CPU tensors: plain version
    assert o_t.dtype == t_t.dtype == torch.bfloat16
    return assert_one_ulp(o_t, o_j, "out"), assert_one_ulp(t_t, t_j, "tn")


def test_pair_sweep_bf16_matches_pallas_pair_kernel():
    check_pair(ps.pair_sweep, ps.bf16_launches, 0, False, True)


def _rounding_first_iteration(temp4, cls, bcv, bct, rhs4, op4, scal, axis,
                              exact, gmerge, flags=None):
    """The pair with its rounding points misplaced: out1 and tn1 rounded
    to bf16 between the two iterations."""
    s = np.asarray(scal, dtype=np.float32)
    out1, tn1 = ps.iteration_ref(temp4, cls, bcv, bct, rhs4.float(),
                                 op4.float(), s, axis, exact, False)
    out1, tn1 = (t.bfloat16().float() for t in (out1, tn1))
    out, tn = ps.iteration_ref(tn1, cls, bcv, bct, rhs4.float(), out1, s,
                               axis, exact, gmerge)
    return out.bfloat16(), tn.bfloat16()


def test_first_iteration_stays_float32():
    args, (t_j, o_j) = pair_case(0, False, True)
    o_t, t_t = ps.pair_sweep_ref(*args)
    o_r, t_r = _rounding_first_iteration(*args)
    # the variant parts from the port, and from cmcfs_tpu by more than the
    # one ulp the port is held to
    assert not torch.equal(o_r, o_t) and not torch.equal(t_r, t_t)
    assert int(ulps(t_r, t_j).max()) > 1
    assert_one_ulp(o_t, o_j, "out")
    assert_one_ulp(t_t, t_j, "tn")


@pytest.mark.parametrize("bad", ["mixed", "temp"])
def test_bf16_payloads_checked(bad):
    """rhs and out_prev are both float32 or both bf16; temp stays
    float32."""
    args = list(_small_args())
    if bad == "mixed":
        args[5] = args[5].float()
    else:
        args[0] = args[0].bfloat16()
    with pytest.raises(TypeError):
        ps.pair_sweep(*args)


def _small_args():
    rng = np.random.default_rng(0)
    shape = (6, 5, 4)
    cls = torch.tensor(rng.integers(0, 4, shape), dtype=torch.int8)
    bc = torch.zeros(shape, dtype=torch.int8)
    f = [torch.tensor(rng.standard_normal((4,) + shape), dtype=torch.float32)
         for _ in range(3)]
    return (f[0], cls, bc, bc, f[1].bfloat16(), f[2].bfloat16(),
            np.ones(8, dtype=np.float32), 0, True, False)


def test_bf16_no_fallback_off_cpu():
    """bf16 payloads on a device other than the CPU never take the plain
    version: a device with no kernel raises."""
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a
            for a in _small_args()]
    with pytest.raises(RuntimeError, match="no kernel"):
        ps.pair_sweep(*meta)
