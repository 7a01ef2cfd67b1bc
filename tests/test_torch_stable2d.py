"""The port's 2D Stable scheme (cmcfs_tpu_torch/models/stable2d.py)
against cmcfs_tpu's on the CPU, in both Poisson modes: ``redblack`` and
``sequential`` (the reference's exact Gauss-Seidel order).  One
projection from random intermediate velocities, and 2 steps on
tests/test_solvers2d.py's synthetic lid cavity, within torch_schemes.REL
= 1e-6 * max(1, max|field|) per variable (measured 3.0e-8); the gathered
wavefront sweep against cmcfs_tpu's whole-field form written in PyTorch,
bit for bit; and the loop read on the host every 16 iterations against
every iteration, bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmcfs_tpu.models import stable2d as jsb
from cmcfs_tpu_torch.models import common2d, poisson, stable2d
from tests.torch_schemes import assert_close, cavity2d, random_state

DT = 0.002
MODES = ["redblack", "sequential"]


def _w_fields(jcur, jga, seed):
    return random_state(tuple(jcur)[:2], jga.types, seed, 0.05)


@pytest.mark.parametrize("mode", MODES)
def test_poisson_project_matches_jax(mode):
    grid, (jcur, jga, jpa), (_, ga, pa) = cavity2d(22, 19)
    w = _w_fields(jcur, jga, 1)
    want = jsb._poisson_project(*(jnp.asarray(f) for f in w), jga, jpa,
                                mode=mode)
    got, iters = stable2d._poisson_project(*(torch.tensor(f) for f in w),
                                           ga, pa, mode=mode)
    assert 1 < iters < poisson.MAX_POISSON_ITERS
    assert_close(got, want)


@pytest.mark.parametrize("mode", MODES)
def test_stable_steps_match_jax(mode):
    grid, (jcur, jga, jpa), (cur, ga, pa) = cavity2d(24, 20)
    for _ in range(2):
        want, werr, wit = jsb.stable_timestep_2d(
            jcur, jcur, jga, jnp.float32(DT), jnp.int32(2), 1, jpa, mode=mode)
        got, err, it, piters = stable2d.stable_timestep_2d(
            cur, cur, ga, DT, 2, 1, pa, mode=mode)
        assert it == int(wit) and len(piters) == it
        assert abs(float(err) - float(werr)) <= 1e-4 * abs(float(werr))
        assert_close(got, want)
        jcur, cur = want, got


def _whole_field_sweep(p, q):
    """cmcfs_tpu's sweep (stable2d.py:142-168) in PyTorch: every wave
    computed over the whole field."""
    dimx, dimy = q.shape
    ii = torch.arange(dimx)[:, None].expand(dimx, dimy)
    jj = torch.arange(dimy)[None, :].expand(dimx, dimy)
    diag, lex = ii + jj, ii * dimy + jj
    keys = torch.where(p.is_bnd, lex,
                       torch.where(p.is_in, lex + dimx * dimy, -1))
    qb_new = p.gs_value(q)
    rel_b = torch.abs((qb_new - q) / qb_new)
    q = torch.where(p.is_bnd, qb_new, q)
    rel = torch.zeros_like(q)
    for k in range(dimx + dimy - 1):
        mask = p.is_in & (diag == k)
        qn = p.gs_value(q)
        rel = torch.where(mask, torch.abs((qn - q) / qn), rel)
        q = torch.where(mask, qn, q)
    rel = torch.where(p.is_bnd, rel_b, rel)
    last_nan = torch.amax(torch.where(torch.isnan(rel) & (keys >= 0), keys,
                                      -1))
    sel = keys > last_nan
    err = torch.where(torch.any(sel),
                      torch.amax(torch.where(sel, rel, -float("inf"))),
                      float("nan"))
    return q, err


@pytest.mark.parametrize("nan", [False, True])
def test_gathered_waves_equal_whole_field(nan):
    """Five sweeps of the gathered form against the whole-field form from
    the same random q, bit for bit in q and in the error; with a NaN in q
    the error is the max over the cells processed after it."""
    grid, (jcur, jga, _), (_, ga, pa) = cavity2d(21, 17)
    w = [torch.tensor(f) for f in _w_fields(jcur, jga, 2)]
    p = stable2d._Poisson2D(*w, ga, pa)
    sweep = stable2d.SequentialSweep(p, stable2d.WaveIndex(ga))
    q = torch.tensor(np.random.default_rng(3).standard_normal(
        (21, 17)).astype(np.float32))
    if nan:
        q[9, 5] = float("nan")
        q[3, 16] = float("nan")
    qa = qb = q
    for _ in range(5):
        qa, ea = sweep(qa, None)
        qb, eb = _whole_field_sweep(p, qb)
        assert torch.equal(torch.isnan(qa), torch.isnan(qb))
        assert torch.equal(torch.nan_to_num(qa), torch.nan_to_num(qb))
        assert (torch.isnan(ea) and torch.isnan(eb)) or torch.equal(ea, eb)


@pytest.mark.parametrize("mode", MODES)
def test_check_every_bitwise(mode):
    grid, (jcur, jga, _), (_, ga, pa) = cavity2d(20, 18)
    cur = common2d.State2D(*(torch.tensor(f) for f in
                             random_state(jcur, jga.types, 4, 0.02)))
    (a, ea, ita, pa_), (b, eb, itb, pb) = (
        stable2d.stable_timestep_2d(cur, cur, ga, DT, 2, 1, pa, mode=mode,
                                    check_every=k) for k in (1, 16))
    assert ita == itb and pa_ == pb
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(ea, eb)
