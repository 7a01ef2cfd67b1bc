"""The port's pipelined X solve (``parallel/pipeline.py``) and its carry
passes (``ops/tridiag_carry.py``) on CPU shards.

Against cmcfs_tpu's ``pipelined_tridiag_x_blocked`` and
``pipelined_tridiag_x`` on the 8-device virtual CPU mesh
(tests/conftest.py), on the inputs of its own tests
(tests/test_parallel.py:199-205, seed 7, and :254-263, seed 3), for block
counts 1, 3, 5 (which rounds to 4) and 48, in both division modes: bit
for bit (``assert_array_equal``) where XLA compiles cmcfs_tpu's function
at backend optimization level 0, which keeps every product rounded
before the subtraction as the port rounds it; at the default level the
CPU backend contracts ``b - a * c'`` and ``d' - c' * x`` into FMAs
(PARITY.md 7), and the two part by an ulp (held at 1e-7 there).  The
port's shards own uneven runs of rows and solve k systems on one set of
rows: bit for bit the single device's ``tridiag_rows_ref`` in exact mode
and its ``recip_row0`` form in reciprocal mode, for any block count.  The carry passes' plain versions
equal cmcfs_tpu's ``_local_fwd`` / ``_local_bwd`` bit for bit from
nonzero carries, the last shard's c = 0 included.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmcfs_tpu.parallel import pipeline as jpipe
from cmcfs_tpu.parallel.mesh import make_x_mesh as jax_mesh
from cmcfs_tpu_torch.ops.tridiag_carry import carry_bwd, carry_fwd
from cmcfs_tpu_torch.ops.tridiag_rows import tridiag_rows_ref
from cmcfs_tpu_torch.parallel.mesh import ShardingPlan
from cmcfs_tpu_torch.parallel.pipeline import (pipelined_tridiag_x,
                                               pipelined_tridiag_x_blocked)


def _rows(seed, n, batch, zero_ends=True):
    """cmcfs_tpu's test rows: a[0] = 0, c[-1] = 0, b about 6."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, batch)).astype(np.float32)
    b = (rng.normal(size=(n, batch)) + 6.0).astype(np.float32)
    c = rng.normal(size=(n, batch)).astype(np.float32)
    d = rng.normal(size=(n, batch)).astype(np.float32)
    if zero_ends:
        a[0] = 0.0
        c[-1] = 0.0
    return a, b, c, d


def _jax_args(rows):
    plan = jax_mesh(8)
    sh = jax.NamedSharding(plan.mesh, jax.sharding.PartitionSpec("x"))
    return plan, [jax.device_put(jnp.asarray(m), sh) for m in rows]


# products rounded before they are added: no FMA contraction
UNCONTRACTED = {"xla_backend_optimization_level": 0}


def _jax_run(fn, args, options=UNCONTRACTED):
    """cmcfs_tpu's ``fn`` on ``args``, compiled with ``options``; its
    outputs as numpy arrays."""
    out = jax.jit(fn).lower(*args).compile(compiler_options=options)(*args)
    return jax.tree.map(np.asarray, out)


def _port(rows, cuts, nblockz, exact):
    """The port's pipeline over len(cuts) CPU shards of ``rows`` (a, b, c,
    d as numpy arrays, d possibly (k,) + a's shape); x gathered."""
    plan = ShardingPlan(["cpu"] * len(cuts))
    a, b, c, d = (torch.from_numpy(np.ascontiguousarray(m)) for m in rows)
    kd = d.dim() > a.dim()
    per, start = [], 0
    for n in cuts:
        sl = slice(start, start + n)
        per.append([(a[sl].contiguous(), b[sl].contiguous(),
                     c[sl].contiguous(),
                     (d[:, sl] if kd else d[sl]).contiguous())])
        start += n
    xs = pipelined_tridiag_x_blocked(per, plan, nblockz, exact)
    return torch.cat([x[0] for x in xs], dim=1 if kd else 0).numpy()


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("nb", [1, 3, 5, 48])
def test_blocked_matches_cmcfs_tpu(nb, exact):
    rows = _rows(7, 64, 48)
    plan, args = _jax_args(rows)
    want = _jax_run(functools.partial(jpipe.pipelined_tridiag_x_blocked,
                                      plan=plan, nblockz=nb, exact=exact),
                    args)
    got = _port(rows, [8] * 8, nb, exact)
    np.testing.assert_array_equal(got, want)
    if nb == 3:
        fma = _jax_run(functools.partial(jpipe.pipelined_tridiag_x_blocked,
                                         plan=plan, nblockz=nb, exact=exact),
                       args, {})
        np.testing.assert_allclose(got, fma, rtol=0, atol=1e-7)


@pytest.mark.parametrize("exact", [True, False])
def test_unblocked_matches_cmcfs_tpu(exact):
    rows = _rows(3, 64, 32)
    plan, args = _jax_args(rows)
    want = _jax_run(functools.partial(jpipe.pipelined_tridiag_x, plan=plan,
                                      exact=exact), args)
    a, b, c, d = (torch.from_numpy(m) for m in rows)
    per = [[(a[i:i + 8].contiguous(), b[i:i + 8].contiguous(),
             c[i:i + 8].contiguous(), d[i:i + 8].contiguous())]
           for i in range(0, 64, 8)]
    xs = pipelined_tridiag_x(per, ShardingPlan(["cpu"] * 8), exact)
    got = torch.cat([x[0] for x in xs]).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cuts, nblockz, k", [
    ([5, 9, 1, 7], 3, 3), ([11, 11], 6, 1), ([1, 20, 1], 4, 3),
    ([22], 2, 3), ([3, 4, 5, 6, 4], 12, 1)])
@pytest.mark.parametrize("exact", [True, False])
def test_uneven_cuts_and_k_form(cuts, nblockz, k, exact):
    """(n, Y, Z) rows of 22 X planes over uneven shards, k systems on them:
    the single device's Thomas (``scan``'s order; the reciprocal form
    with row 0 multiplied, ``recip_row0``)."""
    rng = np.random.default_rng(11)
    shape = (22, 5, 12)
    a = rng.normal(size=shape).astype(np.float32)
    b = (rng.normal(size=shape) + 6.0).astype(np.float32)
    c = rng.normal(size=shape).astype(np.float32)
    d = rng.normal(size=(k,) + shape).astype(np.float32)
    a[0] = 0.0
    c[-1] = 0.0
    want = tridiag_rows_ref(*(torch.from_numpy(m) for m in (a, b, c, d)),
                            exact=exact, recip_row0=not exact).numpy()
    np.testing.assert_array_equal(_port((a, b, c, d), cuts, nblockz, exact),
                                  want)


@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("exact", [True, False])
def test_carry_passes_match_local_fwd_bwd(exact, last):
    """One shard's passes from nonzero carries on a block of columns,
    against cmcfs_tpu's _local_fwd / _local_bwd on the same block (with
    c[-1] zeroed where the shard is the last, as the pipeline does)."""
    a, b, c, d = _rows(5, 9, 24, zero_ends=False)
    rng = np.random.default_rng(6)
    cin_c, cin_d, xin = (rng.normal(size=8).astype(np.float32)
                         for _ in range(3))
    cols = slice(10, 18)
    cl = c.copy()
    if last:
        cl[-1] = 0.0
    cp_w, dp_w, oc_w, od_w = _jax_run(
        lambda *m: jpipe._local_fwd(*m, exact),
        [jnp.asarray(m[:, cols]) for m in (a, b, cl, d)]
        + [jnp.asarray(cin_c), jnp.asarray(cin_d)])
    x_w, ox_w = _jax_run(jpipe._local_bwd,
                         [jnp.asarray(cp_w), jnp.asarray(dp_w),
                          jnp.asarray(xin)])

    t = [torch.from_numpy(m) for m in (a, b, c)]
    dk = torch.from_numpy(d)[None]
    cp = torch.full_like(t[0], 7.0)
    dp = torch.full_like(dk, 7.0)
    oc, od = carry_fwd(*t, dk, torch.from_numpy(cin_c),
                       torch.from_numpy(cin_d)[None], cp, dp, 10, last, exact)
    x = torch.full_like(dk, 7.0)
    ox = carry_bwd(cp, dp, torch.from_numpy(xin)[None], x, 10)
    for got, want in ((cp[:, cols], cp_w), (dp[0, :, cols], dp_w),
                      (oc, oc_w), (od[0], od_w), (x[0, :, cols], x_w),
                      (ox[0], ox_w)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the columns outside the block are not written
    assert bool((cp[:, :10] == 7.0).all() and (x[..., 18:] == 7.0).all())
