"""The pipelined Thomas solve along the split X axis (port of
cmcfs_tpu/parallel/pipeline.py).

The reference's cross-device X solve (AdiSolver3D.cu:524-640, and with
``blocking nBlockZ`` the Z-blocked wavefront, :642-881): forward
elimination flows shard to shard carrying each line's (c', d') at the
cut, back substitution flows back carrying x.  The batch's last axis (Z)
is split into ``nb`` blocks; at wavefront stage t shard k runs block t - k
forward, so shard k starts on block 0 as soon as shard k - 1 hands over
that block's carry, and the backward pass runs the same stages in reverse
shard order.  Each carry plane goes to the next shard's device with
``copy_(non_blocking=True)`` (a ``Tensor.to``) and the host never waits
inside the sweep.  cmcfs_tpu expresses this in SPMD, so each of its
devices evaluates every stage and keeps its own; here each shard runs only
its own valid stages: nb forward and nb backward launches a row set.
Shards may own unequal numbers of planes.

The recurrences are ``ops/tridiag_carry.py``'s (the carry kernels on the
card): in exact mode the Thomas order of ``ops/tridiag_rows`` (the
``scan`` backend), in reciprocal mode its ``recip_row0`` form.  Blocking
only reorders independent lines, so x does not depend on ``nb``.  A
line's first row must have a = 0 and its last c = 0 (the last shard zeroes
it, as cmcfs_tpu's does); the row builds give both.
"""
from __future__ import annotations

import torch

from ..ops.tridiag_carry import carry_bwd, carry_fwd


def _largest_divisor_leq(n: int, m: int) -> int:
    for k in range(min(n, m), 0, -1):
        if n % k == 0:
            return k
    return 1


def pipelined_tridiag_x_blocked(rows, plan, nblockz: int,
                                exact: bool = True) -> list:
    """Solve the lines that run along the leading axis across the shards.

    ``rows``: one entry a shard of ``plan`` (in its order), each a list of
    row sets (a, b, c, d) on the shard's device, the same number of sets
    on every shard: a, b, c (n_i, ..., Z) contiguous, the shard's n_i rows
    of each line; d a's shape, or (k,) + a's shape with k = 1 or 3 (k
    systems on those rows), each d[j] laid out as a.  Z splits into the
    largest number of blocks that divides it and is at most ``nblockz``.
    Returns one list a shard of each set's x, shaped as its d."""
    K = plan.n
    sets = [[(a, b, c, d if d.dim() > a.dim() else d.unsqueeze(0))
             for a, b, c, d in rs] for rs in rows]
    nz = sets[0][0][0].shape[-1]
    nb = _largest_divisor_leq(nz, max(1, nblockz))
    blk = nz // nb
    stages = K + nb - 1

    def zeros(k, s, systems):
        """Zero carry planes of shard k's set s, one block wide: the c'
        plane, or one plane a system."""
        a, _, _, d = sets[k][s]
        shape = tuple(a.shape[1:-1]) + (blk,)
        if systems:
            shape = (d.shape[0],) + shape
        return torch.zeros(shape, dtype=torch.float32, device=a.device)

    def moved(ts, dev):
        return [t.to(dev, non_blocking=True) for t in ts]

    cps = [[torch.empty_like(a) for a, _, _, _ in rs] for rs in sets]
    dps = [[torch.empty(d.shape, dtype=torch.float32, device=d.device)
            for _, _, _, d in rs] for rs in sets]
    # carries[k][j]: what shard k starts block j from, per row set
    carries = [[None] * nb for _ in range(K)]
    for t in range(stages):
        for k in range(K):
            j = t - k
            if not 0 <= j < nb:
                continue
            cin = carries[k][j]
            if cin is None:                      # the lines' first shard
                cin = [(zeros(k, s, False), zeros(k, s, True))
                       for s in range(len(sets[k]))]
            out = [carry_fwd(a, b, c, d, cc, cd, cp, dp, j * blk, k == K - 1,
                             exact)
                   for (a, b, c, d), (cc, cd), cp, dp in zip(
                       sets[k], cin, cps[k], dps[k])]
            carries[k][j] = None
            if k + 1 < K:
                dev = plan.devices[k + 1]
                carries[k + 1][j] = [moved(o, dev) for o in out]

    xs = [[torch.empty_like(dp) for dp in ds] for ds in dps]
    for t in range(stages):
        for k in range(K - 1, -1, -1):
            j = t - (K - 1 - k)
            if not 0 <= j < nb:
                continue
            xin = carries[k][j]
            if xin is None:                      # past the lines' end
                xin = [zeros(k, s, True) for s in range(len(sets[k]))]
            out = [carry_bwd(cp, dp, xi, x, j * blk)
                   for cp, dp, xi, x in zip(cps[k], dps[k], xin, xs[k])]
            carries[k][j] = None
            if k > 0:
                carries[k - 1][j] = moved(out, plan.devices[k - 1])
    return [[x.reshape(d.shape) for x, (_, _, _, d) in zip(xk, rk)]
            for xk, rk in zip(xs, rows)]


def pipelined_tridiag_x(rows, plan, exact: bool = True) -> list:
    """``pipelined_tridiag_x_blocked`` with one block: the plain pipeline,
    each shard's forward pass waiting for the whole carry plane of the
    shard before it."""
    return pipelined_tridiag_x_blocked(rows, plan, 1, exact)
