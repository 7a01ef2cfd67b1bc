"""The Poisson loop shared by the 3D and 2D Stable schemes.

cmcfs_tpu iterates ``lax.while_loop(cond=(err >= 1e-2) & (it < 4000))``
on the device (stable3d.py:84-101, stable2d.py:110-126, 170-182).  Reading
``err`` on the host every iteration would cost one round trip an
iteration, so here ``it``, ``err`` and ``q`` stay on the device: each
iteration computes ``go = (err >= thr) & (it < MAX)`` there, and a sweep
taken when ``go`` is false leaves ``q``, ``err`` and ``it`` as they were.
The host reads ``go`` once every ``check_every`` iterations.  The result
equals the while loop's, iteration for iteration.  Under an X split the
loop runs on every shard's slab, each shard holding a copy of ``it`` and
``err`` (``iterate``'s ``all_max``).
"""
from __future__ import annotations

import torch

POISSON_ERR_THRESHOLD = 1e-2   # reference StableSolver2D.h:24
MAX_POISSON_ITERS = 4000       # cmcfs_tpu's cap (the reference has none)
CHECK_EVERY = 16               # iterations between the host's reads of go


def rel_change(qn: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """|(qn - q) / qn| with 0 where both are 0 and inf where only qn is
    (cmcfs_tpu's half_sweep, stable3d.py:76-78)."""
    dq = qn - q
    return torch.where(qn == 0.0,
                       torch.where(dq == 0.0, 0.0, float("inf")),
                       torch.abs(dq / qn))


def half_sweep(gs_value, q: torch.Tensor, mask: torch.Tensor):
    """One colour of a red-black sweep: (q updated on ``mask``, the largest
    relative change there).  A NaN change propagates through the max."""
    qn = gs_value(q)
    err = torch.amax(torch.where(mask, rel_change(qn, q), 0.0))
    return torch.where(mask, qn, q), err


def redblack_sweep(gs_value, red: torch.Tensor, black: torch.Tensor):
    """The red then black half sweeps as ``iterate``'s ``sweep``: ``go``
    joins each colour's mask, so a sweep past convergence changes
    nothing."""
    def sweep(q, go):
        q, e1 = half_sweep(gs_value, q, red & go)
        q, e2 = half_sweep(gs_value, q, black & go)
        return q, torch.maximum(e1, e2)
    return sweep


def iterate(sweep, q, it: int = 0, err: float = 1.0,
            check_every: int = CHECK_EVERY, all_max=None):
    """Run ``sweep(q, go) -> (q, err)`` while (err >= 1e-2) & (it < 4000),
    from iteration ``it`` with error ``err``; ``sweep`` must leave q as it
    was where ``go`` is false.  Returns (q, iterations).

    Under an X split (``all_max`` given, ``ShardingPlan.all_max``) ``q``
    is a list, one slab a shard, and ``sweep`` takes and returns lists:
    one ``go`` a shard in, each shard's own error out.  ``all_max`` makes
    each shard's error the max over the shards, so every shard holds the
    single device's error (a max, the same in any order) and stops where
    it stops; the host reads the first shard's."""
    split = all_max is not None
    qs = list(q) if split else [q]
    its = [torch.tensor(it, dtype=torch.int32, device=t.device) for t in qs]
    errs = [torch.tensor(err, dtype=torch.float32, device=t.device)
            for t in qs]
    while True:
        for _ in range(check_every):
            gos = [(e >= POISSON_ERR_THRESHOLD) & (i < MAX_POISSON_ITERS)
                   for e, i in zip(errs, its)]
            if split:
                qs, es = sweep(qs, gos)
                es = all_max(es)
            else:
                q1, e1 = sweep(qs[0], gos[0])
                qs, es = [q1], [e1]
            errs = [torch.where(g, e, r) for g, e, r in zip(gos, es, errs)]
            its = [i + g.to(torch.int32) for i, g in zip(its, gos)]
        if not bool((errs[0] >= POISSON_ERR_THRESHOLD)
                    & (its[0] < MAX_POISSON_ITERS)):
            return (qs if split else qs[0]), int(its[0])
