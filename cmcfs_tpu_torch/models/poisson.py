"""The Poisson loop shared by the 3D and 2D Stable schemes.

cmcfs_tpu iterates ``lax.while_loop(cond=(err >= 1e-2) & (it < 4000))``
on the device (stable3d.py:84-101, stable2d.py:110-126, 170-182).  Reading
``err`` on the host every iteration would cost one round trip an
iteration, so here ``it``, ``err`` and ``q`` stay on the device: each
iteration computes ``go = (err >= thr) & (it < MAX)`` there, and a sweep
taken when ``go`` is false leaves ``q``, ``err`` and ``it`` as they were.
The host reads ``go`` once every ``check_every`` iterations.  The result
equals the while loop's, iteration for iteration.
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


def iterate(sweep, q: torch.Tensor, it: int = 0, err: float = 1.0,
            check_every: int = CHECK_EVERY):
    """Run ``sweep(q, go) -> (q, err)`` while (err >= 1e-2) & (it < 4000),
    from iteration ``it`` with error ``err``; ``sweep`` must leave q as it
    was where ``go`` is false.  Returns (q, iterations)."""
    dev = q.device
    it = torch.tensor(it, dtype=torch.int32, device=dev)
    err = torch.tensor(err, dtype=torch.float32, device=dev)
    while True:
        for _ in range(check_every):
            go = (err >= POISSON_ERR_THRESHOLD) & (it < MAX_POISSON_ITERS)
            q, e = sweep(q, go)
            err = torch.where(go, e, err)
            it = it + go.to(torch.int32)
        if not bool((err >= POISSON_ERR_THRESHOLD)
                    & (it < MAX_POISSON_ITERS)):
            return q, int(it)
