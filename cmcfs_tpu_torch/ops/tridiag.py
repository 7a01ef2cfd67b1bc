"""Batched tridiagonal solve of the materialized-row path.

Port of ``cmcfs_tpu/ops/tridiag.py``'s ``tridiag_solve(..., backend=)``.
``scan`` and ``pallas`` run the tridiag_rows kernel (``ops/tridiag_rows.py``)
on CUDA tensors and its plain version on CPU tensors; they differ only in
row 0 of the reciprocal form: ``scan`` divides it (tridiag.py:35-36),
``pallas`` multiplies it by its reciprocal (pallas_tridiag.py:48-55), the
``recip_row0`` flag.  ``pcr`` is parallel cyclic reduction
(``ops/pcr.py``), which cmcfs_tpu computes with XLA ops and no Pallas
kernel (tridiag.py:66-103, :125-126): the port runs it as PyTorch ops on
either device.
"""
from __future__ import annotations

import torch

from .pcr import pcr_solve
from .tridiag_rows import tridiag_rows

# backends of the materialized-row solve
ROW_BACKENDS = ("scan", "pallas", "pcr")


def tridiag_solve(a, b, c, d, axis: int = 0, exact: bool = True,
                  backend: str = "scan") -> torch.Tensor:
    """Solve along ``axis`` with backend ``scan``, ``pallas`` or ``pcr``;
    ``d`` is a's shape or (k,) + a's shape (k right-hand sides on the same
    rows)."""
    if backend not in ROW_BACKENDS:
        raise KeyError(f"unknown tridiagonal backend {backend!r}")
    if backend == "pcr":
        return pcr_solve(a, b, c, d, axis=axis, exact=exact)
    # the kernel addresses rows by stride in a contiguous array; the model
    # paths hand it contiguous rows, so this copies only for other callers
    a, b, c, d = (t.contiguous() for t in (a, b, c, d))
    return tridiag_rows(a, b, c, d, axis=axis, exact=exact,
                        recip_row0=backend == "pallas")
