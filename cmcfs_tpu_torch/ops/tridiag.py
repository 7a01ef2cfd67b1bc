"""Batched tridiagonal solve of the materialized-row path.

Port of ``cmcfs_tpu/ops/tridiag.py``'s ``tridiag_solve(..., backend=)``
for backends ``scan`` and ``pallas``.  Both run the tridiag_rows kernel
(``ops/tridiag_rows.py``) on CUDA tensors and its plain version on CPU
tensors; they differ only in row 0 of the reciprocal form: ``scan``
divides it (tridiag.py:35-36), ``pallas`` multiplies it by its reciprocal
(pallas_tridiag.py:48-55), the ``recip_row0`` flag.  ``pcr`` is not
ported.
"""
from __future__ import annotations

import torch

from .tridiag_rows import tridiag_rows

# backends of the materialized-row solve, and the ROADMAP item of those the
# port does not have
ROW_BACKENDS = ("scan", "pallas")
_UNPORTED = {"pcr": "parallel cyclic reduction (ROADMAP B1 step 5)"}


def recip_row0(backend: str) -> bool:
    """The row-0 form of a materialized-row backend: ``pallas`` multiplies
    row 0 by its reciprocal, ``scan`` divides it; raises for the others."""
    if backend in _UNPORTED:
        raise NotImplementedError(
            f"tridiagonal backend {backend!r} is not ported: "
            f"{_UNPORTED[backend]}")
    if backend not in ROW_BACKENDS:
        raise KeyError(f"unknown tridiagonal backend {backend!r}")
    return backend == "pallas"


def tridiag_solve(a, b, c, d, axis: int = 0, exact: bool = True,
                  backend: str = "scan") -> torch.Tensor:
    """Solve along ``axis`` with backend ``scan`` or ``pallas``."""
    recip = recip_row0(backend)
    # the kernel addresses rows by stride in a contiguous array; the model
    # paths hand it contiguous rows, so this copies only for other callers
    a, b, c, d = (t.contiguous() for t in (a, b, c, d))
    return tridiag_rows(a, b, c, d, axis=axis, exact=exact, recip_row0=recip)
