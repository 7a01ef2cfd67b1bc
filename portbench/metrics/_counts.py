"""Compulsory bytes of the ADI step and of the port's sweep kernels, from
shapes and the iteration counts alone, and the card's published peak.

Each count reads every input once and writes every output once, whatever
a kernel reads again; float32 fields are 4 bytes a cell, the int8 masks 1.

* A pair (two local iterations of one direction, the pair kernel's one
  call of two launches): temp, rhs and out_prev of u, v, w, T in (48),
  the line class and the two BC masks in (3), out and tn of the four
  out (32): 83 B a cell.  With duals on the axis the dual plane adds 1:
  84.  The step is ``num_global`` x 3 directions x ``num_local`` / 2
  pairs of this traffic, whatever implements it: at ng 4, nl 2, 12 pairs.
* A line-sweep launch (one local iteration of one line class, on a
  right-hand side built outside): the sweep velocity (4), the packed
  masks (1), d of the four variables (16) in, x of the four (16) out:
  37 B a cell; a fallback direction makes ``num_local`` launches, twice
  that with a pass B.

At 256^3 (16,777,216 cells) a pair's bound is 83 x 16.78 M / 3.35 TB/s
= 0.416 ms; at 383^3 (56,181,887 cells) a line-sweep launch's is 37 x
56.18 M / 3.35 TB/s = 0.62 ms.
"""
from __future__ import annotations

# NVIDIA H100 SXM, published: 3.35 TB/s of HBM3 (at the 700 W limit)
HBM_BYTES_S = 3.35e12
PAIR_B = 48 + 3 + 32
PAIR_DUAL_B = PAIR_B + 1
LINE_B = 4 + 1 + 16 + 16


def pair_bytes(rec) -> float:
    """Bytes a step of the pair directions (lines the pair form takes)."""
    per_dir = rec.ng * (rec.nl // 2) * rec.cells
    return float(sum(per_dir * (PAIR_DUAL_B if a["dual"] else PAIR_B)
                     for a in rec.axes if a["pair"]))


def line_bytes(rec) -> float:
    """Bytes a step of the line-sweep launches (the fallback
    directions)."""
    return float(sum(rec.ng * rec.nl * (2 if a["dual"] else 1) * LINE_B
                     * rec.cells for a in rec.axes if not a["pair"]))


def step_bytes(rec) -> float:
    """Bytes a step: every direction counted as pairs."""
    per_dir = rec.ng * rec.nl / 2 * rec.cells
    return float(sum(per_dir * (PAIR_DUAL_B if a["dual"] else PAIR_B)
                     for a in rec.axes))


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_S * 1e3


def kernel_seconds(rec, names) -> float:
    """Device seconds of the traced operations whose name is one of
    ``names`` as a function or a template (``name(`` or ``name<``)."""
    return sum(e - s for n, s, e in rec.trace.kernels
               if any(k + c in n for k in names for c in "(<")) * 1e-6
