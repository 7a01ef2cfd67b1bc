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
  37 B a cell; a fallback direction makes ``num_global`` x
  ``num_local`` launches, twice that with a pass B.
* A fused fallback launch (one whole local iteration of a fallback
  direction, the right-hand side built inside): temp, rhs and out_prev
  of the four in (48), the packed masks and the node types (2), out and
  tn of the four out (32): 82 B a cell, ``num_global`` x ``num_local``
  launches a direction.  The port fuses a fallback axis where its
  backend is a float32 fused one, the axis has no pass B and no
  wavefront solves it (``cmcfs_tpu_torch/models/adi3d.py``,
  ``_solve_direction``); the lists below are copies of that module's.

At 256^3 (16,777,216 cells) a pair's bound is 83 x 16.78 M / 3.35 TB/s
= 0.416 ms; at 383^3 (56,181,887 cells) a line-sweep launch's is 37 x
56.18 M / 3.35 TB/s = 0.62 ms, a fused fallback launch's 82 x 56.18 M /
3.35 TB/s = 1.375 ms.

The record's ``backend`` is the one the traffic (or the control) names,
``auto`` meaning ``fused_nl``; its ``wavefront`` is whether a split X
direction takes the Z-blocked wavefront.  Each count is of the whole
grid: over several cards it is the work of all of them.
"""
from __future__ import annotations

# NVIDIA H100 SXM, published: 3.35 TB/s of HBM3 (at the 700 W limit)
HBM_BYTES_S = 3.35e12
PAIR_B = 48 + 3 + 32
PAIR_DUAL_B = PAIR_B + 1
LINE_B = 4 + 1 + 16 + 16
FUSED_LINE_B = 48 + 2 + 32
# cmcfs_tpu_torch/models/adi3d.py: FUSED, BF16_BACKENDS and what "auto"
# resolves to
FUSED = ("fused_nl", "fused_pcr", "fused_bf16", "fused_pcr_bf16",
         "fused_full", "fused_dma", "fused")
BF16_BACKENDS = ("fused_bf16", "fused_pcr_bf16")
AUTO = "fused_nl"


def pair_bytes(rec) -> float:
    """Bytes a step of the pair directions (lines the pair form takes)."""
    per_dir = rec.ng * (rec.nl // 2) * rec.cells
    return float(sum(per_dir * (PAIR_DUAL_B if a["dual"] else PAIR_B)
                     for a in rec.axes if a["pair"]))


def fused_fallback(rec, ax: int) -> bool:
    """Whether the port runs a fallback on axis ``ax`` as fused
    launches: a float32 fused backend, no pass B, no wavefront."""
    backend = AUTO if rec.backend == "auto" else rec.backend
    return (backend in FUSED and backend not in BF16_BACKENDS
            and not rec.axes[ax]["dual"]
            and not (ax == 0 and rec.wavefront))


def line_bytes(rec) -> float:
    """Bytes a step of the line-sweep kernel's launches (the fallback
    directions): fused ones at 82 B, the others at 37, twice with a pass
    B."""
    per_dir = rec.ng * rec.nl * rec.cells
    return float(sum(
        per_dir * (FUSED_LINE_B if fused_fallback(rec, ax)
                   else LINE_B * (2 if a["dual"] else 1))
        for ax, a in enumerate(rec.axes) if not a["pair"]))


def step_bytes(rec) -> float:
    """Bytes a step: every direction counted as pairs."""
    per_dir = rec.ng * rec.nl / 2 * rec.cells
    return float(sum(per_dir * (PAIR_DUAL_B if a["dual"] else PAIR_B)
                     for a in rec.axes))


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_S * 1e3


def kernel_seconds(rec, names) -> float:
    """Device seconds of the traced operations whose name is one of
    ``names`` as a function or a template (``name(`` or ``name<``),
    summed over the cards."""
    return sum(e - s for n, s, e, _ in rec.trace.kernels
               if any(k + c in n for k in names for c in "(<")) * 1e-6
