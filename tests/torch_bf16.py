"""Helpers of the bf16 payload tests (tests/test_torch_*bf16*.py): the
distance of two bf16-valued arrays in bf16 units in the last place, and
the per-call check that every cell is equal or one ulp apart.

Why one ulp per call: the port and cmcfs_tpu compute a call in float32 and
part by a few float32 ulps (FMA contraction in XLA, a reciprocal where the
other divides; the float32 pair tests hold 1e-6).  Rounding both to bf16
then gives the same value unless the float32 value lies within those few
ulps of a rounding midpoint, where the two round one bf16 ulp apart.
"""
import numpy as np
import torch


def as_bf16(x) -> torch.Tensor:
    """A bf16 tensor of ``x`` (a tensor or array), which must hold bf16
    values exactly (a bf16 payload, or the float32 upcast of one)."""
    t = x if isinstance(x, torch.Tensor) else torch.tensor(np.array(x))
    b = t.to(torch.bfloat16)
    assert torch.equal(b.float(), t.float()), "not bf16-valued"
    return b


def ulps(a, b) -> torch.Tensor:
    """Per-cell distance of two bf16-valued arrays in bf16 ulps: the
    difference of their bit patterns read as ordered integers (sign and
    magnitude made monotonic, so +0 and -0 are 0 apart)."""
    def ordered(x):
        i = as_bf16(x).view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


def assert_one_ulp(got, want, what="") -> float:
    """Every cell of ``got`` equal to ``want`` or one bf16 ulp apart;
    returns the share of cells that differ."""
    d = ulps(got, want)
    assert int(d.max()) <= 1, (what, int(d.max()), int((d > 1).sum()))
    return float((d > 0).float().mean())
