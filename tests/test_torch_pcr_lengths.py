"""``ops/pcr.pcr_solve`` against cmcfs_tpu's cyclic reduction at the line
lengths that bound the CUDA PCR kernel's warp layout, on the CPU.

The kernel (``kernels/csrc/pcr_sweep.cuh``) holds a line in one warp, lane
q owning cells q + 32 j: n = 31, 32 and 33 sit at the edge of one row of
lanes, 65 and 129 one past the levels s = 64 and 128 that it reduces in
registers, 256 at the cap.  Its plain version solves with ``pcr_solve``
in the velocity form, K = 3 right-hand sides on one (a, b, c) chain, and
that form is held here to ``ops/tridiag._solve_leading_axis_pcr``, one
right-hand side at a time, in both ``exact`` modes.  Rows as
test_torch_pcr.py builds them (diagonally dominant, identity rows mixed
in; the third right-hand side reversed), and its bound: 4 ulps of
max(1, max|x|), since XLA may contract a mul-add into an FMA where eager
PyTorch rounds twice.  XLA ops only, no Pallas kernel: seconds.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cmcfs_tpu.ops import tridiag as jtd
from cmcfs_tpu_torch.ops.pcr import pcr_solve

ULPS = 4 * float(np.finfo(np.float32).eps)


def _rows(shape, seed):
    """Diagonally dominant rows with identity rows mixed in."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, shape).astype(np.float32)
    c = rng.uniform(-1, 1, shape).astype(np.float32)
    b = (np.abs(a) + np.abs(c) + rng.uniform(1, 3, shape)).astype(np.float32)
    d = rng.standard_normal(shape).astype(np.float32)
    ident = rng.random(shape) < 0.15
    a[ident], c[ident], b[ident] = 0, 0, 1
    return a, b, c, d


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("n", [31, 32, 33, 65, 129, 256])
def test_pcr_solve_k3_matches_jax(n, exact):
    a, b, c, d = _rows((n, 9), seed=300 + n + exact)
    d3 = np.stack([d, 2 * d, d[::-1].copy()])
    got = pcr_solve(*(torch.tensor(t) for t in (a, b, c, d3)), axis=0,
                    exact=exact)
    assert got.shape == d3.shape
    for k in range(3):
        want = np.asarray(jtd._solve_leading_axis_pcr(
            *(jnp.asarray(t) for t in (a, b, c, d3[k])), exact))
        np.testing.assert_allclose(
            got[k].numpy(), want, rtol=0,
            atol=ULPS * max(1.0, float(np.abs(want).max())))
