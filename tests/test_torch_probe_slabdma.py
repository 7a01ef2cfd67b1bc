"""The port's slab-copy probe (cmcfs_tpu_torch/probes/probe_slabdma.py)
against scripts/probe_slabdma.py's Pallas kernel in interpret mode,
strided / fullc / blocked, on the script's own 256^3 array (``--reps 1``).

Tolerance: bit for bit.  acc is a sum of slab rows in slab order in both,
and the copies move values unchanged.  The port sums every plane p of the
slabs into out[p]; the script's acc is out[0], and the other planes are
held against a numpy loop.  The script is compared at
``--depth 64``, all 64 slabs in flight: at a smaller depth D its kernel
starts the copy of slab b + D into the slot it reads slab b from before it
reads it (probe_slabdma.py:72-79), so in interpret mode, where a copy lands
when it starts, acc sums slab b + D in place of slab b
(``test_script_fault_at_depth_2`` pins that).
"""
import sys

import jax
import numpy as np
import pytest

import scripts.probe_slabdma as script
from cmcfs_tpu_torch.probes import probe_slabdma as port
from torch_probe_jax import record_pallas


def _script_run(depth):
    """{mode: (x, acc)} of the script's run at ``depth``."""
    with pytest.MonkeyPatch.context() as mp:
        records = record_pallas(mp)
        mp.setattr(sys, "argv", ["probe_slabdma.py", "--reps", "1",
                                 "--depth", str(depth)])
        with jax.disable_jit():
            script.main()
    out = {rec.consts["mode"]: (rec.inputs[0], np.asarray(rec.outputs))
           for rec in records}
    assert set(out) == set(port.MODES)
    return out


@pytest.fixture(scope="module")
def jax_runs():
    return _script_run(64)


@pytest.mark.parametrize("depth", [1, 4])
@pytest.mark.parametrize("mode", list(port.MODES))
def test_plain_matches_jax(jax_runs, mode, depth):
    x, want = jax_runs[mode]
    got = port.slab_copy(x, mode, depth).numpy()
    assert got.shape == (256, 8, 128)
    np.testing.assert_array_equal(got[0], want)


@pytest.mark.parametrize("mode", list(port.MODES))
def test_every_plane_in_slab_order(mode):
    """out[p] = sum over slabs b = (jj, cc), in order, of plane p's
    (8, 128) rows: a float32 loop in numpy on a 256^3 array (64 slabs;
    fullc's slab is the band's first 128 lanes for both cc)."""
    n = 256
    dense = np.random.default_rng(7).random((n, n, n), np.float32)
    want = np.zeros((n, 8, 128), np.float32)
    for b in range(64):
        jj, cc = divmod(b, 2)
        c0 = 0 if mode == "fullc" else 128 * cc
        want = want + dense[:, 8 * jj:8 * jj + 8, c0:c0 + 128]
    x = (port.blocked_of(port.common.as_f32(dense))
         if mode == "blocked" else dense)
    np.testing.assert_array_equal(port.slab_copy(x, mode).numpy(), want)


def test_blocked_of_matches_script(jax_runs):
    np.testing.assert_array_equal(
        port.blocked_of(port.common.as_f32(jax_runs["strided"][0])).numpy(),
        jax_runs["blocked"][0])


@pytest.mark.parametrize("tiled", [False, True])
def test_line_sums_in_order(tiled):
    """Each line summed in order along the contiguous axis: a float32 loop
    in numpy, bit for bit."""
    rng = np.random.default_rng(int(tiled))
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    want = np.zeros((3, 5), np.float32)
    for k in range(64):
        want = want + x[..., k]
    np.testing.assert_array_equal(port.line_sums(x, tiled).numpy(), want)


def test_wrong_shapes_raise():
    with pytest.raises(ValueError, match="strided takes"):
        port.slab_copy(np.zeros((128, 128, 64), np.float32), "strided")
    with pytest.raises(ValueError, match="unknown"):
        port.slab_copy(np.zeros((128,) * 3, np.float32), "dense")
    with pytest.raises(ValueError, match="multiple of 32"):
        port.line_sums(np.zeros((4, 40), np.float32), True)


def test_script_fault_at_depth_2():
    """At depth 2 the script's acc sums slab b + 2 at step b (slab b at the
    last two steps): its prefetch refills the slot being read.  The port's
    plain version, summing slab b, differs from it."""
    runs = _script_run(2)
    x, got = runs["strided"]
    total = 64

    def row(b):
        jj, cc = divmod(b, 2)
        return x[0, jj * 8:(jj + 1) * 8, cc * 128:(cc + 1) * 128]

    shifted = np.zeros((8, 128), np.float32)
    for b in range(total):
        shifted = shifted + row(b + 2 if b + 2 < total else b)
    np.testing.assert_array_equal(got, shifted)
    assert not np.array_equal(got, port.slab_copy(x, "strided").numpy()[0])
