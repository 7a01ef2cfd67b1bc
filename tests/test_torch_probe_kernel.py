"""The port's stream-kernel probe (cmcfs_tpu_torch/probes/kernel_probe.py)
against scripts/kernel_probe.py's Pallas kernel in interpret mode
(``make_probe(128, "dma" | "full")``) on seeded inputs.

Tolerances: ``dma`` bit for bit (copies); ``full`` 1e-5 * max(1, max|x|)
per output (XLA:CPU may contract the row build's and the solve's
mul-adds where the port rounds every product).  The script's compute-only
modes compute on scratch that is never loaded and leave nothing in device
memory, so ``comp``, ``comp2``, ``comps`` and ``compi`` are held equal to
the plain ``full`` on the on-chip tile (bit for bit, and within the same
tolerance of the script's ``full``), and ``pcr`` to that Thomas solve
within 1e-5 * max(1, max|x|).
"""
import numpy as np
import pytest
import torch

import scripts.kernel_probe as script
from cmcfs_tpu_torch.probes import kernel_probe as port
from torch_probe_jax import interpret_pallas

N = 128


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    temp4 = rng.uniform(-1, 1, (4, N, N, N)).astype(np.float32)
    rhs4 = rng.uniform(-1, 1, (4, N, N, N)).astype(np.float32)
    forc = rng.uniform(0, 1, (N, N, N)).astype(np.float32)
    return temp4, rhs4, forc


@pytest.fixture(scope="module")
def jax_runs(inputs):
    """{mode: (out, tn)} of the script's kernel."""
    temp4, rhs4, forc = inputs
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        interpret_pallas(mp)
        for mode in ("dma", "full"):
            o, t = script.make_probe(N, mode)(
                temp4, rhs4, np.zeros_like(rhs4), forc)
            out[mode] = (np.asarray(o), np.asarray(t))
    return out


def _within(got, want):
    bound = 1e-5 * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= bound


def test_dma_matches_jax(inputs, jax_runs):
    temp4, rhs4, forc = inputs
    out, tn = port.probe(temp4, rhs4, forc, "dma")
    np.testing.assert_array_equal(out.numpy(), jax_runs["dma"][0])
    np.testing.assert_array_equal(tn.numpy(), jax_runs["dma"][1])
    np.testing.assert_array_equal(out.numpy(), rhs4)


@pytest.mark.parametrize("part", [0, 1], ids=["out", "tn"])
def test_full_matches_jax(inputs, jax_runs, part):
    got = port.probe(*inputs, "full")[part].numpy()
    _within(got, jax_runs["full"][part])


@pytest.fixture(scope="module")
def thomas_pub(inputs):
    """The plain full's x on the tile, published as the comp modes
    publish it."""
    return port.probe_ref(*inputs, "comp").numpy()


@pytest.mark.parametrize("mode", ["comp", "comp2", "comps", "compi"])
def test_compute_modes_equal_full(inputs, jax_runs, thomas_pub, mode):
    got = port.probe(*inputs, mode).numpy()
    assert got.shape == (4, N * N)
    np.testing.assert_array_equal(got, thomas_pub)
    tn = port.common.as_f32(jax_runs["full"][1])
    want = port.publish(tn[:, :1, :, :port.TILE], N).numpy()
    _within(got, want)


def test_pcr_matches_thomas(inputs, thomas_pub):
    _within(port.probe(*inputs, "pcr").numpy(), thomas_pub)


def test_publish_covers_the_tile(inputs):
    """Every (tile line, row) of the tile's x appears in pub."""
    adv, pk, d4 = port.tile(*(port.common.as_f32(x) for x in inputs))
    x4 = port.thomas(adv, pk, d4)[1]
    pub = port.probe_ref(*inputs, "comp")
    assert set(pub[0].tolist()) == set(x4[0].flatten().tolist())


def test_wrong_shapes_raise():
    a = np.zeros((4, 16, 16, 16), np.float32)
    with pytest.raises(ValueError, match="multiple of 8"):
        port.probe(a, a, a[0], "full")
    b = np.zeros((4, 32, 32, 32), np.float32)
    with pytest.raises(ValueError, match="unknown"):
        port.probe(b, b, b[0], "fast")
