"""The port's ILP probe (cmcfs_tpu_torch/probes/probe_ilp.py) against
scripts/probe_ilp.py's Pallas kernel in interpret mode, seq and ilp, on
the script's own inputs (``--n 16 --blocks 2``).

Tolerance 1e-6 * max(1, max|JAX|): XLA:CPU may contract the chain's
mul-sub into an FMA where the port rounds the product.
"""
import sys

import jax
import numpy as np
import pytest

import scripts.probe_ilp as script
from cmcfs_tpu_torch.probes import probe_ilp as port
from torch_probe_jax import record_pallas

N, BLOCKS = 16, 2


@pytest.fixture(scope="module")
def jax_runs():
    """{ilp: ((a, r, d), o)} of the script's run."""
    with pytest.MonkeyPatch.context() as mp:
        records = record_pallas(mp)
        mp.setattr(sys, "argv", ["probe_ilp.py", "--n", str(N), "--blocks",
                                 str(BLOCKS), "--reps", "1"])
        with jax.disable_jit():
            script.main()
    out = {rec.consts["ilp"]: (rec.inputs, np.asarray(rec.outputs))
           for rec in records}
    assert set(out) == {False, True}
    return out


@pytest.mark.parametrize("ilp", [False, True], ids=["seq", "ilp"])
def test_plain_matches_jax(jax_runs, ilp):
    (a, r, d), want = jax_runs[ilp]
    got = port.chains(a, r, d, N, ilp).numpy()
    assert got.shape == want.shape == (4, N * BLOCKS, 8, 128)
    bound = 1e-6 * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= bound


def test_seq_equals_ilp(jax_runs):
    """Interleaving changes the order of the steps, not their arithmetic."""
    (a, r, d), _ = jax_runs[False]
    np.testing.assert_array_equal(port.chains(a, r, d, N, False).numpy(),
                                  port.chains(a, r, d, N, True).numpy())


@pytest.mark.parametrize("k", [1, 2, 8])
def test_other_chain_counts(k):
    """K chains of the plain version, each equal to the one-chain run."""
    rng = np.random.default_rng(k)
    a = rng.uniform(0.1, 0.2, (2 * N, 8, 128)).astype(np.float32)
    r = rng.uniform(0.9, 1.1, (2 * N, 8, 128)).astype(np.float32)
    d = rng.uniform(0, 1, (k, 2 * N, 8, 128)).astype(np.float32)
    o = port.chains(a, r, d, N, True).numpy()
    for q in range(k):
        np.testing.assert_array_equal(
            o[q], port.chains(a, r, d[q:q + 1], N, False).numpy()[0])


def test_wrong_shapes_raise():
    a = np.zeros((N, 8, 128), np.float32)
    with pytest.raises(ValueError, match="d must be"):
        port.chains(a, a, a, N, True)
    with pytest.raises(ValueError, match="n=32"):
        port.chains(a, a, a[None], 32, True)


def test_main_on_cpu(capsys):
    assert port.main(["--device", "cpu", "--n", "8", "--blocks", "2",
                      "--reps", "1"]) == 0
    out = capsys.readouterr().out
    for name in ("seq@2048", "ilp@2048", "seq@1024", "ilp@6144"):
        assert name in out
