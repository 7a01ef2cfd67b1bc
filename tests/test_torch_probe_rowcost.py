"""The port's row-cost probe (cmcfs_tpu_torch/probes/probe_rowcost.py)
against scripts/probe_rowcost.py's Pallas kernel in interpret mode, on the
script's own inputs (``--n 16 --cells 131072``).

Tolerance 1e-6 * max(1, max|JAX|): XLA:CPU may contract the chain's
mul-sub into an FMA where the port rounds the product.  ``noload``
compares row 0 of each block only: the script leaves the other rows
unwritten.
"""
import sys

import jax
import numpy as np
import pytest

import scripts.probe_rowcost as script
from cmcfs_tpu_torch.probes import probe_rowcost as port
from torch_probe_jax import record_pallas

N, CELLS = 16, 131072
NAMES = {(8, 128, False): "base", (8, 128, True): "noload",
         (16, 128, False): "wide_j", (8, 256, False): "wide_l",
         (8, 512, False): "wide4"}


@pytest.fixture(scope="module")
def jax_runs():
    """{variant: ((a, r, d), o)} of the script's run."""
    with pytest.MonkeyPatch.context() as mp:
        records = record_pallas(mp)
        mp.setattr(sys, "argv", ["probe_rowcost.py", "--n", str(N),
                                 "--cells", str(CELLS), "--reps", "1"])
        with jax.disable_jit():
            script.main()
    out = {}
    for rec in records:
        c = rec.consts
        out[NAMES[(c["sub"], c["lanes"], c["noload"])]] = (
            rec.inputs, np.asarray(rec.outputs))
    assert set(out) == set(NAMES.values())
    return out


def _within(got, want):
    bound = 1e-6 * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= bound


@pytest.mark.parametrize("variant", list(NAMES.values()))
def test_plain_matches_jax(jax_runs, variant):
    (a, r, d), want = jax_runs[variant]
    got = port.chain(a, r, d, N, variant).numpy()
    if variant == "noload":
        want = want.reshape(-1, N, *want.shape[1:])[:, 0]
    assert got.shape == want.shape
    _within(got, want)


def test_strided_matches_jax_base(jax_runs):
    """base's chains on the chain-major copy give base's rows back."""
    (a, r, d), want = jax_runs["base"]
    cm = [port.chain_major(port.common.as_f32(x), N) for x in (a, r, d)]
    got = port.from_chain_major(port.chain(*cm, N, "strided"), 8, 128)
    _within(got.numpy(), want)


def test_fma_variant_plain_is_base(jax_runs):
    (a, r, d), want = jax_runs["base"]
    got = port.chain(a, r, d, N, "base_fma").numpy()
    np.testing.assert_array_equal(got, port.chain(a, r, d, N, "base").numpy())
    _within(got, want)


def test_wrong_shapes_raise():
    a = np.zeros((N * 2, 8, 128), np.float32)
    with pytest.raises(ValueError, match="wide_j"):
        port.chain(a, a, a, N, "wide_j")
    with pytest.raises(ValueError, match="chain-major"):
        port.chain(a, a, a, N, "strided")
    with pytest.raises(ValueError, match="unknown"):
        port.chain(a, a, a, N, "wide9")


def test_main_on_cpu(capsys):
    """Every variant and the chain sweep run, each equal to its plain
    version, and the table names the device."""
    assert port.main(["--device", "cpu", "--n", "8", "--cells", "32768",
                      "--reps", "1", "--chains", "1024,2048"]) == 0
    out = capsys.readouterr().out
    for name in list(port.VARIANTS) + ["strided@2048"]:
        assert name in out
    assert "cpu: the plain PyTorch versions" in out
