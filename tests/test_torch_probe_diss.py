"""The port's in-kernel dissipation probe
(cmcfs_tpu_torch/probes/probe_diss_bitwise.py) against
scripts/probe_diss_bitwise.py's Pallas kernel in interpret mode, on the
script's own inputs (``--n 16``).

Tolerance 1e-6 * max(1, max|JAX|): XLA:CPU may contract the sum of
products into FMAs where the port rounds every operation.  The port's
interior comparison reproduces the line the script prints from the same
arrays.
"""
import contextlib
import io
import sys

import jax
import numpy as np
import pytest

import scripts.probe_diss_bitwise as script
from cmcfs_tpu.ops import stencil as jax_stencil
from cmcfs_tpu_torch.probes import probe_diss_bitwise as port
from torch_probe_jax import record_pallas

N = 16


@pytest.fixture(scope="module")
def jax_run():
    """((scal, u, v, w), out, the printed line) of the script's run."""
    with pytest.MonkeyPatch.context() as mp:
        records = record_pallas(mp)
        mp.setattr(sys, "argv", ["probe_diss_bitwise.py", "--n", str(N)])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            script.main()
    (rec,) = records
    return rec.inputs, np.asarray(rec.outputs), buf.getvalue().strip()


def test_scal_is_the_scripts(jax_run):
    np.testing.assert_array_equal(port.inv2h(), jax_run[0][0])


@pytest.mark.parametrize("rounded", [True, False],
                         ids=["rounded", "contracted"])
def test_plain_matches_jax(jax_run, rounded):
    (scal, u, v, w), want, _ = jax_run
    got = port.diss(u, v, w, scal, rounded).numpy()
    assert got.shape == want.shape == (N, 8, 128)
    bound = 1e-6 * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= bound


def test_interior_comparison_matches_script(jax_run):
    (scal, u, v, w), got, line = jax_run
    want = np.asarray(jax.jit(jax_stencil.diss_x_3d, static_argnums=(3, 4, 5))(
        u, v, w, *port.H))
    same, frac, rel = port.compare_interior(got, want)
    assert line.endswith(f"bitwise={same}  mismatch_frac={frac:.2e}  "
                         f"max_rel={rel:.3e}")


def test_edges_are_clamped():
    """At an edge the clamped neighbour is the cell itself: a field linear
    along x has half the slope there."""
    x = np.arange(6, dtype=np.float32)
    u = np.broadcast_to(x[:, None, None], (6, 3, 4)).copy()
    zero = np.zeros_like(u)
    out = port.diss(u, zero, zero, np.ones(3, np.float32)).numpy()
    np.testing.assert_array_equal(out[1:-1], 8.0)     # 2 * (2 * 1)^2
    np.testing.assert_array_equal(out[[0, -1]], 2.0)  # 2 * 1^2


def test_main_on_cpu(capsys):
    assert port.main(["--device", "cpu", "--n", "8", "--reps", "1"]) == 0
    out = capsys.readouterr().out
    assert "rounded@8x8x128" in out and "contracted@256x256x256" in out
    assert "vs stencil.diss_x_3d" in out
