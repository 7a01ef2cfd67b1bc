"""The control: the port's bf16 payload mode in the program's place is
found not correct, on three seeds, by the step gaps."""
import pytest

from _helpers import rehearse


@pytest.mark.parametrize("seed", [11, 2 ** 31 + 3, 4_000_000_007])
def test_bf16_control_fails(capsys, seed):
    res = rehearse(capsys, "baffle256.auto", seed, "--control")
    assert not res["correct"]
    checks = res["checks"]
    for tag in ("first_step_gap", "window_step_gap"):
        assert checks[tag]["value"] > 10 * checks[tag]["limit"], checks


@pytest.mark.parametrize("workload", ["cavity256.auto", "cavity383.auto"])
def test_bf16_control_fails_cavity(capsys, workload):
    res = rehearse(capsys, workload, 5, "--control")
    assert not res["correct"]
    assert (res["checks"]["window_step_gap"]["value"]
            > res["checks"]["window_step_gap"]["limit"])
