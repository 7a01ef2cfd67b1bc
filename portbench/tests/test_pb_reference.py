"""The reference against the port's CPU path, on both configurations at a
small size: the grid, the initial state, the first step and a window
step agree bit for bit."""
import pytest

from _helpers import rehearse


@pytest.mark.parametrize("workload", ["cavity256.auto", "cavity383.auto",
                                      "baffle256.auto"])
def test_reference_matches_port_cpu(capsys, workload):
    res = rehearse(capsys, workload, 2 ** 31 + 7)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 9
    assert res["metrics"] == {}
    for name, c in res["checks"].items():
        assert c["value"] == 0, (name, c)


def test_rehearsal_takes_the_cells_paths():
    """The small grids take the forms the cells take: the cube every
    direction on the pair form, the long X lines the fallback."""
    from _helpers import CHECKOUT, GRID  # noqa: F401
    from portbench.reference import adi, grid

    for workload, want in (("cavity256.auto", ["pair"] * 3),
                           ("cavity383.auto", ["fallback", "pair", "pair"]),
                           ("baffle256.auto", ["pair"] * 3)):
        shape = tuple(int(n) for n in GRID[workload].split(","))
        shape = shape * 3 if len(shape) == 1 else shape
        g = grid.lid_cavity_grid(shape, 1.0 / (shape[2] - 3), 1.0, 1.0, 1.0,
                                 workload.startswith("baffle"))
        cls = grid.line_classes(g)
        duals = tuple(b is not None for _, b, _ in cls)
        assert duals == (workload.startswith("baffle"), False, False)
        assert adi.paths(g.types.shape, grid.merge_ok(g, cls), duals,
                         2) == want


def test_reference_step_is_deterministic():
    """Two reference steps from one state are equal, on the fallback form
    (a 40^3 cavity's X and Y) and the pair form (its Z)."""
    import numpy as np
    import torch

    from _helpers import CHECKOUT  # noqa: F401
    from portbench.reference import adi, grid

    g = grid.lid_cavity_grid((40, 40, 40), 1.0 / 37, 1.0, 1.0, 1.1, False)
    cls = grid.line_classes(g)
    dirs = ["fallback", "fallback", "pair"]
    ar = adi.Arrays(g, cls, "cpu")
    p = grid.normalized(1000.0, 0.72, 1.4)
    x = adi.update_boundaries(torch.as_tensor(grid.initial_state(g)), ar)
    a, ea = adi.step(x, x, ar, p, 0.002, 2, 2, dirs)
    b, eb = adi.step(x, x, ar, p, 0.002, 2, 2, dirs)
    assert torch.equal(a, b) and float(ea) == float(eb)
    assert np.isfinite(float(ea)) and float(ea) > 0
