"""Running the harness's rehearsal in this process and reading its
result line."""
from __future__ import annotations

import json
import os
import sys

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if CHECKOUT not in sys.path:
    sys.path.insert(0, CHECKOUT)

# small grids on which the cells' cases take the cells' paths: every
# direction on the pair form (a cube), and X's lines past 256 cells, on
# the fallback form, as the 383^3 cell's are
GRID = {"cavity256.auto": "40", "cavity383.auto": "260,10,10",
        "baffle256.auto": "24"}


def rehearse(capsys, workload: str, seed: int, *extra) -> dict:
    from portbench import run
    rc = run.main(["--workload", workload, "--seed", str(seed),
                   "--seconds", "0", "--trace", "0", "--rehearse",
                   "--grid", GRID[workload], *extra])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])
