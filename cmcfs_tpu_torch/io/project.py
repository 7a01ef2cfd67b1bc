"""File discovery / project files (reference src/Common/IO.h:480-494, 591-625)."""
from __future__ import annotations

import os
from typing import Tuple


def find_file(filename: str, check_exist: bool = True) -> str:
    """Resolve relative to cwd, then ../../data/ (reference FindFile)."""
    if os.path.exists(filename) or not check_exist:
        return filename
    alt = os.path.join("..", "..", "data", filename)
    if os.path.exists(alt):
        return alt
    raise FileNotFoundError(f'cannot find the file: "{filename}"')


def load_project(proj_path: str) -> Tuple[str, str, str, str]:
    """Project file: 3 or 4 lines -> (input, field, output, config)."""
    with open(find_file(proj_path)) as f:
        lines = [ln.strip() for ln in f.read().splitlines()]
    lines += [""] * (4 - len(lines))
    t1, t2, t3, t4 = lines[:4]
    if t4:
        return find_file(t1), find_file(t2), t3, find_file(t4)
    return find_file(t1), "", t2, find_file(t3)
