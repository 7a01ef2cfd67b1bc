"""Domain-split load analysis (reference split policies).

The reference balances its 1-D X decomposition three ways (Grid3D.h:56-61,
SplitSegments_X Grid3D.cpp:148-235):

* EVEN_X        — equal plane counts,
* EVEN_SEGMENTS — equal per-plane tridiagonal-system load
                  (Y/Z systems count 1 per plane they start in; X systems
                  spread 1/size per plane they cross),
* EVEN_VOLUME   — equal fluid-cell counts.

XLA's SPMD partitioner only supports equal shard extents, so uneven splits
cannot be materialized directly; instead this module computes the same load
curves and (a) reports the imbalance of the even mesh split (the reference's
``segs_per_X.txt`` diagnostic, Grid3D.cpp:205-212), and (b) derives the
load-optimal *padding* — shifting the domain inside a padded array so the
even split's cut points land near the balanced boundaries.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ..core.types import NodeType
from ..ops import masks


def load_per_plane(types: np.ndarray, policy: str) -> np.ndarray:
    """Per-X-plane load (the reference's acu_sum array)."""
    nx = types.shape[0]
    if policy == "EVEN_X":
        return np.ones(nx)
    if policy == "EVEN_VOLUME":
        return (types == NodeType.IN).reshape(nx, -1).sum(axis=1).astype(float)
    if policy != "EVEN_SEGMENTS":
        raise ValueError(policy)

    acu = np.zeros(nx)
    # Y and Z systems: one unit at the plane they live in
    for ax in (1, 2):
        lc = masks.line_class_3d(types, axis=ax)
        starts = lc.cls_a == masks.BC0
        acu += starts.reshape(nx, -1).sum(axis=1)
    # X systems: 1/size per crossed plane
    lcx = masks.line_class_3d(types, axis=0)
    cls = lcx.cls_a
    ny, nz = types.shape[1], types.shape[2]
    for j in range(ny):
        for k in range(nz):
            line = cls[:, j, k]
            s = None
            for p in range(nx):
                if line[p] == masks.BC0:
                    s = p
                elif line[p] == masks.BC1 and s is not None:
                    acu[s:p + 1] += 1.0 / (p - s + 1)
                    s = None
    return acu


def split_1d(load: np.ndarray, n_shards: int) -> List[int]:
    """Greedy split matching the reference's scan (Grid3D.cpp:214-229)."""
    nx = len(load)
    per = load.sum() / n_shards
    counts = []
    s = load[0]
    i_old = 0
    for i in range(1, nx):
        if s + load[i] > per:
            counts.append(i - i_old)
            i_old = i
            if len(counts) >= n_shards - 1:
                break
            s = 0.0
        s += load[i]
    counts.append(nx - i_old if n_shards > 1 else nx)
    return counts


@dataclasses.dataclass
class SplitReport:
    policy: str
    counts: List[int]            # balanced per-shard plane counts
    even_imbalance: float        # max/mean load ratio of the plain even split
    balanced_imbalance: float

    def __str__(self) -> str:
        return (f"{self.policy}: balanced counts {self.counts}, "
                f"even-split imbalance {self.even_imbalance:.3f}, "
                f"balanced {self.balanced_imbalance:.3f}")


def analyze(types: np.ndarray, n_shards: int, policy: str = "EVEN_VOLUME") -> SplitReport:
    load = load_per_plane(types, policy)
    counts = split_1d(load, n_shards)

    def imbalance(cuts):
        sums = []
        p = 0
        for c in cuts:
            sums.append(load[p:p + c].sum())
            p += c
        sums = np.asarray(sums)
        return float(sums.max() / max(sums.mean(), 1e-30))

    nx = len(load)
    even = [nx // n_shards + (1 if r < nx % n_shards else 0) for r in range(n_shards)]
    return SplitReport(policy=policy, counts=counts,
                       even_imbalance=imbalance(even),
                       balanced_imbalance=imbalance(counts))


def _even_chunk_loads(load: np.ndarray, inserts: List[int], n: int) -> np.ndarray:
    padded = np.insert(load, sorted(inserts), 0.0)
    if len(padded) % n:
        raise ValueError("padded length must divide the shard count")
    return padded.reshape(n, -1).sum(axis=1)


def safe_insert_positions(types: np.ndarray) -> List[int]:
    """X positions where an inert OUT plane can be inserted without touching
    any consumed value: both domain ends, and either side of an all-OUT
    plane (no IN cell is ever adjacent to an all-OUT plane — a BOUND shell
    always intervenes — so no stencil, line class or divergence corner read
    crosses such an insert)."""
    nx = types.shape[0]
    all_out = (types == NodeType.OUT).reshape(nx, -1).all(axis=1)
    pos = {0, nx}
    for i in np.nonzero(all_out)[0]:
        pos.add(int(i))         # insert before plane i
        pos.add(int(i) + 1)     # insert after plane i
    return sorted(pos)


def plan_padding(types: np.ndarray, n_shards: int,
                 policy: str = "EVEN_SEGMENTS",
                 pad_total: int | None = None) -> List[int]:
    """Load-optimal padding: choose positions (into the ORIGINAL x axis,
    "insert before plane p") for the inert padding planes so that the even
    GSPMD cut points land near the reference's balanced split boundaries
    (SplitSegments_X, Grid3D.cpp:148-235).  Greedy: each plane goes where
    it most reduces the max per-shard load."""
    nx = types.shape[0]
    if pad_total is None:
        pad_total = (-nx) % n_shards
    if pad_total == 0:
        return []
    load = load_per_plane(types, policy)
    allowed = safe_insert_positions(types)
    inserts: List[int] = []
    for k in range(pad_total):
        # only lengths divisible by n_shards are scoreable; on the final
        # plane every choice is, before that score against a trailing fill
        rest = pad_total - k - 1
        best = None
        for p in allowed:
            trial = inserts + [p] + [nx] * rest
            cost = float(_even_chunk_loads(load, trial, n_shards).max())
            if best is None or cost < best[0]:
                best = (cost, p)
        inserts.append(best[1])
    return sorted(inserts)


def dump_load(types: np.ndarray, path: str, policy: str = "EVEN_VOLUME") -> None:
    """The reference's segs_per_X.txt diagnostic (Grid3D.cpp:205-212)."""
    load = load_per_plane(types, policy)
    with open(path, "w") as f:
        for i, v in enumerate(load):
            f.write(f"{i}    {v:f}\n")
