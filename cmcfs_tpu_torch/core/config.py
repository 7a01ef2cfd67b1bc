"""Typed config with the reference parser's exact key semantics.

The reference (src/Common/Config.h:195-271) scans whitespace-separated tokens;
a token matching a known key consumes the following token(s) as its value, any
other token is silently ignored.  Notable quirks we preserve deliberately:

* all floats are parsed at float32 precision and then widened
  (Config.h:116-135 ``ReadDouble`` goes through ``%f``),
* the slip-strength key is spelled ``bc_strenght`` (Config.h:219),
* the shipped 2D configs use ``calc_subframes``/``out_subframes`` which the
  parser does NOT recognize, so 2D runs fall back to the defaults
  ``time_steps=50`` / ``out_time_steps=10`` (Config.h:230-233),
* ``out_fmt`` maps anything other than "NetCDF" to MultiVox (Config.h:176-182),
* any of ``Re``/``Pr``/``lambda`` flips the run into normalized-parameter mode
  (Config.h:214-216),
* 2D problems force ``in_fmt = Shape2D`` (Config.h:258).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


class ConfigError(ValueError):
    """Raised where the reference would print a message and exit(0)."""


def _f32(tok: str) -> float:
    """Parse like C's %f into float then widen (Config.h:116-135)."""
    try:
        return float(np.float32(tok))
    except ValueError:
        return 0.0


def _i(tok: str) -> int:
    try:
        return int(tok)
    except ValueError:
        return 0


@dataclasses.dataclass
class Config:
    # defaults: reference Config.h:76-114
    problem_dim: Optional[str] = None            # "2D" | "3D"
    in_fmt: Optional[str] = None                 # "Shape2D" | "Shape3D" | "SeaNetCDF"
    out_fmt: Optional[str] = None                # "NetCDF" | "MultiVox"

    dx: float = -1.0
    dy: float = -1.0
    dz: float = -1.0

    use_normalized_params: bool = False
    viscosity: float = 0.05
    density: float = 1000.0
    Re: float = -1.0
    Pr: float = -1.0
    lam: float = -1.0

    bc_noslip: bool = True
    bc_strength: float = 0.5
    bc_inV: tuple = (0.0, 0.0, 0.0)
    bc_inT: float = 1.0

    depth: float = -1.0
    depth_var: float = 0.0

    # thermodynamic constants (water; Config.h:79-82)
    R_specific: float = 461.495
    k: float = 0.6
    cv: float = 4200.0
    baseT: float = 1.0

    cycles: int = 1
    time_steps: int = 50
    out_time_steps: int = 10
    frame_time: float = -1.0

    outdimx: int = 50
    outdimy: int = 50
    outdimz: int = 50
    out_vars: List[str] = dataclasses.field(default_factory=list)

    solver: Optional[str] = None                 # "Explicit" | "ADI" | "Stable"
    num_global: int = 2
    num_local: int = 1

    @staticmethod
    def load(path: str) -> "Config":
        with open(path, "r") as f:
            toks = f.read().split()
        return Config.parse_tokens(toks)

    @staticmethod
    def parse_tokens(toks: List[str]) -> "Config":
        cfg = Config()
        i = 0
        n = len(toks)

        def nxt() -> str:
            nonlocal i
            if i >= n:
                return ""
            t = toks[i]
            i += 1
            return t

        while i < n:
            t = nxt()
            if t == "dimension":
                cfg.problem_dim = "2D" if nxt() == "2D" else "3D"
            elif t == "in_fmt":
                v = nxt()
                if v in ("Shape2D", "Shape3D", "SeaNetCDF"):
                    cfg.in_fmt = v
            elif t == "viscosity":
                cfg.viscosity = _f32(nxt())
            elif t == "density":
                cfg.density = _f32(nxt())
            elif t == "Re":
                cfg.use_normalized_params = True
                cfg.Re = _f32(nxt())
            elif t == "Pr":
                cfg.use_normalized_params = True
                cfg.Pr = _f32(nxt())
            elif t == "lambda":
                cfg.use_normalized_params = True
                cfg.lam = _f32(nxt())
            elif t == "bc_type":
                cfg.bc_noslip = nxt() == "NoSlip"
            elif t == "bc_strenght":  # sic — reference Config.h:219
                cfg.bc_strength = _f32(nxt())
            elif t == "bc_initv":
                cfg.bc_inV = (_f32(nxt()), _f32(nxt()), _f32(nxt()))
            elif t == "bc_initT":
                cfg.bc_inT = _f32(nxt())
            elif t == "grid_dx":
                cfg.dx = _f32(nxt())
            elif t == "grid_dy":
                cfg.dy = _f32(nxt())
            elif t == "grid_dz":
                cfg.dz = _f32(nxt())
            elif t == "cycles":
                cfg.cycles = _i(nxt())
            elif t == "frame_time":
                cfg.frame_time = _f32(nxt())
            elif t == "time_steps":
                cfg.time_steps = _i(nxt())
            elif t == "out_vars":
                cnt = _i(nxt())
                cfg.out_vars = [nxt() for _ in range(cnt)]
            elif t == "out_time_steps":
                cfg.out_time_steps = _i(nxt())
            elif t == "out_gridx":
                cfg.outdimx = _i(nxt())
            elif t == "out_gridy":
                cfg.outdimy = _i(nxt())
            elif t == "out_gridz":
                cfg.outdimz = _i(nxt())
            elif t == "out_fmt":
                cfg.out_fmt = "NetCDF" if nxt() == "NetCDF" else "MultiVox"
            elif t == "depth":
                cfg.depth = _f32(nxt())
            elif t == "depth_var":
                cfg.depth_var = _f32(nxt())
            elif t == "solver":
                v = nxt()
                if v in ("Explicit", "ADI", "Stable"):
                    cfg.solver = v
            elif t == "num_global":
                cfg.num_global = _i(nxt())
            elif t == "num_local":
                cfg.num_local = _i(nxt())
            # unknown tokens are ignored (reference scans and skips)

        cfg.validate()
        return cfg

    def validate(self) -> None:
        # reference Config.h:249-270
        if self.problem_dim is None:
            raise ConfigError("must specify problem dimension!")
        if self.solver is None:
            raise ConfigError("must specify solver!")
        if self.out_fmt is None:
            raise ConfigError("must specify output format!")
        if self.frame_time < 0 and self.in_fmt == "SeaNetCDF":
            raise ConfigError("must specify frame time!")
        if self.dx < 0:
            raise ConfigError("cannot find dx!")
        if self.dy < 0:
            raise ConfigError("cannot find dy!")
        if self.problem_dim == "2D":
            self.in_fmt = "Shape2D"
        if self.problem_dim == "3D":
            if not self.out_vars:
                raise ConfigError("must output at least 1 var!")
            if self.in_fmt is None:
                raise ConfigError("must specify input format!")
            if self.dz < 0:
                raise ConfigError("cannot find dz!")
            if self.in_fmt == "Shape2D" and self.depth < 0:
                raise ConfigError("cannot find depth!")
            if self.out_fmt == "MultiVox":
                raise ConfigError("MultiVox output format is not supported for 3D modes")
        if self.use_normalized_params and (self.Re < 0 or self.Pr < 0 or self.lam < 0):
            raise ConfigError("must specify Re, Pr and lambda!")
