"""Fluid parameter derivation (reference: src/Common/Geometry.h:538-562)."""
from __future__ import annotations

import dataclasses

import numpy as np

from .config import Config


@dataclasses.dataclass(frozen=True)
class FluidParams:
    v_T: float
    v_vis: float
    t_vis: float
    t_phi: float

    @staticmethod
    def normalized(Re: float, Pr: float, lam: float) -> "FluidParams":
        """From (Re, Pr, lambda) — Geometry.h:545-552. Values rounded to f32."""
        return FluidParams(
            v_T=float(np.float32(1.0)),
            v_vis=float(np.float32(1.0 / Re)),
            t_vis=float(np.float32(1.0 / (Re * Pr))),
            t_phi=float(np.float32((lam - 1.0) / (lam * Re))),
        )

    @staticmethod
    def physical(vis: float, rho: float, R: float, k: float, cv: float) -> "FluidParams":
        """From physical constants — Geometry.h:554-561. Values rounded to f32."""
        return FluidParams(
            v_T=float(np.float32(R)),
            v_vis=float(np.float32(vis / rho)),
            t_vis=float(np.float32(k / (rho * cv))),
            t_phi=float(np.float32(vis / (rho * cv))),
        )

    @staticmethod
    def from_config(cfg: Config) -> "FluidParams":
        if cfg.use_normalized_params:
            return FluidParams.normalized(cfg.Re, cfg.Pr, cfg.lam)
        return FluidParams.physical(cfg.viscosity, cfg.density, cfg.R_specific, cfg.k, cfg.cv)
