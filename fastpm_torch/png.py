"""Primordial non-Gaussianity: fNL-local initial conditions
(reference: libfastpm/pngaussian.c).

Port of fastpm_tpu/png.py. Runs once a run, at the ICs: the two |k|
transfers are evaluated in float64 on the host grid and cast
(transfers.apply_any with host_tables=True); the rest runs on the
field's device.

Phi = phi + fNL (phi^2 - <phi^2>) in real space from the primordial
potential spectrum P_Phi(k) = (9/25)(2 pi^2) A_s k^-3 (k/k_pivot)^(n_s-1)
(CAMB conventions), with the quadratic piece lowpass-truncated at
kmax_primordial to avoid Dirac foldings; then transferred back to the
matter overdensity via T(k) = sqrt(P(k)/P_Phi(k)).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .mesh import PM
from . import transfers, ic
from .powerspectrum import FuncK

__all__ = ["PNGaussian"]


@dataclass
class PNGaussian:
    fNL: float
    kmax_primordial: float
    pk: FuncK                 # linear matter power at z=0
    h: float
    scalar_amp: float
    scalar_pivot: float       # in 1/Mpc (CAMB); divided by h internally
    scalar_spectral_index: float
    type: str = "local"

    def potential_power(self, k):
        """P_Phi(k), k in h/Mpc (pngaussian.c:8-91)."""
        k = np.asarray(k, dtype=np.float64)
        k_pivot = self.scalar_pivot / self.h
        with np.errstate(divide="ignore", invalid="ignore"):
            p = (self.scalar_amp / np.where(k > 0, k, 1.0) ** 3
                 * np.where(k > 0, k / k_pivot, 1.0)
                 ** (self.scalar_spectral_index - 1.0)
                 * 9.0 / 25.0 * 2.0 * math.pi ** 2)
        return np.where(k == 0, 0.0, p)

    def transfer_function(self, k):
        """sqrt(P(k)/P_Phi(k)) (pngaussian.c:93-103)."""
        k = np.asarray(k, dtype=np.float64)
        pot = self.potential_power(k)
        with np.errstate(divide="ignore", invalid="ignore"):
            t = np.sqrt(self.pk(k) / np.where(pot > 0, pot, 1.0))
        return np.where(k == 0, 0.0, t)

    def induce_correlation(self, pm: PM, delta_k):
        """white noise delta_k -> non-Gaussian matter delta_k
        (fastpm_png_induce_correlation)."""
        # 1. shape white noise into the primordial potential phi
        dk = transfers.apply_any(
            pm, delta_k, lambda k: np.sqrt(self.potential_power(k)
                                           / pm.Volume),
            host_tables=True)
        # 2. phi -> phi + fNL (phi_trunc^2 - <phi_trunc^2>)
        g_x = pm.c2r(dk)
        g2k = transfers.apply_lowpass(pm, dk, self.kmax_primordial)
        g_x2 = pm.c2r(g2k)
        # a float32 mean over the mesh, as the JAX package takes it; the
        # order of the sum differs (a relative 1e-7)
        avg_g2 = float(torch.mean(g_x2.to(torch.float32) ** 2))
        g_x = g_x + float(np.float32(self.fNL)) * (g_x2 * g_x2 - avg_g2)
        dk = pm.r2c(g_x)
        # 3. transfer potential to matter overdensity
        return transfers.apply_any(pm, dk, self.transfer_function, host_tables=True)
