"""Constrained Gaussian realizations: Hoffman-Ribak peak constraints
(reference: libfastpm/constrainedgaussian.c).

Builds the 2-point correlation xi(r) from P(k) by a log-k trapezoid
integral, evaluates the constraint covariance Cij at the (periodic-
wrapped) constraint separations, solves the small linear system, and adds
the correction field sum_i e_i xi(|x - x_i|) to the realization.

Note the delta_k entering has its DC mode set to 1 (rho convention), so
the constraint values are (1 + c*sigma) like the reference.

Port of fastpm_tpu/constrained.py, in its host float64 arithmetic: one
c2r on the field's device, the field to the host, the correction field
in numpy, and one r2c back on the device. It runs once a run, at the
ICs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from .mesh import PM
from .powerspectrum import FuncK

__all__ = ["TwoPointCF", "apply_constraints"]


class TwoPointCF:
    """xi(r) table from P(k) (fastpm_2pcf_from_powerspectrum):
    xi(r) = int dlnk k^3 P(k)/(2 pi^2) sinc(kr), trapezoid over
    log k in [-10, 5] with 10000 steps."""

    def __init__(self, pk: FuncK, r_max: float, steps: int):
        self.size = steps
        self.step_size = r_max / steps
        logk = np.linspace(-10, 5, 10001)[1:]
        k = np.exp(logk)
        w = pk(k) * k ** 3
        r = np.arange(steps + 1) * self.step_size
        kr = k[None, :] * r[:, None]
        with np.errstate(invalid="ignore"):
            sinc = np.where(kr > 0, np.sin(kr) / np.where(kr > 0, kr, 1), 1.0)
        integ = w[None, :] * sinc
        # trapezoid matching the reference's running-sum form
        res = 0.5 * (integ[:, :-1] + integ[:, 1:]).sum(axis=1)
        # the reference includes a half-contribution of the first sample
        res += 0.5 * integ[:, 0]
        dlogk = (5 - (-10)) / 10000.0
        self.xi = res * dlogk / (2 * 3.141593 ** 2)

    def __call__(self, r):
        r = np.asarray(r, dtype=np.float64)
        rmax = self.size * self.step_size
        i = np.clip((r / self.step_size).astype(int), 0, self.size - 1)
        frac = r / self.step_size - i
        val = self.xi[i] + (self.xi[i + 1] - self.xi[i]) * frac
        return np.where(r > rmax, 0.0, val)


def apply_constraints(pm: PM, delta_k, constraints: Sequence[Sequence[float]],
                      pk: FuncK, log=None):
    """Apply peak constraints {(x, y, z, peak-sigma)} to delta_k
    (fastpm_cg_apply_constraints). Returns the constrained delta_k."""
    constraints = np.asarray(constraints, dtype=np.float64)
    n = len(constraints)
    xi = TwoPointCF(pk, r_max=pm.BoxSize[0], steps=pm.Nmesh[0])

    delta_x = pm.c2r(delta_k).cpu().numpy().astype(np.float64)
    sigma = math.sqrt(((delta_x - 1.0) ** 2).sum() / (pm.Norm - 1))
    if log:
        log.info("Measured sigma on the grid = %g", sigma)

    # readout at constraint grid cells (truncation, not CIC --
    # constrainedgaussian.c:76-102)
    idx = (constraints[:, :3] * np.asarray(pm.InvCellSize)).astype(int)
    idx = idx % np.asarray(pm.Nmesh)
    dfi = delta_x[idx[:, 0], idx[:, 1], idx[:, 2]].copy()
    target = 1 + constraints[:, 3] * sigma
    rhs = target - dfi

    # covariance of constraints (periodic separations)
    L = np.asarray(pm.BoxSize)
    dx = constraints[:, None, :3] - constraints[None, :, :3]
    dx = (dx + L / 2) % L - L / 2
    r = np.sqrt((dx ** 2).sum(axis=-1))
    Cij = xi(r)
    e = np.linalg.solve(Cij, rhs)

    # correction field: sum_i e_i xi(|x - x_i|), vectorized on the grid
    grids = np.meshgrid(*[np.arange(nm) * cs for nm, cs
                          in zip(pm.Nmesh, pm.CellSize)], indexing="ij")
    corr = np.zeros(pm.rshape)
    for i in range(n):
        rr = 0.0
        for d in range(3):
            dd = grids[d] - constraints[i, d]
            dd = (dd + L[d] / 2) % L[d] - L[d] / 2
            rr = rr + dd * dd
        corr += e[i] * xi(np.sqrt(rr))
    delta_x = delta_x + corr

    if log:
        dfi2 = delta_x[idx[:, 0], idx[:, 1], idx[:, 2]]
        for i in range(n):
            log.info("After constraints, Realization x[] = %g %g %g "
                     "overdensity = %g, peak-sigma= %g",
                     constraints[i, 0], constraints[i, 1],
                     constraints[i, 2], dfi2[i] - 1.0,
                     (dfi2[i] - 1.0) / sigma)
    return pm.r2c(torch.from_numpy(delta_x.astype(np.float32)).to(
        delta_k.device))
