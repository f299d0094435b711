"""2LPT initial displacements (reference: libfastpm/pm2lpt.c).

Port of fastpm_tpu/lpt.py: ~10 FFTs + readouts. The six readouts (nine
with a growth-rate table) are CIC, so on a CUDA tensor they launch the
K2 kernel (one field each).

Conventions (pm_2lpt_solve):
- dx1_d = readout_q[ c2r( diff_d( laplace(delta_k) ) ) ]
- 2LPT source = sum_d [ phi,d1d1 phi,d2d2 - phi,d1d2^2 ] with
  (d1,d2) in {(1,2),(2,0),(0,1)} computed via double-diff fields
- dx2_d = 3/7 * readout_q[ c2r( diff_d( laplace( r2c(source) ) ) ) ]
- laplace order = potorder of the kernel type, diff order = difforder
  (gravity.c:110-171); particles are de-shifted before readout.

pm_2lpt_evolve: x = q + D1 dx1 + D2 dx2,
v = (dx1 f1 D1 + dx2 f2 D2) a^2 E (internal velocity units).
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import PM
from . import transfers
from .painter import Painter
from .kernels import kernel_orders
from .cosmology import Cosmology
from .store import Store

__all__ = ["lpt_solve", "lpt_evolve"]


def lpt_solve(pm: PM, delta_k, q, kernel_type: str = "1_4",
              growth_rate_func_k=None):
    """Compute (dx1, dx2[, dv1]) at Lagrangian positions q (N,3).

    q should already include any half-cell shift handling: the reference
    de-shifts before readout (pm2lpt.c:27-34); pass the unshifted lattice.
    With growth_rate_func_k (a FuncK of the linear growth rate f(k)), dv1
    is the 1LPT displacement weighted by f(k), read out from three more
    c2r (the ncdm velocities). Returns float32 tensors (N,3).
    """
    potorder, gradorder, difforder, deconvolveorder = kernel_orders(kernel_type)
    painter = Painter(pm, "cic")

    def pot(dk):
        return transfers.apply_laplace(pm, dk, potorder)

    def diff(dk, d):
        return transfers.apply_diff(pm, dk, d, difforder)

    dx1, dv1 = [], []
    for d in range(3):
        w = diff(pot(delta_k), d)
        dx1.append(painter.readout(pm.c2r(w), q))
        if growth_rate_func_k is not None:
            wv = transfers.apply_any(pm, w, growth_rate_func_k)
            dv1.append(painter.readout(pm.c2r(wv), q))
    dx1 = torch.stack(dx1, dim=-1)

    D1 = (1, 2, 0)
    D2 = (2, 0, 1)
    phi_ii = [pm.c2r(diff(diff(pot(delta_k), d), d)) for d in range(3)]
    source = (phi_ii[D1[0]] * phi_ii[D2[0]]
              + phi_ii[D1[1]] * phi_ii[D2[1]]
              + phi_ii[D1[2]] * phi_ii[D2[2]])
    del phi_ii
    for d in range(3):
        phi_ij = pm.c2r(diff(diff(pot(delta_k), D1[d]), D2[d]))
        source = source - phi_ij * phi_ij
    source_k = pm.r2c(source)
    del source

    dx2 = torch.stack([
        painter.readout(pm.c2r(diff(pot(source_k), d)) * (3.0 / 7), q)
        for d in range(3)], dim=-1)
    if growth_rate_func_k is not None:
        return dx1, dx2, torch.stack(dv1, dim=-1)
    return dx1, dx2


def lpt_evolve(c: Cosmology, a0: float, store: Store, za_only: bool = False):
    """Set positions/velocities from the LPT displacements at a0
    (pm_2lpt_evolve, pm2lpt.c:166-210). Returns the updated store with
    a_x = a_v = a0."""
    gi = c.growth_info(a0)
    E = c.E(a0)
    D1, D2, f1, f2 = gi.D1, gi.D2, gi.f1, gi.f2
    dv1_prefac = D1 * a0 * a0 * E
    Dv1 = dv1_prefac * f1
    Dv2 = D2 * a0 * a0 * E * f2
    if za_only:
        D2 = 0.0
        Dv2 = 0.0

    def f32(a):
        return float(np.float32(a))

    x = store.x + f32(D1) * store.dx1 + f32(D2) * store.dx2
    v = store.v + f32(Dv2) * store.dx2
    if store.dv1 is not None:
        v = v + f32(dv1_prefac) * store.dv1
    else:
        v = v + f32(Dv1) * store.dx1
    return store.replace(x=x, v=v, a_x=a0, a_v=a0)
