"""The PM force solver (reference: libfastpm/gravity.c).

Port of the single-device order-free force of fastpm_tpu/gravity.py
(compute_force_carry, gravity.py:188-257): sort the store by cell, paint
(K1), r2c, softening, the potential transfer, three gradient c2r, and
read out (K2). The store comes back in cell order: particle order is not
physical, and writers sort by id. The port runs this form on every
device and every mesh size.
"""

from __future__ import annotations

import numpy as np

from .mesh import PM
from .painter import Painter
from .store import Store
from .ops.cic import sort_by_cell
from . import kernels

__all__ = ["compute_force"]


def compute_force(pm: PM, painter: Painter, store: Store,
                  kernel_type: str = "1_4", softening_type: str = "none"):
    """Accelerations of a single scalar-mass species
    (fastpm_solver_compute_force, gravity.c:457-529).

    Returns (store sorted by cell with acc filled, delta_k). delta_k has
    the softening applied but not the deCIC compensation (the caller
    applies that for the power spectrum event, solver.c:466-471). The
    painted canvas is 1 + delta: mass per cell over the mean mass per
    cell (gravity.c:304-356)."""
    # every column but acc (overwritten below) rides the sort
    store = store.replace(acc=None).take(
        sort_by_cell(store.x, pm.Nmesh, pm.InvCellSize))
    canvas = painter.paint(store.x, float(np.float32(store.M0)))
    mean_mass_per_cell = store.M0 * store.np_local / pm.Norm
    delta_k = pm.r2c(canvas / mean_mass_per_cell)
    del canvas
    delta_k = kernels.apply_softening(pm, delta_k, softening_type)
    pot_k = kernels.apply_kernel_transfer(pm, delta_k, kernel_type,
                                          "potential")
    f0, f1, f2 = pm.c2r_grad3(pot_k, kernels.kernel_orders(kernel_type)[1])
    del pot_k
    acc = painter.readout3(f0, f1, f2, store.x)
    return store.replace(acc=acc), delta_k
