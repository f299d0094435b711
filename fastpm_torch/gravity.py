"""The PM force solver (reference: libfastpm/gravity.c).

Port of the single-device forces of fastpm_tpu/gravity.py, under the
JAX names:

- compute_force_carry (gravity.py:188-257): one species with a scalar
  mass and the CIC painter. Sort the store by cell, paint (K1), r2c,
  softening, the potential transfer, three gradient c2r, and read out
  (K2). The store comes back in cell order: particle order is not
  physical, and writers sort by id.
- compute_force_stale (gravity.py:378-416): the carry force without
  its sort, for a store still in the order of an earlier carry force
  (stale-order stepping, SolverConfig.stale_every).
- compute_force (gravity.py:65-158): every other case, such as CDM plus
  ncdm with its mass column. All species are painted into one canvas
  (paint_delta_k; K3 for CIC) and the force is read out per species
  (Painter.readout3; K4 for CIC). Row order is kept: with the CIC
  kernels each species' cell order is computed once a step and serves
  both K3 and K4, which read their rows in it (K4 scatters the values
  back), so the stores are never permuted.

carry_eligible picks between them, as the JAX solver does.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .mesh import PM
from .painter import Painter
from .store import Store
from .ops import cic
from . import kernels

__all__ = ["paint_delta_k", "compute_force", "carry_eligible",
           "compute_force_carry", "compute_force_stale"]


def _force_fields(pm: PM, delta_k, kernel_type: str, softening_type: str):
    """(softened delta_k, the three acceleration fields) from the
    overdensity transform (gravity.c:457-529)."""
    delta_k = kernels.apply_softening(pm, delta_k, softening_type)
    pot_k = kernels.apply_kernel_transfer(pm, delta_k, kernel_type,
                                          "potential")
    return delta_k, pm.c2r_grad3(pot_k, kernels.kernel_orders(kernel_type)[1])


def paint_delta_k(pm: PM, painter: Painter, stores: Sequence[Store],
                  orders=None):
    """Paint all species into one canvas and return the overdensity
    transform delta_k (_fastpm_solver_compute_delta_k, gravity.c:304-356).
    orders: one CellOrder (or None) per species, handed to the painter.

    The canvas entering r2c is 1 + delta: mass per cell over the mean
    mass per cell. The total mass is M0 * N for a scalar-mass species
    plus the sum of the mass column for a species that has one; the sum
    stays on the device (float64)."""
    canvas = None
    total_mass = 0.0
    for p, order in zip(stores, orders or [None] * len(stores)):
        if p.mass is not None:
            total_mass = total_mass + p.mass.sum(dtype=torch.float64)
            canvas = painter.paint(p.x, p.mass, canvas, order)
        else:
            total_mass = total_mass + p.M0 * p.np_local
            canvas = painter.paint(p.x, float(np.float32(p.M0)), canvas,
                                   order)
    return pm.r2c(canvas / (total_mass / pm.Norm))


def compute_force(pm: PM, painter: Painter, stores: Sequence[Store],
                  kernel_type: str = "1_4", softening_type: str = "none"):
    """Accelerations of every species (fastpm_solver_compute_force,
    gravity.c:457-529), in row order.

    Returns (stores with acc filled, delta_k). delta_k has the softening
    applied but not the deCIC compensation (the caller applies that for
    the power spectrum event, solver.c:466-471)."""
    orders = [cic.cell_order(p.x, pm.Nmesh, pm.InvCellSize)
              if painter.is_cic else None for p in stores]
    delta_k = paint_delta_k(pm, painter, stores, orders)
    delta_k, (f0, f1, f2) = _force_fields(pm, delta_k, kernel_type,
                                          softening_type)
    return ([p.replace(acc=painter.readout3(f0, f1, f2, p.x, order))
             for p, order in zip(stores, orders)], delta_k)


def carry_eligible(painter: Painter, stores: Sequence[Store]) -> bool:
    """Whether compute_force_carry can serve these species: one species
    with a scalar mass, painted with CIC."""
    return (painter.is_cic and len(stores) == 1
            and stores[0].mass is None)


def compute_force_carry(pm: PM, painter: Painter, store: Store,
                        kernel_type: str = "1_4",
                        softening_type: str = "none"):
    """The order-free force of one scalar-mass species
    (compute_force_carry, gravity.py:188-257); the caller checks
    carry_eligible first.

    Returns (store sorted by cell with acc filled, delta_k), with delta_k
    as compute_force returns it. K1 and K2 are called directly on the
    cell-sorted store, as the JAX carry force calls the from8 kernels."""
    # every column but acc (overwritten below) rides the sort
    store = store.replace(acc=None).take(
        cic.sort_by_cell(store.x, pm.Nmesh, pm.InvCellSize))
    return _force_in_order(pm, store, kernel_type, softening_type)


def compute_force_stale(pm: PM, painter: Painter, store: Store,
                        kernel_type: str = "1_4",
                        softening_type: str = "none"):
    """The stale-order force (compute_force_stale, gravity.py:378-416):
    for a store already in the cell order of an earlier
    compute_force_carry, the carry force without the sort. K1 and K2 run
    on the carried order, from which the particles have drifted.

    Returns (store in its given order with acc filled, delta_k), as
    compute_force_carry. The JAX stale force needs a window map, a range
    table, a side bundle of movers with a cap (maxm) and an overflow
    count (nbad), because its TPU kernels read DMA'd windows of C cells
    (ops/stale.py). K1 and K2 take particles in any order, so here there
    are no movers and no overflow, and the result is exact whatever the
    drift; only the kernels' locality decays with it."""
    return _force_in_order(pm, store.replace(acc=None), kernel_type,
                           softening_type)


def _force_in_order(pm: PM, store: Store, kernel_type: str,
                    softening_type: str):
    """The body of the carry and stale forces: K1, the force fields and
    K2 on the store's rows in their order."""
    canvas = cic.cic_paint(store.x, pm.Nmesh, pm.InvCellSize,
                           float(np.float32(store.M0)))
    mean_mass_per_cell = store.M0 * store.np_local / pm.Norm
    delta_k = pm.r2c(canvas / mean_mass_per_cell)
    del canvas
    delta_k, fields = _force_fields(pm, delta_k, kernel_type,
                                    softening_type)
    acc = cic.cic_readout(fields, store.x, pm.InvCellSize)
    return store.replace(acc=acc), delta_k
