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
  ncdm with its mass column, or a run that asks for the potential or
  the tidal tensor at the particles. All species are painted into one
  canvas (paint_delta_k; K3 for CIC) and the force is read out per
  species (Painter.readout3; K4 for CIC), then the potential (one c2r,
  one K4 launch of one field) and the tidal tensor (six c2r, two K4
  launches of three fields) where asked. Row order is kept: with the
  CIC kernels each species' cell order is computed once a step and
  serves K3 and every K4 launch, which read their rows in it (K4
  scatters the values back), so the stores are never permuted.

carry_eligible picks between them, as the JAX solver does.

Every force, on one card and over ranks (parallel/psolver.py), shares
one k-space stage, acc_fields: the three acceleration fields of a
softened delta_k on a k-space geometry (a PM, or a rank's KShard), each
gradient one pass of ops/kspace.py handed to the caller's inverse.
potential_tidal makes and reads the potential and tidal fields through
the same inverse. The carry and stale forces share one body,
_force_in_order, which benchlib's order-free steps run too.

The force's transforms are unnormalised (ops/fft.py) and its scales
ride passes it makes anyway: the canvas is painted as (1 + delta) / Norm
(K1 deposits 1 / N a particle; the multi-species canvas is divided by
the total mass), so its transform is the unitary delta_k that PM.r2c
would give, and each gradient goes to c2r unscaled.

Each takes an optional delta_transfer(delta_k) -> delta_k, applied to
the softened delta_k before the potential kernel, and returns the
transferred delta_k: the neutrino linear response (solver.py) goes in
there. It is the JAX package's split of the force around the response's
host round trip (jit_pre / jit_post, solver.py:912-955) as one eager
call.

Each phase of a force runs in a `prof` clock, a span of the profiler's
trace while prof.enable_sync is on, named under the Solver's `force`:
`force.order` (the cell sort and its gathers, or the cell orders),
`force.paint` (K1, or K3 and the division by the total mass),
`force.r2c` and `force.c2r` (each FFT, ops/fft.py), `force.kspace`
(the softening, the transfer, the potential and tidal transfers and
each gradient: on the card one k-space kernel launch, ops/kspace.py)
and `force.readout` (K2 or K4). The bodies over ranks have the stage's
spans: `force.kspace`, and `force.c2r` with each inverse's gather.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .mesh import PM
from .painter import Painter
from .store import Store
from .ops import cic, fft, kspace
from . import kernels, prof

__all__ = ["paint_delta_k", "compute_force", "carry_eligible",
           "compute_force_carry", "compute_force_stale", "acc_fields",
           "potential_tidal"]


def acc_fields(kpm: PM, delta_k, kernel_type: str, c2r):
    """The force's k-space stage: the three acceleration fields of a
    softened, transferred delta_k on the k-space geometry kpm (a PM, or
    a rank's parallel.pfft.KShard), delta_k kept. Each gradient is one
    pass over delta_k (ops/kspace.py: a kernel launch on the card, its
    plain version on the CPU), handed to c2r(g) -> field, the caller's
    inverse (fft.c2r on one card; over ranks the shard's inverse and the
    gather its readout needs), and let go as its field is made."""
    fields = []
    for d in range(3):
        with prof.clock("force.kspace"):
            g = kspace.force_grad_k(kpm, delta_k, d, kernel_type)
        with prof.clock("force.c2r"):
            fields.append(c2r(g))
        del g
    return fields


def potential_tidal(kpm: PM, delta_k, kernel_type: str, c2r, read,
                    compute_potential: bool, compute_tidal: bool):
    """The potential and the six tidal components (xx yy zz xy yz zx) of
    delta_k at every species' rows (gravity.py:127-156): the potential's
    field, then the tidal fields three at a time (the readout takes at
    most three), each the transfer of delta_k through c2r as acc_fields
    takes it, each group read by read(fields, name) -> [(N, k) or None
    per species] and let go. Returns a dict per species of what it read:
    potential (N,), tidal (N, 6)."""
    groups = ([("potential", (0,))] if compute_potential else []) + (
        [("tidal", (0, 1, 2)), ("tidal", (3, 4, 5))] if compute_tidal
        else [])
    parts = []
    for name, membs in groups:
        fields = []
        for m in membs:
            with prof.clock("force.kspace"):
                fk = kernels.apply_kernel_transfer(kpm, delta_k,
                                                   kernel_type, name, m)
            with prof.clock("force.c2r"):
                fields.append(c2r(fk))
            del fk
        with prof.clock("force.readout"):
            vals = read(fields, name)
        del fields
        parts = parts or [dict() for _ in vals]
        for part, v in zip(parts, vals):
            if v is not None:
                part.setdefault(name, []).append(v)
    return [{name: vs[0][:, 0] if name == "potential" else torch.cat(vs, 1)
             for name, vs in part.items()} for part in parts]


def _force_fields(pm: PM, delta_k, kernel_type: str, softening_type: str,
                  delta_transfer=None):
    """(softened delta_k, the three acceleration fields) from the
    overdensity transform (gravity.c:457-529); delta_transfer, when
    given, maps the softened delta_k before the potential kernel. The
    fields are acc_fields' through the unnormalised c2r."""
    with prof.clock("force.kspace"):
        delta_k = kernels.apply_softening(pm, delta_k, softening_type)
        if delta_transfer is not None:
            delta_k = delta_transfer(delta_k)
    return delta_k, acc_fields(pm, delta_k, kernel_type,
                               lambda g: fft.c2r(g, pm.Nmesh))


def paint_delta_k(pm: PM, painter: Painter, stores: Sequence[Store],
                  orders=None):
    """Paint all species into one canvas and return the overdensity
    transform delta_k (_fastpm_solver_compute_delta_k, gravity.c:304-356).
    orders: one CellOrder (or None) per species, handed to the painter."""
    return fft.r2c(_paint_canvas(pm, painter, stores, orders))


def _paint_canvas(pm: PM, painter: Painter, stores: Sequence[Store],
                  orders=None):
    """The canvas paint_delta_k transforms: (1 + delta) / Norm, mass per
    cell over the total mass, scaled in place, whose unnormalised
    transform is the unitary delta_k. The total mass is M0 * N for a
    scalar-mass species plus the sum of the mass column for a species
    that has one; the sum stays on the device (float64)."""
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
    return canvas.div_(total_mass)


def compute_force(pm: PM, painter: Painter, stores: Sequence[Store],
                  kernel_type: str = "1_4", softening_type: str = "none",
                  compute_potential: bool = False,
                  compute_tidal: bool = False, delta_transfer=None):
    """Accelerations of every species (fastpm_solver_compute_force,
    gravity.c:457-529), in row order; with compute_potential /
    compute_tidal also the potential and the six tidal components
    (xx yy zz xy yz zx) at the particles of each species that has the
    column allocated (gravity.py:127-156).

    Returns (stores with acc filled, delta_k). delta_k has the softening
    applied but not the deCIC compensation (the caller applies that for
    the power spectrum event, solver.c:466-471)."""
    with prof.clock("force.order"):
        orders = [cic.cell_order(p.x, pm.Nmesh, pm.InvCellSize)
                  if painter.is_cic else None for p in stores]
    with prof.clock("force.paint"):
        canvas = _paint_canvas(pm, painter, stores, orders)
    with prof.clock("force.r2c"):
        delta_k = fft.r2c(canvas)
    del canvas
    delta_k, (f0, f1, f2) = _force_fields(pm, delta_k, kernel_type,
                                          softening_type, delta_transfer)
    with prof.clock("force.readout"):
        out = [p.replace(acc=painter.readout3(f0, f1, f2, p.x, order))
               for p, order in zip(stores, orders)]
    del f0, f1, f2
    pot = compute_potential and any(p.potential is not None for p in out)
    tid = compute_tidal and any(p.tidal is not None for p in out)
    if pot or tid:
        def read(fields, name):
            return [None if getattr(p, name) is None
                    else painter.readout_fields(fields, p.x, o)
                    for p, o in zip(out, orders)]
        out = [p.replace(**e) for p, e in zip(out, potential_tidal(
            pm, delta_k, kernel_type, lambda k: fft.c2r(k, pm.Nmesh), read,
            pot, tid))]
    return out, delta_k


def carry_eligible(painter: Painter, stores: Sequence[Store],
                   compute_potential: bool = False,
                   compute_tidal: bool = False) -> bool:
    """Whether compute_force_carry can serve these species: one species
    with a scalar mass, painted with CIC, and neither the potential nor
    the tidal tensor asked for (gravity.py:177-186)."""
    return (painter.is_cic and len(stores) == 1
            and stores[0].mass is None
            and not compute_potential and not compute_tidal)


def compute_force_carry(pm: PM, painter: Painter, store: Store,
                        kernel_type: str = "1_4",
                        softening_type: str = "none", delta_transfer=None,
                        donate: bool = False):
    """The order-free force of one scalar-mass species
    (compute_force_carry, gravity.py:188-257); the caller checks
    carry_eligible first.

    Returns (store sorted by cell with acc filled, delta_k), with delta_k
    as compute_force returns it. K1 and K2 are called directly on the
    cell-sorted store, as the JAX carry force calls the from8 kernels.
    donate: the caller gives store up (the JAX step's donation of x and
    v): its columns are sorted one at a time in the store itself, each
    old column let go as its successor is made (Store.take), and the
    store is returned."""
    with prof.clock("force.order"):
        order = cic.sort_by_cell(store.x, pm.Nmesh, pm.InvCellSize)
        # every column but acc (overwritten below) rides the sort
        if donate:
            store.acc = None
            store = store.take(order, donate=True)
        else:
            store = store.replace(acc=None).take(order)
        del order
    acc, delta_k = _force_in_order(pm, _k1, store.x, kernel_type,
                                   softening_type, delta_transfer)
    return store.replace(acc=acc), delta_k


def compute_force_stale(pm: PM, painter: Painter, store: Store,
                        kernel_type: str = "1_4",
                        softening_type: str = "none", delta_transfer=None):
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
    acc, delta_k = _force_in_order(pm, _k1, store.x, kernel_type,
                                   softening_type, delta_transfer)
    return store.replace(acc=acc), delta_k


def _k1(pm: PM, x, weight: float):
    """K1: the canvas of the rows x, weight a particle."""
    return cic.cic_paint(x, pm.Nmesh, pm.InvCellSize, weight)


def _force_in_order(pm: PM, paint, x, kernel_type: str,
                    softening_type: str, delta_transfer=None):
    """The body of the carry and stale forces (and of benchlib's
    order-free steps): paint(pm, x, weight) -> canvas (K1; K5 for
    benchlib's paint8=False) with 1 / N a particle, so the canvas is
    (1 + delta) / Norm with no pass of its own; r2c, the force fields
    and K2 on the rows x in their order. Returns (acc, delta_k)."""
    with prof.clock("force.paint"):
        canvas = paint(pm, x, float(np.float32(1.0 / x.shape[0])))
    with prof.clock("force.r2c"):
        delta_k = fft.r2c(canvas)
    del canvas
    delta_k, fields = _force_fields(pm, delta_k, kernel_type,
                                    softening_type, delta_transfer)
    with prof.clock("force.readout"):
        acc = cic.cic_readout(fields, x, pm.InvCellSize)
    return acc, delta_k
