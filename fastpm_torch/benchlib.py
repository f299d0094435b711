"""The canonical single-device PM step: force, kick and drift in one call
(port of fastpm_tpu/benchlib.py), and stale-order stepping built on it.

Every function runs on the first CUDA device unless device is given
("cpu" for the plain versions of the kernels).

Not ported: the TPU-only parameters of the JAX step (K, C, subr, donate,
payload_gather). On the card a sort is always a key sort, a permutation
and gathers of the rows (ops/sort.py), and PyTorch runs eagerly, so
there is nothing to donate or jit.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .kernels import kernel_orders
from .mesh import PM
from .painter import Painter
from .ops import cic, sort
from . import transfers

__all__ = ["make_step_fn", "make_stale_step_fns", "example_particles"]


def _on(pm: PM, device) -> PM:
    """pm, or the same mesh with its tables on device."""
    dev = resolve_device(device)
    return pm if pm.device == dev else PM(pm.Nmesh, pm.BoxSize, device=dev)


def _step(pm: PM, potorder: int, gradorder: int, paint, readout, x, v,
          coeffs):
    """One force, kick and drift (benchlib.py:81-100): the canvas of
    paint(x) as 1 + delta, r2c, the potential transfer, the three
    gradients, readout(fields, x) and the KDK update with the periodic
    wrap. Returns (x, v, acc)."""
    canvas = paint(x) / (x.shape[0] / pm.Norm)
    pot_k = transfers.apply_pot(pm, pm.r2c(canvas), potorder)
    del canvas
    acc = readout(pm.c2r_grad3(pot_k, gradorder), x)
    coeffs = torch.as_tensor(coeffs, dtype=torch.float32, device=x.device)
    L = torch.tensor(pm.BoxSize, dtype=torch.float32, device=x.device)
    v = v + acc * coeffs[0]
    x = x + v * coeffs[1]
    return x - torch.floor(x / L) * L, v, acc


def make_step_fn(pm: PM, kernel_type: str = "1_4",
                 painter_type: str = "cic", support: int = 2,
                 carry_sorted: bool = True, sort_block: int | None = None,
                 paint8: bool = True, device=None):
    """One PM force + kick + drift step (make_step_fn, benchlib.py:20-104):
    returns step(x, v, coeffs) -> (x, v, acc), coeffs = (kick, drift)
    factors.

    carry_sorted (CIC only): order-free stepping. The step sorts (x, v)
    by cell (ops/sort.carry_sort; with sort_block the k-sorted sort with
    K7, which wins when the rows come in the order of the step before),
    paints with K1, or with K5 when paint8 is False, and reads out with
    K2; its rows come out in cell order, a permutation of the
    order-preserving result. Otherwise the step keeps row order, as
    gravity.compute_force does: the Painter (K3 and K4 for CIC)."""
    pm = _on(pm, device)
    potorder, gradorder, _d, _ = kernel_orders(kernel_type)
    painter = Painter(pm, painter_type, support)
    inv = pm.InvCellSize
    if not (carry_sorted and painter_type == "cic"):
        def step(x, v, coeffs):
            return _step(pm, potorder, gradorder,
                         lambda x: painter.paint(x, 1.0),
                         lambda f, x: painter.readout3(*f, x), x, v, coeffs)
        return step

    def paint(x):
        if paint8:
            return cic.cic_paint(x, pm.Nmesh, inv)
        canvas = torch.zeros(pm.rshape, dtype=torch.float32, device=x.device)
        cic.cic_paint4(canvas, x, inv)
        return canvas

    def step(x, v, coeffs):
        x, v = sort.carry_sort(x, v, pm.Nmesh, inv, sort_block)
        return _step(pm, potorder, gradorder, paint,
                     lambda f, x: cic.cic_readout(f, x, inv), x, v, coeffs)

    return step


def make_stale_step_fns(pm: PM, kernel_type: str = "1_4", device=None):
    """Stale-order stepping (make_stale_step_fns, benchlib.py:107-189):
    returns (step_fresh, step_stale), both (x, v, coeffs) -> (x, v, acc).

    step_fresh sorts by cell as make_step_fn's order-free step does;
    step_stale skips the sort and runs K1 and K2 on the order it is given
    (the order of the last fresh step, drifted since). The JAX version
    carries a range table between them and reports a mover overflow
    (nbad); K1 and K2 take particles in any order, so here neither exists
    and a stale step is exact (gravity.compute_force_stale)."""
    pm = _on(pm, device)
    potorder, gradorder, _d, _ = kernel_orders(kernel_type)
    inv = pm.InvCellSize

    def step_stale(x, v, coeffs):
        return _step(pm, potorder, gradorder,
                     lambda x: cic.cic_paint(x, pm.Nmesh, inv),
                     lambda f, x: cic.cic_readout(f, x, inv), x, v, coeffs)

    def step_fresh(x, v, coeffs):
        x, v = sort.carry_sort(x, v, pm.Nmesh, inv)
        return step_stale(x, v, coeffs)

    return step_fresh, step_stale


def example_particles(nc: int, boxsize: float, seed: int = 0, jitter=0.3,
                      device=None):
    """A jittered lattice of nc^3 particles at rest: (x, v) float32 (N, 3)
    on device, drawn as the JAX package draws them (benchlib.py:192-201),
    so both packages start from the same particles."""
    dev = resolve_device(device)
    cell = boxsize / nc
    g = np.arange(nc) * cell
    q = np.stack(np.meshgrid(g, g, g, indexing="ij"), axis=-1).reshape(-1, 3)
    rng = np.random.RandomState(seed)
    x = (q + jitter * cell * rng.standard_normal(q.shape)) % boxsize
    x = torch.from_numpy(x.astype(np.float32)).to(dev)
    return x, torch.zeros_like(x)
