"""The canonical single-device PM step: force, kick and drift in one call
(port of fastpm_tpu/benchlib.py), and stale-order stepping built on it.

Every function runs on the first CUDA device unless device is given
("cpu" for the plain versions of the kernels).

Not ported: the TPU-only parameters of the JAX step (K, C, subr,
payload_gather). On the card a sort is always a key sort, a permutation
and gathers of the rows (ops/sort.py), and PyTorch runs eagerly, so
there is nothing to jit. The JAX step's donation of x and v
(donate_argnums) is ported as its contract: the step writes its results
into the caller's tensors (make_step_fn's donate).

The force is the Solver's (gravity.py): the order-free steps run the
body of the carry and stale forces on x in its order (K1, or K5, the
unnormalised r2c, the k-space stage, K2), the order-preserving step
runs compute_force. Only the sort, the KDK update and its donation are
the step's own.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .mesh import PM
from .painter import Painter
from .store import Store
from .ops import cic, sort
from . import gravity

__all__ = ["make_step_fn", "make_stale_step_fns", "example_particles"]


def _on(pm: PM, device) -> PM:
    """pm, or the same mesh with its tables on device."""
    dev = resolve_device(device)
    return pm if pm.device == dev else PM(pm.Nmesh, pm.BoxSize, device=dev)


def _k5(pm: PM, x, weight: float):
    """K5: the canvas of the rows x, weight a particle."""
    canvas = torch.zeros(pm.rshape, dtype=torch.float32, device=x.device)
    cic.cic_paint4(canvas, x, pm.InvCellSize, weight)
    return canvas


def _kdk(pm: PM, x, v, acc, coeffs, own: bool):
    """The kick and drift with the periodic wrap (benchlib.py:94-100).
    own: x and v are the step's to overwrite (a donation, or the sort's
    copies), and the update is taken in them; otherwise in copies.
    Returns (x, v, acc), the same bits either way."""
    coeffs = torch.as_tensor(coeffs, dtype=torch.float32, device=x.device)
    L = torch.tensor(pm.BoxSize, dtype=torch.float32, device=x.device)
    if not own:
        x, v = x.clone(), v.clone()
    v.add_(acc * coeffs[0])
    x.add_(v * coeffs[1])
    x.sub_(torch.floor(x / L).mul_(L))
    return x, v, acc


def make_step_fn(pm: PM, kernel_type: str = "1_4",
                 painter_type: str = "cic", support: int = 2,
                 carry_sorted: bool = True, sort_block: int | None = None,
                 paint8: bool = True, donate: bool = False, device=None):
    """One PM force + kick + drift step (make_step_fn, benchlib.py:20-104):
    returns step(x, v, coeffs) -> (x, v, acc), coeffs = (kick, drift)
    factors.

    carry_sorted (CIC only): order-free stepping. The step sorts (x, v)
    by cell (ops/sort.carry_sort; with sort_block the k-sorted sort with
    K7, which wins when the rows come in the order of the step before),
    and runs the carry force's body on them (gravity._force_in_order),
    which paints with K1, or with K5 when paint8 is False, and reads out
    with K2; its rows come out in cell order, a permutation of the
    order-preserving result. Otherwise the step keeps row order: it runs
    gravity.compute_force with the Painter (K3 and K4 for CIC).

    donate: the caller gives x and v up (the JAX step's donate_argnums
    (0, 1); bench.py's BENCH_DONATE): the step sorts, kicks and drifts
    in them and returns them. The JAX default is True; here it is False,
    since a Python caller keeps its references."""
    pm = _on(pm, device)
    if not (carry_sorted and painter_type == "cic"):
        painter = Painter(pm, painter_type, support)

        def step(x, v, coeffs):
            (p,), _dk = gravity.compute_force(pm, painter, [Store(x=x)],
                                              kernel_type)
            return _kdk(pm, x, v, p.acc, coeffs, donate)
        return step

    paint = gravity._k1 if paint8 else _k5

    def step(x, v, coeffs):
        x, v = sort.carry_sort(x, v, pm.Nmesh, pm.InvCellSize, sort_block,
                               donate)
        acc, _dk = gravity._force_in_order(pm, paint, x, kernel_type,
                                           "none")
        # donated, or the sort's copies: the step's own
        return _kdk(pm, x, v, acc, coeffs, True)

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

    def run(x, v, coeffs, own):
        acc, _dk = gravity._force_in_order(pm, gravity._k1, x, kernel_type,
                                           "none")
        return _kdk(pm, x, v, acc, coeffs, own)

    def step_stale(x, v, coeffs):
        return run(x, v, coeffs, False)

    def step_fresh(x, v, coeffs):
        # the sort's copies are the step's own
        return run(*sort.carry_sort(x, v, pm.Nmesh, pm.InvCellSize), coeffs,
                   True)

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
