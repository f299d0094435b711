"""Edge geometries of the CIC readout (K2, K4, K6), made from a numpy
seed: the particle orders that decide how well the CUDA kernel's corner
loads share cache lines (cell, store and stale order), and the wraps,
faces and slab ends it must get right.

Used by tests/test_torch_readout_edges.py (the plain versions against
the JAX package on the CPU), the cuda case of tests/test_torch_cic.py
and chip_smoke.py (the kernel against the plain versions on the card).
"""

import numpy as np
import torch

from fastpm_torch.ops import cic

# periodic meshes: cell order (sorted, clustered, boundary and the three
# faces), store order (random) and an earlier cell order drifted by up
# to a cell (stale)
PERIODIC = ("sorted", "clustered", "random", "stale", "xplane", "ywrap",
            "zlast", "boundary")
# one rank's extended slab: cell order on the slab, that order drifted,
# and the slab's last plane with the rows beyond it
SLAB = ("slab_sorted", "slab_stale", "slab_lastplane")


def mesh(n, box):
    """(nmesh, inv_cell) of an n^3 mesh on a box."""
    return (n,) * 3, (n / box,) * 3


def slab_of(n, nloc, H, rank):
    """(Slab, extended slab shape) of rank `rank` of n / nloc ranks."""
    return cic.Slab(n, rank * nloc, H), (nloc + 2 * H + 1, n, n)


def _cell_sorted(x, n, box):
    nmesh, inv = mesh(n, box)
    return x[cic.sort_by_cell(torch.from_numpy(x), nmesh, inv).numpy()]


def _slab_sorted(x, box, slab, ext):
    """Rows sorted by extended-slab cell, as the homed carry sorts them
    (rows beyond the slab at plane 0)."""
    _nmesh, inv = mesh(slab.n0, box)
    base, _f, _v = cic.slab_cell(torch.from_numpy(x), ext, inv, slab)
    key = (base[:, 0] * ext[1] + base[:, 1]) * ext[2] + base[:, 2]
    return x[torch.sort(key, stable=True).indices.numpy()]


def _wrap32(u, box):
    # float32 may round a position just below the box up to the box
    # itself, which the readout wraps to plane 0: kept as an edge case
    return np.mod(u, box).astype(np.float32)


def _drift(x, box, cell, rng):
    return _wrap32(x + rng.uniform(-cell, cell, x.shape), box)


def periodic_case(kind, n, box, count, seed=0):
    """(count, 3) float32 positions in [0, box] on an n^3 mesh, in the
    order of the case."""
    rng = np.random.default_rng([seed, PERIODIC.index(kind)])
    cell = box / n
    u = rng.uniform(0, box, (count, 3))
    if kind == "clustered":
        # three quarters in 8 gaussian blobs a cell wide
        m = count * 3 // 4
        centers = rng.uniform(0, box, (8, 3))
        u[:m] = (centers[rng.integers(0, 8, m)]
                 + rng.normal(0, cell, (m, 3)))
    elif kind == "xplane":
        # one cell either side of the face of plane n // 2: in cell order
        # most blocks hold particles of both planes
        u[:, 0] = (n // 2 + rng.uniform(-1, 1, count)) * cell
    elif kind == "ywrap":
        # the last two rows in y: the +1 rows of the last wrap to row 0
        u[:, 1] = box - rng.uniform(0, 2 * cell, count)
    elif kind == "zlast":
        # the last column in z, whose +1 corner wraps to z = 0
        u[:, 2] = box - rng.uniform(0, cell, count)
    elif kind == "boundary":
        # exact cell faces, the origin, and positions at the box size
        g = rng.integers(0, n + 1, (count // 2, 3)) * cell
        u[:count // 2] = g
        u[:8] = [[0, 0, 0], [box, box, box], [box, 0, box - cell],
                 [0, box, 0], [box - 1e-3, 0, 0], [0, box - 1e-3, 0],
                 [0, 0, box - 1e-3], [cell, box, cell]]
    x = _wrap32(u, box)
    if kind == "boundary":
        x[1] = box
        x[7, 1] = box
    if kind == "random":
        return x[rng.permutation(count)]
    if kind == "stale":
        return _drift(_cell_sorted(x, n, box), box, cell, rng)
    return _cell_sorted(x, n, box)


def slab_case(kind, n, box, count, slab, ext, seed=0):
    """(count, 3) float32 positions around the extended slab of `slab`
    (shape ext), some beyond it, in the order of the case."""
    rng = np.random.default_rng([seed, 100 + SLAB.index(kind)])
    cell = box / n
    nx = ext[0]
    u = rng.uniform(0, box, (count, 3))
    # global base plane of the canvas plane relx: r0 - H + relx
    first = slab.r0 - slab.H
    if kind == "slab_lastplane":
        # relx = nx - 2 (the last plane with a +1 plane) and nx - 1,
        # nx (beyond: they read zero)
        relx = rng.integers(nx - 2, nx + 1, count)
    else:
        # the whole slab and two planes beyond either end
        relx = rng.integers(-2, nx + 2, count)
    u[:, 0] = (first + relx + rng.uniform(0, 1, count)) * cell
    x = _slab_sorted(_wrap32(u, box), box, slab, ext)
    if kind == "slab_stale":
        return _drift(x, box, cell, rng)
    return x
