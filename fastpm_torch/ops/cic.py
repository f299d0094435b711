"""CIC paint and readout: the hand-written CUDA kernels, their plain
PyTorch versions, and the cell sort that prepares the order-free force.

- K1 cic_paint: particles in cell order (any order is right; cell
  order buys locality), scalar mass, a new canvas
  (replaces fastpm_tpu/ops/paint_pallas.py:_paint_kernel8); its homed
  form cic_paint_homed adds a scalar mass or a mass column into one
  rank's extended x-slab (make_paint_from8_homed_fn);
- K2 cic_readout: 1-3 fields at particles in cell order (any order is
  right) and at the 2LPT lattice (replaces
  fastpm_tpu/ops/readout_pallas.py:_readout_kernel8); its homed form
  cic_readout_homed reads extended x-slabs
  (make_readout3_from8_homed_fn);
- K3 cic_paint_into: particles in any order, scalar mass or a mass
  column, added into a canvas the caller owns (replaces
  paint_pallas.py:_paint_kernel);
- K4 cic_readout3: the three force fields at particles in any order,
  rows in the caller's order (replaces readout_pallas.py:_readout_kernel;
  it launches K2's kernel with three fields, under its own counter);
- K5 cic_paint4: K1's deposit in two passes of 4 corners, periodic or
  homed (replaces paint_pallas.py:_paint_kernel4, both
  make_paint_from4_fn and make_paint_from4_homed_fn);
- K6 cic_readout4: the three-field readout in two passes whose partial
  values are summed, periodic or homed (replaces
  readout_pallas.py:_readout_kernel4, both make_readout3_from4_fn and
  make_readout3_from4_homed_fn).

The port keeps the TPU kernels' contract, not their mechanism (see
csrc/*.cu).

Every function takes positions x (N, 3) float32 in box units and the
mesh as (Nmesh, InvCellSize). The base cell and fraction follow
base_cell_frac (paint_pallas.py:273-284) in float32: g = x * InvCellSize,
base = floor(g) wrapped with a remainder (a position equal to the box
size after a float32 wrap floors to Nmesh and wraps to 0), frac = g -
floor(g). The corner weights follow w8_from_frac: ((wx * wy) * wz).

A homed form takes a `Slab`: the canvas or field is one rank's x-slab
widened by H planes on the left and H + 1 on the right, open in x and
periodic in y and z. A particle beyond it deposits nothing, reads zero
and is counted: the paints return that count, the `bad` of the homed
force's overflow contract, as an int32 tensor on the device.

Every wrapper dispatches on the device of x: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel (built at first use)
or raises. Each wrapper counts its kernel launches in its `launches`
attribute.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import numpy as np
import torch

from .cudalib import launch as _launch

__all__ = ["Slab", "cell_key", "sort_by_cell", "slab_cell", "cic_paint",
           "cic_readout", "cic_paint_into", "cic_readout3",
           "cic_paint_homed", "cic_readout_homed", "cic_paint4",
           "cic_readout4",
           "cic_paint_plain", "cic_paint_into_plain", "cic_readout_plain",
           "cic_paint_homed_plain", "cic_paint4_plain",
           "cic_readout4_plain"]

# the cell key is int32: nx * ny * nz must stay below 2^31, which holds
# up to a 1290^3 mesh
_MAX_CELLS = 2 ** 31


class Slab(NamedTuple):
    """The extended x-slab of one rank of the homed force: the full mesh
    has n0 planes in x, the rank's slab starts at plane r0, and the
    canvas holds it widened by H planes on each side plus one (nloc +
    2H + 1 planes). A position's base plane bx sits at the canvas plane
    relx = remainder(bx - r0 + H, n0) (psolver.py:_cic_rel); relx >=
    nloc + 2H is beyond the slab."""

    n0: int
    r0: int
    H: int

    @property
    def shift(self) -> int:
        return self.H - self.r0


def _inv32(inv_cell):
    return tuple(float(np.float32(c)) for c in inv_cell)


def cell_frac(x: torch.Tensor, nmesh, inv_cell):
    """(base (N, 3) int64 wrapped into [0, Nmesh), frac (N, 3) float32)."""
    g = x * torch.tensor(_inv32(inv_cell), dtype=torch.float32,
                         device=x.device)
    b = torch.floor(g)
    base = torch.remainder(b.to(torch.int64),
                           torch.tensor(nmesh, device=x.device))
    return base, g - b


def cell_key(x: torch.Tensor, nmesh, inv_cell) -> torch.Tensor:
    """int32 raveled base cell of each particle. It orders particles as
    the JAX package's padded key (paint_pallas.py:283) does."""
    nx, ny, nz = nmesh
    if nx * ny * nz >= _MAX_CELLS:
        raise ValueError(f"mesh {tuple(nmesh)} overflows the int32 cell key")
    base, _ = cell_frac(x, nmesh, inv_cell)
    return ((base[:, 0] * ny + base[:, 1]) * nz + base[:, 2]).to(torch.int32)


def sort_by_cell(x: torch.Tensor, nmesh, inv_cell) -> torch.Tensor:
    """The stable permutation that sorts particles by base cell
    (the prepare step of make_prepare_carry_fn, paint_pallas.py:440-541);
    apply it to every store column."""
    return torch.sort(cell_key(x, nmesh, inv_cell), stable=True).indices


def slab_cell(x: torch.Tensor, nmesh, inv_cell, slab: Slab):
    """(base (N, 3) int64 on the extended slab, frac (N, 3), valid (N,)):
    the x index is relx; rows beyond the slab get plane 0 and
    valid False."""
    nx, ny, nz = nmesh
    base, f = cell_frac(x, (slab.n0, ny, nz), inv_cell)
    relx = torch.remainder(base[:, 0] + slab.shift, slab.n0)
    valid = relx < nx - 1
    base = torch.stack([torch.where(valid, relx, 0), base[:, 1],
                        base[:, 2]], dim=-1)
    return base, f, valid


def _corners(x, nmesh, inv_cell, slab=None):
    """(valid (N,) bool or None, [(flat index (N,) int64, weight (N,)
    float32)] for the 8 CIC corners, dx-major like w8_from_frac). In a
    slab a row beyond it has weight 0 at every corner."""
    nx, ny, nz = nmesh
    if slab is None:
        base, f = cell_frac(x, nmesh, inv_cell)
        valid = None
    else:
        base, f, valid = slab_cell(x, nmesh, inv_cell, slab)
    t = 1.0 - f
    # an open x axis never reaches plane nx (relx <= nx - 2)
    hi = torch.where(base + 1 == torch.tensor(nmesh, device=x.device),
                     torch.zeros_like(base), base + 1)
    out = []
    for dx, dy, dz in itertools.product((0, 1), repeat=3):
        ix = (hi if dx else base)[:, 0]
        iy = (hi if dy else base)[:, 1]
        iz = (hi if dz else base)[:, 2]
        w = ((f if dx else t)[:, 0] * (f if dy else t)[:, 1]
             * (f if dz else t)[:, 2])
        if valid is not None:
            w = torch.where(valid, w, 0.0)
        out.append(((ix * ny + iy) * nz + iz, w))
    return valid, out


def _deposit_plain(canvas, x, inv_cell, mass, slab):
    """index_add_ of the 8 weighted corners into canvas; returns the
    count of rows beyond the slab (int32, 0 without one)."""
    flat = canvas.view(-1)
    valid, corners = _corners(x, tuple(canvas.shape), inv_cell, slab)
    for idx, w in corners:
        flat.index_add_(0, idx, w * mass)
    if valid is None:
        return torch.zeros((), dtype=torch.int32, device=x.device)
    return (~valid).sum(dtype=torch.int32)


def cic_paint_into_plain(canvas: torch.Tensor, x: torch.Tensor, inv_cell,
                         mass=1.0) -> torch.Tensor:
    """Plain K3: index_add_ of the 8 weighted corners into canvas (a
    contiguous (nx, ny, nz) float32 tensor, updated in place and
    returned). mass is a scalar or an (N,) float32 tensor."""
    _deposit_plain(canvas, x, inv_cell, mass, None)
    return canvas


def cic_paint_plain(x: torch.Tensor, nmesh, inv_cell,
                    mass=1.0) -> torch.Tensor:
    """Plain K1: the deposit into a new zeroed canvas."""
    canvas = torch.zeros(tuple(nmesh), dtype=torch.float32, device=x.device)
    return cic_paint_into_plain(canvas, x, inv_cell, mass)


def cic_paint_homed_plain(canvas: torch.Tensor, x: torch.Tensor, inv_cell,
                          slab: Slab, mass=1.0) -> torch.Tensor:
    """Plain homed K1: the deposit added into the extended slab canvas;
    returns the count of rows beyond the slab."""
    return _deposit_plain(canvas, x, inv_cell, mass, slab)


def cic_paint4_plain(canvas: torch.Tensor, x: torch.Tensor, inv_cell,
                     mass=1.0, slab: Slab | None = None) -> torch.Tensor:
    """Plain K5: the same sum as K1's (the two passes only reorder the
    additions), periodic or into a slab; returns the count of rows
    beyond the slab (0 without one)."""
    return _deposit_plain(canvas, x, inv_cell, mass, slab)


def cic_readout_plain(fields, x: torch.Tensor, inv_cell,
                      slab: Slab | None = None) -> torch.Tensor:
    """Plain K2 and K4 (and homed K2 with a slab): gather of the 8
    corners and a weighted sum, (N, k)."""
    nmesh = tuple(fields[0].shape)
    flat = [f.reshape(-1) for f in fields]
    out = torch.zeros((x.shape[0], len(fields)), dtype=torch.float32,
                      device=x.device)
    for idx, w in _corners(x, nmesh, inv_cell, slab)[1]:
        for c, f in enumerate(flat):
            out[:, c] += w * f[idx]
    return out


def cic_readout4_plain(cx, cy, cz, x: torch.Tensor, inv_cell,
                       slab: Slab | None = None) -> torch.Tensor:
    """Plain K6: per x plane of the cloud, the weighted sum of its 4
    corners; the two planes' sums added, (N, 3)."""
    flat = [f.reshape(-1) for f in (cx, cy, cz)]
    corners = _corners(x, tuple(cx.shape), inv_cell, slab)[1]
    part = torch.zeros((2, x.shape[0], 3), dtype=torch.float32,
                       device=x.device)
    for c, (idx, w) in enumerate(corners):
        for k, f in enumerate(flat):
            part[c // 4, :, k] += w * f[idx]
    return part[0] + part[1]


def _check_positions(x: torch.Tensor):
    if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] != 3:
        raise ValueError(f"positions must be (N, 3) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _check_mesh(nmesh):
    if len(nmesh) != 3 or int(np.prod(nmesh)) >= _MAX_CELLS:
        raise ValueError(f"unsupported mesh {tuple(nmesh)}")


def _check_slab(slab, nmesh):
    if slab is None:
        return
    n0, r0, H = slab
    if not (0 <= r0 < n0 and H >= 0 and nmesh[0] >= 2):
        raise ValueError(f"bad slab {slab} for the canvas {tuple(nmesh)}")


def _check_fields(fields, x):
    """The common mesh shape of 1-3 float32 fields on the device of x."""
    nmesh = tuple(fields[0].shape)
    _check_mesh(nmesh)
    for f in fields:
        if (f.dtype != torch.float32 or tuple(f.shape) != nmesh
                or f.device != x.device):
            raise ValueError("fields must be float32 of one shape, on the "
                             "device of the positions")
    return nmesh


def _check_canvas(canvas, x, mass):
    """The canvas's shape; whether mass is a column."""
    nmesh = tuple(canvas.shape)
    _check_mesh(nmesh)
    if (canvas.dtype != torch.float32 or not canvas.is_contiguous()
            or canvas.device != x.device):
        raise ValueError("canvas must be a contiguous float32 tensor on "
                         "the device of the positions")
    column = torch.is_tensor(mass)
    if column and (mass.dtype != torch.float32
                   or tuple(mass.shape) != (x.shape[0],)
                   or mass.device != x.device):
        raise ValueError("mass must be a scalar or an (N,) float32 tensor "
                         "on the device of the positions")
    return nmesh, column


def cic_paint(x: torch.Tensor, nmesh, inv_cell, mass=1.0) -> torch.Tensor:
    """Deposit a scalar mass at every particle into a new (nx, ny, nz)
    float32 canvas. On CUDA this launches K1 (csrc/cic_paint.cu). It is
    right for particles in any order; cell order only buys locality of
    the atomics (the stale force paints in a carried, no longer sorted
    order). The canvas differs from run to run in the last bits (f32
    atomics)."""
    _check_positions(x)
    nmesh = tuple(int(n) for n in nmesh)
    _check_mesh(nmesh)
    if torch.is_tensor(mass):
        raise ValueError("cic_paint takes a scalar mass; a mass column "
                         "goes through cic_paint_into")
    if x.device.type == "cpu":
        return cic_paint_plain(x, nmesh, inv_cell, mass)
    x = x.contiguous()
    canvas = torch.zeros(nmesh, dtype=torch.float32, device=x.device)
    _launch("fastpm_cic_paint", x.data_ptr(), x.shape[0], *nmesh,
            *_inv32(inv_cell), float(mass), canvas.data_ptr(),
            device=x.device)
    cic_paint.launches += 1
    return canvas


cic_paint.launches = 0


def cic_paint_into(canvas: torch.Tensor, x: torch.Tensor, inv_cell,
                   mass=1.0) -> torch.Tensor:
    """Add mass (a scalar or an (N,) float32 tensor) at every particle,
    in any order, into canvas (a contiguous (nx, ny, nz) float32 tensor
    on the device of x), in place; returns canvas. On CUDA this launches
    K3 (csrc/cic_paint_into.cu); the sum differs from run to run in the
    last bits (f32 atomics)."""
    _check_positions(x)
    nmesh, column = _check_canvas(canvas, x, mass)
    if x.device.type == "cpu":
        return cic_paint_into_plain(canvas, x, inv_cell, mass)
    x = x.contiguous()
    masses = mass.contiguous() if column else None
    _launch("fastpm_cic_paint_into", x.data_ptr(), x.shape[0], *nmesh,
            *_inv32(inv_cell), 0.0 if column else float(mass),
            masses.data_ptr() if column else None, canvas.data_ptr(),
            device=x.device)
    cic_paint_into.launches += 1
    return canvas


cic_paint_into.launches = 0


def _paint_slab(name, canvas, x, inv_cell, mass, slab):
    """Launch a paint entry point with the (n0, shift) x axis (0, 0:
    periodic); returns the device count of rows beyond the slab."""
    nmesh, column = _check_canvas(canvas, x, mass)
    x = x.contiguous()
    masses = mass.contiguous() if column else None
    bad = torch.zeros((), dtype=torch.int32, device=x.device)
    n0, shift = (slab.n0, slab.shift) if slab is not None else (0, 0)
    _launch(name, x.data_ptr(), x.shape[0], *nmesh, *_inv32(inv_cell),
            n0, shift, 0.0 if column else float(mass),
            masses.data_ptr() if column else None, canvas.data_ptr(),
            bad.data_ptr(), device=x.device)
    return bad


def cic_paint_homed(canvas: torch.Tensor, x: torch.Tensor, inv_cell,
                    slab: Slab, mass=1.0) -> torch.Tensor:
    """Add mass (a scalar or an (N,) float32 tensor) at every particle
    into the extended slab canvas (a contiguous (nloc + 2H + 1, ny, nz)
    float32 tensor on the device of x), in place; returns the count of
    particles beyond the slab (int32, on the device). On CUDA this
    launches homed K1 (csrc/cic_paint.cu)."""
    _check_positions(x)
    _check_slab(slab, canvas.shape)
    if x.device.type == "cpu":
        _check_canvas(canvas, x, mass)
        return cic_paint_homed_plain(canvas, x, inv_cell, slab, mass)
    bad = _paint_slab("fastpm_cic_paint_homed", canvas, x, inv_cell, mass,
                      slab)
    cic_paint_homed.launches += 1
    return bad


cic_paint_homed.launches = 0


def cic_paint4(canvas: torch.Tensor, x: torch.Tensor, inv_cell, mass=1.0,
               slab: Slab | None = None) -> torch.Tensor:
    """K1's deposit in two passes of 4 corners: add mass (a scalar or an
    (N,) float32 tensor) at every particle into canvas, periodic, or the
    extended slab canvas when slab is given; returns the count of
    particles beyond the slab (int32, on the device; 0 without one). On
    CUDA this launches K5 (csrc/cic_paint4.cu)."""
    _check_positions(x)
    _check_slab(slab, canvas.shape)
    if x.device.type == "cpu":
        _check_canvas(canvas, x, mass)
        return cic_paint4_plain(canvas, x, inv_cell, mass, slab)
    bad = _paint_slab("fastpm_cic_paint4", canvas, x, inv_cell, mass, slab)
    cic_paint4.launches += 1
    return bad


cic_paint4.launches = 0


def cic_readout(fields, x: torch.Tensor, inv_cell) -> torch.Tensor:
    """Interpolate 1 to 3 (nx, ny, nz) float32 fields at every particle,
    (N, k) float32. On CUDA this launches K2 (csrc/cic_readout.cu)."""
    _check_positions(x)
    fields = list(fields)
    if not 1 <= len(fields) <= 3:
        raise ValueError("cic_readout takes 1 to 3 fields")
    nmesh = _check_fields(fields, x)
    if x.device.type == "cpu":
        return cic_readout_plain(fields, x, inv_cell)
    x = x.contiguous()
    fields = [f.contiguous() for f in fields]
    ptrs = [f.data_ptr() for f in fields] + [None] * (3 - len(fields))
    out = torch.empty((x.shape[0], len(fields)), dtype=torch.float32,
                      device=x.device)
    _launch("fastpm_cic_readout", x.data_ptr(), x.shape[0], *nmesh,
            *_inv32(inv_cell), *ptrs, len(fields), out.data_ptr(),
            device=x.device)
    cic_readout.launches += 1
    return out


cic_readout.launches = 0


def cic_readout_homed(fields, x: torch.Tensor, inv_cell,
                      slab: Slab) -> torch.Tensor:
    """Interpolate 1 to 3 extended slab fields ((nloc + 2H + 1, ny, nz)
    float32) at every particle, (N, k) float32; a particle beyond the
    slab reads zero. On CUDA this launches homed K2
    (csrc/cic_readout.cu)."""
    _check_positions(x)
    fields = list(fields)
    if not 1 <= len(fields) <= 3:
        raise ValueError("cic_readout_homed takes 1 to 3 fields")
    nmesh = _check_fields(fields, x)
    _check_slab(slab, nmesh)
    if x.device.type == "cpu":
        return cic_readout_plain(fields, x, inv_cell, slab)
    x = x.contiguous()
    fields = [f.contiguous() for f in fields]
    ptrs = [f.data_ptr() for f in fields] + [None] * (3 - len(fields))
    out = torch.empty((x.shape[0], len(fields)), dtype=torch.float32,
                      device=x.device)
    _launch("fastpm_cic_readout_homed", x.data_ptr(), x.shape[0], *nmesh,
            *_inv32(inv_cell), slab.n0, slab.shift, *ptrs, len(fields),
            out.data_ptr(), device=x.device)
    cic_readout_homed.launches += 1
    return out


cic_readout_homed.launches = 0


def cic_readout3(cx, cy, cz, x: torch.Tensor, inv_cell) -> torch.Tensor:
    """Interpolate the three (nx, ny, nz) float32 force fields at every
    particle, in any order: (N, 3) float32, row i for particle i. On
    CUDA this launches K4, which is K2's kernel (csrc/cic_readout.cu)
    with three fields: on unsorted particles it beat a kernel of its
    own (PERF.md)."""
    _check_positions(x)
    fields = [cx, cy, cz]
    nmesh = _check_fields(fields, x)
    if x.device.type == "cpu":
        return cic_readout_plain(fields, x, inv_cell)
    x = x.contiguous()
    fields = [f.contiguous() for f in fields]
    out = torch.empty((x.shape[0], 3), dtype=torch.float32, device=x.device)
    _launch("fastpm_cic_readout", x.data_ptr(), x.shape[0], *nmesh,
            *_inv32(inv_cell), *(f.data_ptr() for f in fields), 3,
            out.data_ptr(), device=x.device)
    cic_readout3.launches += 1
    return out


cic_readout3.launches = 0


def cic_readout4(cx, cy, cz, x: torch.Tensor, inv_cell,
                 slab: Slab | None = None) -> torch.Tensor:
    """Interpolate the three force fields at every particle in two passes,
    one per x plane of the cloud, and add the passes: (N, 3) float32.
    The fields are periodic, or extended slabs when slab is given (a
    particle beyond the slab reads zero). On CUDA this launches K6
    (csrc/cic_readout4.cu) into a (2, N, 3) buffer."""
    _check_positions(x)
    fields = [cx, cy, cz]
    nmesh = _check_fields(fields, x)
    _check_slab(slab, nmesh)
    if x.device.type == "cpu":
        return cic_readout4_plain(cx, cy, cz, x, inv_cell, slab)
    x = x.contiguous()
    fields = [f.contiguous() for f in fields]
    part = torch.empty((2, x.shape[0], 3), dtype=torch.float32,
                       device=x.device)
    n0, shift = (slab.n0, slab.shift) if slab is not None else (0, 0)
    _launch("fastpm_cic_readout4", x.data_ptr(), x.shape[0], *nmesh,
            *_inv32(inv_cell), n0, shift, *(f.data_ptr() for f in fields),
            part.data_ptr(), device=x.device)
    cic_readout4.launches += 1
    return part[0] + part[1]


cic_readout4.launches = 0
