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
  paint_pallas.py:_paint_kernel): K1's tiled deposit reads the rows in
  cell order, a CellOrder the caller has or one of its own (cell_order,
  the counting sort of csrc/cic_bin.cu that replaces the TPU factory's
  sort);
- K4 cic_readout3: the three force fields at particles in any order,
  rows in the caller's order (replaces readout_pallas.py:_readout_kernel;
  it launches K2's kernel with three fields, under its own counter);
  given a CellOrder it reads the rows in that order and scatters the
  values back;
- K5 cic_paint4: K1's deposit in two passes of 4 corners, periodic or
  homed (replaces paint_pallas.py:_paint_kernel4, both
  make_paint_from4_fn and make_paint_from4_homed_fn);
- K6 cic_readout4: the three-field readout with the 4 corners of each x
  plane of the cloud summed apart and the two sums added, periodic or
  homed (replaces readout_pallas.py:_readout_kernel4, both
  make_readout3_from4_fn and make_readout3_from4_homed_fn; the TPU
  kernel's two passes are one pass of K2's kernel here).

The port keeps the TPU kernels' contract, not their mechanism (see
csrc/*.cu). One kernel, csrc/cic_readout.cu, serves every readout (K2,
homed K2, K4, K6); it rounds each product and sum as the plain versions
do, in their order, so on the card the two agree bit for bit. One
deposit body, csrc/cic_deposit.cuh, serves K1, homed K1 and K3.

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

__all__ = ["Slab", "CellOrder", "cell_key", "sort_by_cell", "cell_order",
           "cell_order_plain", "slab_cell", "cic_paint",
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


class CellOrder(NamedTuple):
    """A permutation that puts one set of positions in cell order, as
    cell_order makes it: index (N,) int64, the rows grouped by the (x, y)
    line of their base cell, lines ascending. K3 and K4 take it as made
    (the multi-species force computes one per species and step and hands
    it to both); a plain index tensor passed as their `order` is first
    checked to be a permutation, which waits for the device."""

    index: torch.Tensor


def _line_key(x, nmesh, inv_cell):
    base, _ = cell_frac(x, nmesh, inv_cell)
    return base[:, 0] * nmesh[1] + base[:, 1]


def cell_order_plain(x: torch.Tensor, nmesh, inv_cell) -> CellOrder:
    """Plain cell_order: the stable sort of the rows by line."""
    return CellOrder(torch.sort(_line_key(x, nmesh, inv_cell),
                                stable=True).indices)


def cell_order(x: torch.Tensor, nmesh, inv_cell) -> CellOrder:
    """The CellOrder of positions x (N, 3) on a mesh. On CUDA this is a
    counting sort by line (csrc/cic_bin.cu: count, torch.cumsum, scatter),
    where the rows of one line come in no fixed order; on the CPU the
    plain version's stable sort."""
    _check_positions(x)
    nmesh = tuple(int(n) for n in nmesh)
    _check_mesh(nmesh)
    if x.device.type == "cpu":
        return cell_order_plain(x, nmesh, inv_cell)
    x = x.contiguous()
    head = (x.data_ptr(), x.shape[0], *nmesh, *_inv32(inv_cell))
    counts = torch.empty(nmesh[0] * nmesh[1], dtype=torch.int32,
                         device=x.device)
    _launch("fastpm_cic_bin_count", *head, counts.data_ptr(),
            device=x.device)
    cursor = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    order = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    _launch("fastpm_cic_bin_scatter", *head, cursor.data_ptr(),
            order.data_ptr(), device=x.device)
    cell_order.launches += 1
    return CellOrder(order)


cell_order.launches = 0


def _order_index(order, x):
    """The (N,) int64 permutation of an `order` argument for the rows of
    x. Raises on a wrong type, length or device, and on a plain tensor
    that is not a permutation."""
    made = isinstance(order, CellOrder)
    idx = order.index if made else order
    n = x.shape[0]
    if (not torch.is_tensor(idx) or idx.dtype != torch.int64
            or tuple(idx.shape) != (n,) or idx.device != x.device):
        raise ValueError("order must be a CellOrder or an (N,) int64 "
                         "permutation of the rows, on the device of the "
                         "positions")
    if not made and not torch.equal(
            torch.sort(idx).values, torch.arange(n, device=idx.device)):
        raise ValueError("order is not a permutation of the rows")
    return idx


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
    right for particles in any order; cell order lets a block's rows go
    through a shared-memory tile (the stale force paints in a carried
    order the rows have drifted from, still close enough for the tile).
    The canvas differs from run to run in the last bits (f32 atomics)."""
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
                   mass=1.0, order=None) -> torch.Tensor:
    """Add mass (a scalar or an (N,) float32 tensor) at every particle,
    in any order, into canvas (a contiguous (nx, ny, nz) float32 tensor
    on the device of x), in place; returns canvas. order, a CellOrder of
    x (or an (N,) int64 permutation, checked), is the order the rows are
    deposited in; on CUDA without one K3 computes it (cell_order), as
    the TPU kernel sorts its rows first. K3 (csrc/cic_paint_into.cu,
    K1's tiled deposit) reads the rows through it; the sum differs from
    run to run in the last bits (f32 atomics)."""
    _check_positions(x)
    nmesh, column = _check_canvas(canvas, x, mass)
    idx = None if order is None else _order_index(order, x)
    if x.device.type == "cpu":
        if idx is not None:
            x = torch.index_select(x, 0, idx)
            mass = torch.index_select(mass, 0, idx) if column else mass
        return cic_paint_into_plain(canvas, x, inv_cell, mass)
    idx = (cell_order(x, nmesh, inv_cell).index if idx is None
           else idx.contiguous())
    x = x.contiguous()
    masses = mass.contiguous() if column else None
    _launch("fastpm_cic_paint_into", x.data_ptr(), x.shape[0], *nmesh,
            *_inv32(inv_cell), 0.0 if column else float(mass),
            masses.data_ptr() if column else None, idx.data_ptr(),
            canvas.data_ptr(), device=x.device)
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


def _readout(fields, x, inv_cell, slab=None, two_planes=False):
    """Launch the readout kernel (csrc/cic_readout.cu) on checked
    inputs: (N, k) float32."""
    nmesh = tuple(fields[0].shape)
    x = x.contiguous()
    fields = [f.contiguous() for f in fields]
    ptrs = [f.data_ptr() for f in fields] + [None] * (3 - len(fields))
    out = torch.empty((x.shape[0], len(fields)), dtype=torch.float32,
                      device=x.device)
    n0, shift = (slab.n0, slab.shift) if slab is not None else (0, 0)
    _launch("fastpm_cic_readout", x.data_ptr(), x.shape[0], *nmesh,
            *_inv32(inv_cell), n0, shift, int(two_planes), *ptrs,
            len(fields), out.data_ptr(), device=x.device)
    return out


def _check_readout(fields, x, slab):
    """The fields as a list, after the checks of the readout wrappers."""
    _check_positions(x)
    fields = list(fields)
    if not 1 <= len(fields) <= 3:
        raise ValueError("the readout takes 1 to 3 fields")
    nmesh = _check_fields(fields, x)
    _check_slab(slab, nmesh)
    return fields


def cic_readout(fields, x: torch.Tensor, inv_cell) -> torch.Tensor:
    """Interpolate 1 to 3 (nx, ny, nz) float32 fields at every particle,
    (N, k) float32. On CUDA this launches K2 (csrc/cic_readout.cu). It
    is right for particles in any order; cell order (the carry force,
    the stale force's earlier order, the 2LPT lattice) lets the corner
    loads of neighbouring particles share cache lines."""
    fields = _check_readout(fields, x, None)
    if x.device.type == "cpu":
        return cic_readout_plain(fields, x, inv_cell)
    out = _readout(fields, x, inv_cell)
    cic_readout.launches += 1
    return out


cic_readout.launches = 0


def cic_readout_homed(fields, x: torch.Tensor, inv_cell,
                      slab: Slab) -> torch.Tensor:
    """Interpolate 1 to 3 extended slab fields ((nloc + 2H + 1, ny, nz)
    float32) at every particle, (N, k) float32; a particle beyond the
    slab reads zero. On CUDA this launches homed K2, K2's kernel with an
    open x axis (csrc/cic_readout.cu)."""
    fields = _check_readout(fields, x, slab)
    if x.device.type == "cpu":
        return cic_readout_plain(fields, x, inv_cell, slab)
    out = _readout(fields, x, inv_cell, slab)
    cic_readout_homed.launches += 1
    return out


cic_readout_homed.launches = 0


def cic_readout3(cx, cy, cz, x: torch.Tensor, inv_cell,
                 order=None) -> torch.Tensor:
    """Interpolate the three (nx, ny, nz) float32 force fields at every
    particle, in any order: (N, 3) float32, row i for particle i. On
    CUDA this launches K4, which is K2's kernel with three fields
    (csrc/cic_readout.cu): on unsorted particles it beat a kernel of its
    own (PERF.md). order, a CellOrder of x (or an (N,) int64
    permutation, checked), makes it read the rows in that order, where
    neighbouring particles share the corners' cache lines: the positions
    are gathered into it (index_select) and the values scattered back
    (an index_put_, which measured faster than index_copy_); a row's
    value does not depend on the order, so the result is the same bit
    for bit."""
    fields = _check_readout([cx, cy, cz], x, None)
    idx = None if order is None else _order_index(order, x)
    if idx is not None:
        x = torch.index_select(x, 0, idx)
    if x.device.type == "cpu":
        out = cic_readout_plain(fields, x, inv_cell)
    else:
        out = _readout(fields, x, inv_cell)
        cic_readout3.launches += 1
    if idx is None:
        return out
    back = torch.empty_like(out)
    back[idx] = out
    return back


cic_readout3.launches = 0


def cic_readout4(cx, cy, cz, x: torch.Tensor, inv_cell,
                 slab: Slab | None = None) -> torch.Tensor:
    """Interpolate the three force fields at every particle, the 4
    corners of each x plane of the cloud summed apart and the two sums
    added: (N, 3) float32. The fields are periodic, or extended slabs
    when slab is given (a particle beyond the slab reads zero). On CUDA
    this launches K6, K2's kernel summing plane by plane, in one pass
    (csrc/cic_readout.cu)."""
    fields = _check_readout([cx, cy, cz], x, slab)
    if x.device.type == "cpu":
        return cic_readout4_plain(*fields, x, inv_cell, slab)
    out = _readout(fields, x, inv_cell, slab, two_planes=True)
    cic_readout4.launches += 1
    return out


cic_readout4.launches = 0
