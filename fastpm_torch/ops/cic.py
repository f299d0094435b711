"""CIC paint and readout: the hand-written CUDA kernels, their plain
PyTorch versions, and the cell sort that prepares the order-free force.

- K1 cic_paint: cell-sorted particles, scalar mass, a new canvas
  (replaces fastpm_tpu/ops/paint_pallas.py:_paint_kernel8);
- K2 cic_readout: 1-3 fields at cell-sorted particles and at the 2LPT
  lattice (replaces fastpm_tpu/ops/readout_pallas.py:_readout_kernel8);
- K3 cic_paint_into: particles in any order, scalar mass or a mass
  column, added into a canvas the caller owns (replaces
  paint_pallas.py:_paint_kernel);
- K4 cic_readout3: the three force fields at particles in any order,
  rows in the caller's order (replaces readout_pallas.py:_readout_kernel;
  it launches K2's kernel with three fields, under its own counter).

The port keeps the TPU kernels' contract, not their mechanism (see
csrc/*.cu).

Every function takes positions x (N, 3) float32 in box units and the
mesh as (Nmesh, InvCellSize). The base cell and fraction follow
base_cell_frac (paint_pallas.py:273-284) in float32: g = x * InvCellSize,
base = floor(g) wrapped with a remainder (a position equal to the box
size after a float32 wrap floors to Nmesh and wraps to 0), frac = g -
floor(g). The corner weights follow w8_from_frac: ((wx * wy) * wz).

Every wrapper dispatches on the device of x: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel (built at first use)
or raises. Each wrapper counts its kernel launches in its `launches`
attribute.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

__all__ = ["cell_key", "sort_by_cell", "cic_paint", "cic_readout",
           "cic_paint_into", "cic_readout3", "cic_paint_plain",
           "cic_paint_into_plain", "cic_readout_plain"]

# the cell key is int32: nx * ny * nz must stay below 2^31, which holds
# up to a 1290^3 mesh
_MAX_CELLS = 2 ** 31


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


def _corners(x, nmesh, inv_cell):
    """Yield (flat index (N,) int64, weight (N,) float32) for the 8 CIC
    corners, dx-major like w8_from_frac."""
    nx, ny, nz = nmesh
    base, f = cell_frac(x, nmesh, inv_cell)
    t = 1.0 - f
    hi = torch.where(base + 1 == torch.tensor(nmesh, device=x.device),
                     torch.zeros_like(base), base + 1)
    for dx, dy, dz in itertools.product((0, 1), repeat=3):
        ix = (hi if dx else base)[:, 0]
        iy = (hi if dy else base)[:, 1]
        iz = (hi if dz else base)[:, 2]
        w = ((f if dx else t)[:, 0] * (f if dy else t)[:, 1]
             * (f if dz else t)[:, 2])
        yield (ix * ny + iy) * nz + iz, w


def cic_paint_into_plain(canvas: torch.Tensor, x: torch.Tensor, inv_cell,
                         mass=1.0) -> torch.Tensor:
    """Plain K3: index_add_ of the 8 weighted corners into canvas (a
    contiguous (nx, ny, nz) float32 tensor, updated in place and
    returned). mass is a scalar or an (N,) float32 tensor."""
    flat = canvas.view(-1)
    for idx, w in _corners(x, tuple(canvas.shape), inv_cell):
        flat.index_add_(0, idx, w * mass)
    return canvas


def cic_paint_plain(x: torch.Tensor, nmesh, inv_cell,
                    mass=1.0) -> torch.Tensor:
    """Plain K1: the deposit into a new zeroed canvas."""
    canvas = torch.zeros(tuple(nmesh), dtype=torch.float32, device=x.device)
    return cic_paint_into_plain(canvas, x, inv_cell, mass)


def cic_readout_plain(fields, x: torch.Tensor, inv_cell) -> torch.Tensor:
    """Plain K2 and K4: gather of the 8 corners and a weighted sum,
    (N, k)."""
    nmesh = tuple(fields[0].shape)
    flat = [f.reshape(-1) for f in fields]
    out = torch.zeros((x.shape[0], len(fields)), dtype=torch.float32,
                      device=x.device)
    for idx, w in _corners(x, nmesh, inv_cell):
        for c, f in enumerate(flat):
            out[:, c] += w * f[idx]
    return out


def _check_positions(x: torch.Tensor):
    if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] != 3:
        raise ValueError(f"positions must be (N, 3) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _check_mesh(nmesh):
    if len(nmesh) != 3 or int(np.prod(nmesh)) >= _MAX_CELLS:
        raise ValueError(f"unsupported mesh {tuple(nmesh)}")


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


def _launch(name, *args, device):
    """Call the C entry point `name` on the current stream of device and
    raise if the launch failed."""
    from .cudalib import get_lib
    fn = getattr(get_lib(), name)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def cic_paint(x: torch.Tensor, nmesh, inv_cell, mass=1.0) -> torch.Tensor:
    """Deposit a scalar mass at every particle into a new (nx, ny, nz)
    float32 canvas. On CUDA this launches K1 (csrc/cic_paint.cu), meant
    for cell-sorted particles; the canvas differs from run to run in the
    last bits (f32 atomics)."""
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
