"""CIC paint (K1) and readout (K2): the hand-written CUDA kernels, their
plain PyTorch versions, and the cell sort that prepares their input.

The TPU kernels these replace are fastpm_tpu/ops/paint_pallas.py:
_paint_kernel8 and fastpm_tpu/ops/readout_pallas.py:_readout_kernel8.
The port keeps their contract, not their mechanism (see csrc/*.cu).

Every function takes positions x (N, 3) float32 in box units and the
mesh as (Nmesh, InvCellSize). The base cell and fraction follow
base_cell_frac (paint_pallas.py:273-284) in float32: g = x * InvCellSize,
base = floor(g) wrapped with a remainder (a position equal to the box
size after a float32 wrap floors to Nmesh and wraps to 0), frac = g -
floor(g). The corner weights follow w8_from_frac: ((wx * wy) * wz).

`cic_paint` / `cic_readout` dispatch on the device of x: a CPU tensor
takes the plain version, a CUDA tensor launches the kernel (built at
first use) or raises. Each wrapper counts its kernel launches in its
`launches` attribute.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

__all__ = ["cell_key", "sort_by_cell", "cic_paint", "cic_readout",
           "cic_paint_plain", "cic_readout_plain"]

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


def cic_paint_plain(x: torch.Tensor, nmesh, inv_cell,
                    mass=1.0) -> torch.Tensor:
    """Plain K1: index_add_ of the 8 weighted corners. mass is a scalar
    or an (N,) float32 tensor."""
    canvas = torch.zeros(int(np.prod(nmesh)), dtype=torch.float32,
                         device=x.device)
    for idx, w in _corners(x, nmesh, inv_cell):
        canvas.index_add_(0, idx, w * mass)
    return canvas.reshape(tuple(nmesh))


def cic_readout_plain(fields, x: torch.Tensor, inv_cell) -> torch.Tensor:
    """Plain K2: gather of the 8 corners and a weighted sum, (N, k)."""
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


def cic_paint(x: torch.Tensor, nmesh, inv_cell, mass=1.0) -> torch.Tensor:
    """Deposit mass (a scalar or an (N,) float32 tensor) at every
    particle into a new (nx, ny, nz) float32 canvas. On CUDA this
    launches K1 (csrc/cic_paint.cu); the canvas differs from run to run
    in the last bits (f32 atomics)."""
    _check_positions(x)
    nmesh = tuple(int(n) for n in nmesh)
    _check_mesh(nmesh)
    column = torch.is_tensor(mass)
    if column and (mass.dtype != torch.float32
                   or tuple(mass.shape) != (x.shape[0],)
                   or mass.device != x.device):
        raise ValueError("mass must be a scalar or an (N,) float32 tensor "
                         "on the device of the positions")
    if x.device.type == "cpu":
        return cic_paint_plain(x, nmesh, inv_cell, mass)
    from .cudalib import get_lib
    lib = get_lib()
    x = x.contiguous()
    masses = mass.contiguous() if column else None
    canvas = torch.zeros(nmesh, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.fastpm_cic_paint(x.data_ptr(), x.shape[0], *nmesh,
                                  *_inv32(inv_cell),
                                  0.0 if column else float(mass),
                                  masses.data_ptr() if column else None,
                                  canvas.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"cic_paint kernel launch failed: CUDA error {rc}")
    cic_paint.launches += 1
    return canvas


cic_paint.launches = 0


def cic_readout(fields, x: torch.Tensor, inv_cell) -> torch.Tensor:
    """Interpolate 1 to 3 (nx, ny, nz) float32 fields at every particle,
    (N, k) float32. On CUDA this launches K2 (csrc/cic_readout.cu)."""
    _check_positions(x)
    fields = list(fields)
    if not 1 <= len(fields) <= 3:
        raise ValueError("cic_readout takes 1 to 3 fields")
    nmesh = tuple(fields[0].shape)
    _check_mesh(nmesh)
    for f in fields:
        if (f.dtype != torch.float32 or tuple(f.shape) != nmesh
                or f.device != x.device):
            raise ValueError("fields must be float32 of one shape, on the "
                             "device of the positions")
    if x.device.type == "cpu":
        return cic_readout_plain(fields, x, inv_cell)
    from .cudalib import get_lib
    lib = get_lib()
    x = x.contiguous()
    fields = [f.contiguous() for f in fields]
    ptrs = [f.data_ptr() for f in fields] + [None] * (3 - len(fields))
    out = torch.empty((x.shape[0], len(fields)), dtype=torch.float32,
                      device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.fastpm_cic_readout(x.data_ptr(), x.shape[0], *nmesh,
                                    *_inv32(inv_cell), *ptrs, len(fields),
                                    out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(
            f"cic_readout kernel launch failed: CUDA error {rc}")
    cic_readout.launches += 1
    return out


cic_readout.launches = 0
