"""Particle <-> mesh painting and readout (reference: libfastpm/painter.c,
painter-cic.c).

Port of fastpm_tpu/painter.py. Paint is a scatter-add (index_add_) of
the support^3 kernel-weighted corner contributions, readout the matching
gather. Periodic wrapping is index arithmetic.

Kernel types match the reference:
- cic / linear: 1 - |x|            (painter.c:17-29; CIC is support=2)
- quad (TSC-like):                  painter.c:31-61
- lanczos: sinc(x) sinc(x/h)        painter.c:84-125
The generic path normalizes kernel weights per-axis to conserve mass
(painter.c:195-213) and supports gradient readout along one axis
(diffdir, painter.c:178-213).

CIC with no diffdir goes through ops/cic.py: paint through K3 (any
particle order, scalar or per-particle mass, into a given canvas),
readout through K2 with one field, readout3 through K4; paint and
readout3 take the particles' CellOrder where the caller has one. On a
CUDA tensor those are the kernels, on the CPU their plain versions. The
generic path serves quad, lanczos and gradient readouts.
"""

from __future__ import annotations

import itertools

import torch

from .mesh import PM
from .ops import cic

__all__ = ["Painter"]

_PI32 = 3.1415927


def _linear_kernel(x, invh):
    return 1.0 - torch.abs(x * invh)


def _linear_diff(x, invh):
    return torch.where(x < 0, invh, -invh)


def _quad_kernel(x, invh):
    x = torch.abs(x) * invh
    return torch.where(x <= 0.5, 0.75 - x * x, 0.5 * (1.5 - x) ** 2)


def _quad_diff(x, invh):
    factor = torch.where(x < 0, -invh, invh)
    ax = torch.abs(x) * invh
    return factor * torch.where(ax < 0.5, -2 * ax, -(1.5 - ax))


def _sinc(x):
    x = x * _PI32
    small = torch.abs(x) < 1e-5
    xs = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, 1.0 - x * x / 6.0 + x ** 4 / 120.0,
                       torch.sin(xs) / xs)


def _dsinc(x):
    x = x * _PI32
    small = torch.abs(x) < 1e-5
    xs = torch.where(small, torch.ones_like(x), x)
    series = -x / 3 + x ** 3 / 30 - x ** 5 / 840 + x ** 7 / 45360
    main = torch.cos(xs) / xs - torch.sin(xs) / (xs * xs)
    return _PI32 * torch.where(small, series, main)


def _lanczos_kernel(x, invh):
    return _sinc(x) * _sinc(x * invh)


def _lanczos_diff(x, invh):
    return _sinc(x) * _dsinc(x * invh) * invh + _dsinc(x) * _sinc(x * invh)


_KERNELS = {
    "cic": (_linear_kernel, _linear_diff, 2),
    "linear": (_linear_kernel, _linear_diff, 2),
    "quad": (_quad_kernel, _quad_diff, 3),
    "lanczos": (_lanczos_kernel, _lanczos_diff, None),
}


class Painter:
    """Mass deposit / field readout with a separable kernel of given
    support. `diffdir >= 0` replaces the kernel along that axis with its
    derivative (gradient readout)."""

    def __init__(self, pm: PM, type: str = "cic", support: int = 2,
                 diffdir: int = -1):
        if type not in _KERNELS:
            raise ValueError(f"unknown painter type {type!r}")
        kernel, diff, fixed_support = _KERNELS[type]
        if fixed_support is not None:
            support = fixed_support
        if support > 32:
            raise ValueError("support must be <= 32 (painter.c:221)")
        self.pm = pm
        self.type = type
        self.kernel = kernel
        self.diff = diff
        self.support = int(support)
        self.invh = 1.0 / (0.5 * self.support)
        self.left = (self.support - 1) // 2
        self.shift = 0.0 if self.support % 2 == 0 else 0.5
        self.diffdir = diffdir
        self.offsets = list(itertools.product(range(self.support),
                                              repeat=3))

    @property
    def is_cic(self) -> bool:
        """Whether paint and readout go through the CIC kernels
        (ops/cic.py), which take a CellOrder."""
        return self.type == "cic" and self.diffdir < 0

    # ---- generic kernel evaluation ----

    def _base_and_frac(self, pos):
        """pos (N,3) -> (ipos (N,3) int64 base cell, dx (N,3) fraction,
        ksum (N,3) per-axis normalization)."""
        inv_cell = torch.tensor(self.pm.InvCellSize, dtype=pos.dtype,
                                device=pos.device)
        gpos = pos * inv_cell
        ipos = torch.floor(gpos + self.shift).to(torch.int64) - self.left
        dx = gpos - ipos
        ksum = 0.0
        for i in range(self.support):
            ksum = ksum + self.kernel(dx - i, self.invh)
        return ipos, dx, ksum

    def _axis_weight(self, dx, ksum, off, d):
        """Normalized kernel value for corner offset `off` along axis d.
        The normalization always comes from the true kernel; diffdir
        replaces the value with the derivative (painter.c:195-213)."""
        x = dx[:, d] - off
        if d == self.diffdir:
            k = self.diff(x, self.invh) * self.pm.InvCellSize[d]
        else:
            k = self.kernel(x, self.invh)
        return k / ksum[:, d]

    def _corner_flat(self, ipos, off):
        """Flattened periodic mesh index for one corner offset (N,)."""
        n = self.pm.Nmesh
        ix = torch.remainder(ipos[:, 0] + off[0], n[0])
        iy = torch.remainder(ipos[:, 1] + off[1], n[1])
        iz = torch.remainder(ipos[:, 2] + off[2], n[2])
        return (ix * n[1] + iy) * n[2] + iz

    def _corner_weight(self, dx, ksum, off):
        return (self._axis_weight(dx, ksum, off[0], 0)
                * self._axis_weight(dx, ksum, off[1], 1)
                * self._axis_weight(dx, ksum, off[2], 2))

    # ---- public API ----

    def paint(self, pos, mass=1.0, canvas=None, order=None):
        """Deposit mass (scalar or (N,) tensor) at pos (N,3) into canvas
        (a contiguous pm.rshape tensor, updated in place; a new zeroed
        one if None). Returns the accumulated canvas. order: the
        CellOrder of pos for the CIC kernels (K3 sorts by itself
        without one); the other kernels ignore it."""
        pm = self.pm
        if canvas is None:
            canvas = torch.zeros(pm.rshape, dtype=pm.dtype,
                                 device=pos.device)
        if self.is_cic:
            return cic.cic_paint_into(canvas, pos, pm.InvCellSize, mass,
                                      order)
        flat = canvas.view(-1)
        ipos, dx, ksum = self._base_and_frac(pos)
        for off in self.offsets:
            w = self._corner_weight(dx, ksum, off) * mass
            flat.index_add_(0, self._corner_flat(ipos, off),
                            w.to(pm.dtype))
        return canvas

    def readout(self, canvas, pos):
        """Interpolate canvas at pos (N,3) -> (N,)."""
        if self.is_cic:
            return cic.cic_readout([canvas], pos, self.pm.InvCellSize)[:, 0]
        ipos, dx, ksum = self._base_and_frac(pos)
        flat = canvas.reshape(-1)
        out = 0.0
        for off in self.offsets:
            out = out + (flat[self._corner_flat(ipos, off)]
                         * self._corner_weight(dx, ksum, off))
        return out

    def readout3(self, cx, cy, cz, pos, order=None):
        """Three-component force readout (N,3) -- the gravity hot path.
        order: the CellOrder of pos, in which K4 reads the rows (CIC
        only; rows come back in the given order either way)."""
        if self.is_cic:
            return cic.cic_readout3(cx, cy, cz, pos, self.pm.InvCellSize,
                                    order)
        return torch.stack([self.readout(f, pos) for f in (cx, cy, cz)],
                           dim=-1)
