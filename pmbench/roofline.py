"""The least bytes each CIC kernel's work needs, and the card's peaks.

A kernel's roofline share is the least time its work could take on the
card (bytes over peak bandwidth: these kernels do a few operations a
byte) over its measured device time. The bytes count what the work
needs whatever implements it: each row's position (3 float32), weight
(a float32 where the species has a mass column) and output (3 float32)
read or written once, and each mesh read or written once (float32). No
sort, cell order or gather is counted.

- K1 (csrc/cic_paint.cu): paint one scalar-mass species into a new mesh.
- K2 (csrc/cic_readout.cu): read three force meshes at every row.
- K3 (csrc/cic_paint_into.cu): paint a species, scalar mass or a mass
  column, into the mesh.
- K4 (csrc/cic_readout.cu as cic_readout3): K2 given a cell order.

The whole step's share of the card's float32 peak (step_mfu) counts the
operations a FastPM time step needs: a real 3D FFT of M cells at 2.5 M
log2 M (half the 5 N log2 N of a complex one), one r2c and three c2r a
force; the k-space passes at 16 operations a mode (the r2c's scale, the
potential, each gradient and the c2r's scale, M / 2 modes) and one a
cell to normalise the canvas; a cloud-in-cell paint at 30 a row (the
cell, its fraction, 8 weights of 2 products and 8 sums) and a
three-component readout at 70 a row (the weights, 8 products and sums
of each component); a kick or a drift at 6 a row (3 products, 3 sums).
"""

from __future__ import annotations

import math

__all__ = ["PEAK_BYTES_PER_S", "PEAK_F32_FLOPS", "k1_bytes", "k2_bytes",
           "k3_bytes", "k4_bytes", "share_pct", "force_flops",
           "kick_drift_flops"]

# NVIDIA H100 SXM5 80 GB (data sheet, 700 W): HBM3 at 3.35 TB/s, 67
# TFLOP/s in float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
F32 = 4


def _cells(mesh) -> int:
    nx, ny, nz = mesh
    return int(nx) * int(ny) * int(nz)


def k1_bytes(rows: int, mesh) -> int:
    return rows * 3 * F32 + _cells(mesh) * F32


def k2_bytes(rows: int, mesh) -> int:
    return 3 * _cells(mesh) * F32 + rows * 3 * F32 + rows * 3 * F32


def k3_bytes(rows: int, mesh, mass_column: bool) -> int:
    return rows * (3 + int(mass_column)) * F32 + _cells(mesh) * F32


def k4_bytes(rows: int, mesh) -> int:
    return k2_bytes(rows, mesh)


def share_pct(nbytes: float, seconds: float):
    """The share of the bandwidth roofline in percent; None without
    device time."""
    if seconds <= 0:
        return None
    return 100.0 * nbytes / PEAK_BYTES_PER_S / seconds


def force_flops(rows, mesh) -> float:
    """Operations of one force action on the given rows (a list, one
    entry a species) and force mesh."""
    cells = _cells(mesh)
    fft = 2.5 * cells * math.log2(cells)
    return 4 * fft + 16 * cells / 2 + cells + sum(100 * n for n in rows)


def kick_drift_flops(rows: int) -> float:
    """Operations of one kick or one drift of `rows` rows."""
    return 6.0 * rows
