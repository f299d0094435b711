"""Legacy snapshot/noise formats (reference: src/runpb.c, readgrafic.c).

- RunPB (Martin White's TPM format): per-file header
  {int npart, int nsph, int nstar, float aa, float eps} wrapped in
  (eflag:int, hsize:int), followed by pos f4x3 (box units [0,1)),
  vel f4x3 (RSD units: v * RSD / boxsize with RSD = 1/(a E H0)), id i8.
- GRAFIC white noise: Fortran-record file of int32[4] header
  (n1, n2, n3, seed) then n1 planes of (n2*n3) float32 records;
  axes are transposed x<->z relative to the simulation.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from ..units import HUBBLE_CONSTANT

__all__ = ["write_runpb_snapshot", "read_runpb_snapshot",
           "read_grafic_gaussian"]

_HEADER = struct.Struct("<iiiff")


def write_runpb_snapshot(path: str, x, v, ids, aa: float, E: float,
                         boxsize: float, Nfile: int = 1):
    """Write a RunPB snapshot set path.%02d (write_runpb_snapshot,
    runpb.c:300-420). v is internal a^2 dx/dt / H0 in Mpc/h."""
    x = np.asarray(x, dtype=np.float64)
    v = np.asarray(v, dtype=np.float64)
    ids = np.asarray(ids, dtype=np.int64)
    n = len(x)
    RSD = 1.0 / (aa * E * HUBBLE_CONSTANT)
    eps = 0.1 / n ** (1.0 / 3)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    for i in range(Nfile):
        s = n * i // Nfile
        e = n * (i + 1) // Nfile
        with open("%s.%02d" % (path, i), "wb") as fp:
            fp.write(struct.pack("<ii", 1, _HEADER.size))
            fp.write(_HEADER.pack(e - s, 0, 0, aa, eps))
            fp.write((x[s:e] / boxsize).astype("<f4").tobytes())
            fp.write((v[s:e] * RSD * HUBBLE_CONSTANT / boxsize)
                     .astype("<f4").tobytes())
            fp.write(ids[s:e].astype("<i8").tobytes())


def read_runpb_snapshot(path: str):
    """Read a RunPB snapshot set; returns dict with box-unit positions,
    RSD-unit velocities, ids, and the scale factor."""
    xs, vs, ids = [], [], []
    aa = None
    i = 0
    while os.path.exists("%s.%02d" % (path, i)):
        with open("%s.%02d" % (path, i), "rb") as fp:
            eflag, hsize = struct.unpack("<ii", fp.read(8))
            if hsize != _HEADER.size:
                raise ValueError("not a RunPB file")
            npart, nsph, nstar, aa, eps = _HEADER.unpack(fp.read(hsize))
            xs.append(np.frombuffer(fp.read(12 * npart), "<f4")
                      .reshape(-1, 3))
            vs.append(np.frombuffer(fp.read(12 * npart), "<f4")
                      .reshape(-1, 3))
            ids.append(np.frombuffer(fp.read(8 * npart), "<i8"))
        i += 1
    if not xs:
        raise FileNotFoundError(path)
    return dict(x=np.concatenate(xs), v=np.concatenate(vs),
                id=np.concatenate(ids), aa=aa)


def read_grafic_gaussian(Nmesh, filename: str) -> np.ndarray:
    """Read a GRAFIC/BigMD Fortran white-noise file into a (Nx,Ny,Nz)
    array with the reference's x<->z transpose (readgrafic.c:11-84,
    src/fastpm.c:451-467: 'The simulation will be transformed
    x->z y->y z->x')."""
    n0, n1, n2 = Nmesh
    with open(filename, "rb") as fp:
        bs1, = struct.unpack("<i", fp.read(4))
        if bs1 != 16:
            raise ValueError("file not in BigMD noise format")
        n = struct.unpack("<iii", fp.read(12))
        seed, = struct.unpack("<i", fp.read(4))
        bs2, = struct.unpack("<i", fp.read(4))
        # file dims (n[0], n[1], n[2]) correspond to sim dims reversed
        if (n[0], n[1], n[2]) != (n2, n1, n0):
            raise ValueError(
                f"file is {n}, simulation needs {(n2, n1, n0)}")
        out = np.empty((n0, n1, n2), dtype=np.float32)
        for i0 in range(n0):
            bs, = struct.unpack("<i", fp.read(4))
            if bs != 4 * n[0] * n[1]:
                raise ValueError("file size is wrong")
            plane = np.frombuffer(fp.read(4 * n[0] * n[1]), "<f4")
            out[i0] = plane.reshape(n1, n2)
            fp.read(4)  # trailing record marker
    return out
