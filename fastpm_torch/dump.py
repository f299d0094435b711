"""Raw debug field dumps (fastpm_utils_dump / fastpm_utils_load,
libfastpm/utils.c:46-120) and their reader (python/fastpm.py DumpFile).

Port of fastpm_tpu/dump.py, host numpy: byte-compatible with the
reference. The real field is written in the FFTW in-place padded
layout (last dimension padded to 2*(Nz/2+1) f32 words) next to a text
`.geometry` sidecar describing start/size/strides for both the real and
complex views. Fields may be tensors on any device or numpy arrays.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["dump_field", "load_field", "DumpFile"]


def _regions(pm):
    nx, ny, nz = pm.Nmesh
    nzp = 2 * (nz // 2 + 1)
    real = dict(start=(0, 0, 0), size=(nx, ny, nz),
                strides=(ny * nzp, nzp, 1))
    comp = dict(start=(0, 0, 0), size=(nx, ny, nz // 2 + 1),
                strides=(ny * (nz // 2 + 1), nz // 2 + 1, 1))
    return real, comp


def dump_field(pm, filename: str, data) -> None:
    """Write a real (Nx,Ny,Nz) or complex (Nx,Ny,Nzh) field in the
    reference dump layout (single task)."""
    real, comp = _regions(pm)
    d = os.path.dirname(os.path.abspath(filename))
    os.makedirs(d, exist_ok=True)

    if hasattr(data, "detach"):
        data = data.detach().cpu().numpy()
    data = np.asarray(data)
    nx, ny, nz = pm.Nmesh
    nzp = 2 * (nz // 2 + 1)
    buf = np.zeros((nx, ny, nzp), dtype=np.float32)
    if np.iscomplexobj(data):
        view = buf.reshape(nx, ny, nzp // 2, 2)
        view[..., 0] = data.real
        view[..., 1] = data.imag
    else:
        buf[:, :, :nz] = data
    buf.tofile(filename)

    with open(filename + ".geometry", "w") as f:
        for tag, reg in (("real", real), ("complex", comp)):
            f.write("# %s\n" % tag)
            for key in ("start", "size", "strides"):
                f.write("%s: %d %d %d\n" % ((key,) + tuple(reg[key])))


def load_field(pm, filename: str, mode: str = "real"):
    """Inverse of dump_field (fastpm_utils_load)."""
    nx, ny, nz = pm.Nmesh
    nzp = 2 * (nz // 2 + 1)
    buf = np.fromfile(filename, dtype=np.float32).reshape(nx, ny, nzp)
    if mode == "real":
        return buf[:, :, :nz].copy()
    view = buf.reshape(nx, ny, nzp // 2, 2)
    return (view[..., 0] + 1j * view[..., 1]).astype(np.complex64)


class DumpFile(object):
    """Reader for (possibly multi-task) dumps -- the analog of
    python/fastpm.py:DumpFile."""

    def __init__(self, path: str, dtype="f4"):
        self.path = path
        dtype = np.dtype(dtype)
        self.rdtype = np.dtype("f8") if dtype == np.dtype("f8") \
            else np.dtype("f4")
        self.cdtype = np.dtype("complex128") \
            if dtype == np.dtype("f8") else np.dtype("complex64")
        self.filenames = []
        i = 0
        while True:
            fn = "%s.%03d" % (path, i)
            if not os.path.exists(fn):
                if i == 0:
                    if not os.path.exists(path):
                        raise OSError("File not found: %s" % path)
                    self.filenames.append(path)
                break
            self.filenames.append(fn)
            i += 1

    def _parse_geo(self, geofn, mode):
        with open(geofn) as f:
            lines = f.readlines()
        base = 0 if mode == "real" else 4
        start = np.array(lines[base + 1].split()[1:], dtype=int)
        size = np.array(lines[base + 2].split()[1:], dtype=int)
        strides = np.array(lines[base + 3].split()[1:], dtype=int)
        return strides, start, size

    def _guess_size(self, mode):
        hi = None
        for fn in self.filenames:
            strides, start, size = self._parse_geo(fn + ".geometry", mode)
            end = start + size
            hi = end if hi is None else np.maximum(hi, end)
        return tuple(hi)

    def _as(self, mode, dtype):
        shape = self._guess_size(mode)
        data = np.zeros(shape, dtype=dtype)
        for fn in self.filenames:
            strides, start, size = self._parse_geo(fn + ".geometry", mode)
            d = np.fromfile(fn, dtype=dtype)
            ind = tuple(slice(x, x + o) for x, o in zip(start, size))
            d = np.lib.stride_tricks.as_strided(
                d, shape=tuple(size),
                strides=tuple(strides * dtype.itemsize))
            data[ind] = d
        return data

    def as_real(self):
        return self._as("real", self.rdtype)

    def as_complex(self):
        return self._as("complex", self.cdtype)
