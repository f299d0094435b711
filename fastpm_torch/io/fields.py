"""Complex-field (delta_k) dumps: LinearDensityK / WhiteNoiseK / DensityK
blocks, and real-field blocks (reference: libfastpmio/io.c:641-826).

Port of fastpm_tpu/io/fields.py: the same files on disk. A complex
field is a bigfile block of dtype c8, rows in C order of the global
(Nmesh, Nmesh, Nmesh/2+1) hermitian array, with ndarray.* shape attrs.
PM.kshape is already that order, so the write is a flat host dump of
the tensor (the reference needs an mpsort rendezvous). Fields may be
tensors on any device or numpy arrays; reads return host numpy."""

from __future__ import annotations

import numpy as np

from .bigfile import BigFile
from ..mesh import PM

__all__ = ["write_complex", "read_complex", "write_real", "read_real"]


def _host(data, dtype) -> np.ndarray:
    """A field as a contiguous host array of dtype (a tensor is copied
    off its device)."""
    if hasattr(data, "detach"):
        data = data.detach().cpu().numpy()
    return np.ascontiguousarray(data, dtype=dtype)


def _set_attrs(block, pm: PM, shape):
    nm = pm.Nmesh[0]
    strides = [shape[1] * shape[2], shape[2], 1]
    block.attrs.set("ndarray.ndim", np.int32(3), "i4")
    block.attrs.set("ndarray.strides", np.asarray(strides, dtype=np.int64),
                    "i8")
    block.attrs.set("ndarray.shape", np.asarray(shape, dtype=np.int64), "i8")
    block.attrs.set("Nmesh", np.int32(nm), "i4")
    block.attrs.set("BoxSize", float(pm.BoxSize[0]), "f8")


def write_complex(pm: PM, data, filename: str, blockname: str,
                  Nfile: int = 1):
    arr = _host(data, np.complex64)
    nm = pm.Nmesh[0]
    block = BigFile(filename, create=True).create_block(
        blockname, arr.reshape(-1, 1), Nfile=Nfile)
    _set_attrs(block, pm, [nm, nm, nm // 2 + 1])


def read_complex(pm: PM, filename: str, blockname: str) -> np.ndarray:
    block = BigFile(filename).open_block(blockname)
    return block.read_all().reshape(pm.kshape).astype(np.complex64)


def write_real(pm: PM, data, filename: str, blockname: str,
               Nfile: int = 1):
    """Real-space field block (the write_linearr path,
    src/fastpm.c:685-689)."""
    arr = _host(data, np.float32)
    nm = pm.Nmesh[0]
    block = BigFile(filename, create=True).create_block(
        blockname, arr.reshape(-1, 1), Nfile=Nfile)
    _set_attrs(block, pm, [nm, nm, nm])


def read_real(pm: PM, filename: str, blockname: str) -> np.ndarray:
    block = BigFile(filename).open_block(blockname)
    return block.read_all().reshape(pm.rshape).astype(np.float32)
