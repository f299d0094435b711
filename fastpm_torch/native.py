"""ctypes bindings for the native helper library (csrc/).

The native library provides the host-side, sequential-by-construction
pieces that must be bit-exact with the reference's RNG conventions:

- ranlxd: Luscher's double-precision RANLUX generator (the reference uses
  GSL's gsl_rng_ranlxd1 for all its random streams)
- gadget_ic_fill: the GADGET N-GenIC white-noise filler
  (initialcondition.c:144-273), OpenMP-parallel over mesh columns

The port's compute path is torch and its own CUDA kernels; this library
only runs at initialization time and for the host FOF. It is built from the
repository's csrc/ into build/fastpm_torch/, never next to the JAX package.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIBNAME = "_native.so"
_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
_CSRC = os.path.join(_ROOT, "csrc")
_BUILD = os.path.join(_ROOT, "build", "fastpm_torch")
_SRCS = [os.path.join(_CSRC, f) for f in ("ranlxd.c", "fof.c")]

_lib = None


def _has_all_symbols(path: str) -> bool:
    """A stale .so built from a subset of csrc/ must be rebuilt."""
    try:
        lib = ctypes.CDLL(path)
        return all(hasattr(lib, s)
                   for s in ("ranlxd_selftest", "fof_label"))
    except OSError:
        return False


def _build():
    os.makedirs(_BUILD, exist_ok=True)
    out = os.path.join(_BUILD, _LIBNAME)
    # build under a unique name and rename: concurrent test workers may
    # race to build, and a half-written .so must never be loaded
    tmp = "%s.%d.tmp" % (out, os.getpid())
    cmd = (["cc", "-O3", "-fopenmp", "-fPIC", "-shared"] + _SRCS
           + ["-o", tmp, "-lm"])
    subprocess.run(cmd, check=True)
    os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    path = os.path.join(_BUILD, _LIBNAME)
    if not os.path.exists(path) or not _has_all_symbols(path):
        if not all(os.path.exists(s) for s in _SRCS):
            raise RuntimeError("native library missing and csrc/ not found")
        path = _build()
    lib = ctypes.CDLL(path)
    lib.ranlxd_selftest.restype = ctypes.c_ulong
    lib.ranlxd_selftest.argtypes = [ctypes.c_ulong, ctypes.c_int]
    lib.ranlxd_fill_uniform.restype = None
    lib.ranlxd_fill_uniform.argtypes = [
        ctypes.c_ulong, ctypes.c_long,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")]
    lib.gadget_ic_fill.restype = None
    lib.gadget_ic_fill.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
        ctypes.c_int, ctypes.c_int,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")]
    _lib = lib
    return lib


def ranlxd_uniform(seed: int, n: int) -> np.ndarray:
    """n uniform doubles from a freshly seeded ranlxd1 stream."""
    out = np.empty(n, dtype=np.float64)
    get_lib().ranlxd_fill_uniform(seed, n, out)
    return out


def gadget_white_noise(Nmesh, seed: int, i0_start: int = 0,
                       i0_size: int = None) -> np.ndarray:
    """GADGET-scheme hermitian white noise, complex64 of shape
    (i0_size, N1, N2//2+1). Unit-variance modes (Rayleigh amplitude
    sqrt(-log u), uniform phase), seed-stable for any slab decomposition
    of the first axis."""
    n0, n1, n2 = Nmesh
    if i0_size is None:
        i0_size = n0 - i0_start
    buf = np.empty((i0_size, n1, n2 // 2 + 1, 2), dtype=np.float32)
    get_lib().gadget_ic_fill(n0, n1, n2, seed, i0_start, i0_size,
                             buf.reshape(-1))
    return buf[..., 0] + 1j * buf[..., 1]
