"""Build and load the port's CUDA kernels (fastpm_torch/csrc/*.cu).

At first use one `nvcc` call compiles every source for sm_90a (Hopper)
into build/fastpm_torch/libfastpm_cuda.so, which is loaded with ctypes. The
entry points have a plain C interface: pointers and the CUDA stream
pass as c_void_p, and each returns cudaGetLastError(). Nothing here runs
at import time, so the package imports where there is no nvcc.
"""

from __future__ import annotations

import ctypes
import glob
import os
import subprocess
import time

__all__ = ["get_lib", "build", "SOURCES"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_HERE)
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(os.path.dirname(_PKG), "build", "fastpm_torch")
_LIBNAME = "libfastpm_cuda.so"
SOURCES = tuple(sorted(glob.glob(os.path.join(_CSRC, "*.cu"))))

_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("fastpm_torch: no CUDA toolkit found (nvcc is "
                           "needed to build the kernels)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(verbose: bool = False) -> str:
    """Compile every source into the shared library with one nvcc call
    and return its path. Raises if nvcc fails."""
    os.makedirs(_BUILD, exist_ok=True)
    out = os.path.join(_BUILD, _LIBNAME)
    tmp = "%s.%d.tmp" % (out, os.getpid())
    flags = _FLAGS + (["-Xptxas", "-v"] if verbose else [])
    subprocess.run([_nvcc(), *_ARCH, *flags, "-shared", *SOURCES,
                    "-o", tmp], check=True)
    # rename: a concurrent loader never sees a half-written library
    os.replace(tmp, out)
    return out


def _fresh(path: str) -> bool:
    return (os.path.exists(path) and all(
        os.path.getmtime(path) >= os.path.getmtime(s) for s in SOURCES))


def get_lib(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or older than
    a source."""
    global _lib
    if _lib is not None:
        return _lib
    path = os.path.join(_BUILD, _LIBNAME)
    if not _fresh(path):
        t0 = time.perf_counter()
        path = build(verbose=verbose)
        if verbose:
            print("fastpm_torch: built %s in %.1f s"
                  % (path, time.perf_counter() - t0))
    lib = ctypes.CDLL(path)
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.fastpm_cic_paint.restype = I
    lib.fastpm_cic_paint.argtypes = [P, L, I, I, I, F, F, F, F, P, P, P]
    lib.fastpm_cic_readout.restype = I
    lib.fastpm_cic_readout.argtypes = [P, L, I, I, I, F, F, F, P, P, P, I,
                                       P, P]
    _lib = lib
    return lib
