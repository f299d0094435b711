"""Build and load the port's CUDA kernels (fastpm_torch/csrc/*.cu).

At first use every source is compiled for sm_90a (Hopper) by its own
`nvcc`, all started together, and the objects are linked into
build/fastpm_torch/libfastpm_cuda.so, which is loaded with ctypes. The
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

__all__ = ["get_lib", "build", "launch", "SOURCES"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_HERE)
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(os.path.dirname(_PKG), "build", "fastpm_torch")
_LIBNAME = "libfastpm_cuda.so"
SOURCES = tuple(sorted(glob.glob(os.path.join(_CSRC, "*.cu"))))
# a library older than any source or shared header is rebuilt
_DEPENDS = SOURCES + tuple(sorted(glob.glob(os.path.join(_CSRC, "*.cuh"))))

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
    """Compile every source with its own nvcc process, all in parallel,
    link the objects into the shared library and return its path.
    Raises if any nvcc fails."""
    os.makedirs(_BUILD, exist_ok=True)
    nvcc = _nvcc()
    out = os.path.join(_BUILD, _LIBNAME)
    tag = os.getpid()
    flags = _FLAGS + (["-Xptxas", "-v"] if verbose else [])
    objs = [os.path.join(_BUILD, "%s.%d.o" % (
        os.path.splitext(os.path.basename(s))[0], tag)) for s in SOURCES]
    procs = [subprocess.Popen([nvcc, *_ARCH, *flags, "-c", src, "-o", obj])
             for src, obj in zip(SOURCES, objs)]
    failed = [src for src, p in zip(SOURCES, procs) if p.wait() != 0]
    if failed:
        raise RuntimeError("fastpm_torch: nvcc failed on %s" % failed)
    tmp = "%s.%d.tmp" % (out, tag)
    subprocess.run([nvcc, *_ARCH, "-shared", *objs, "-o", tmp], check=True)
    for obj in objs:
        os.remove(obj)
    # rename: a concurrent loader never sees a half-written library
    os.replace(tmp, out)
    return out


def _fresh(path: str) -> bool:
    return (os.path.exists(path) and all(
        os.path.getmtime(path) >= os.path.getmtime(s) for s in _DEPENDS))


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
    P, I, L, F, D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                     ctypes.c_float, ctypes.c_double)
    # (x, n, nx, ny, nz, icx, icy, icz, ...); the homed, two-pass and
    # readout entries then take the open axes (n0, shift, n1, yshift);
    # all end with the stream
    head = [P, L, I, I, I, F, F, F]
    for name, tail in (
            ("fastpm_cic_paint", [F, P, P]),
            # mass, masses, order, canvas
            ("fastpm_cic_paint_into", [F, P, P, P, P]),
            # bits, passes, workspace, order
            ("fastpm_cic_order", [I, I, P, P, P]),
            ("fastpm_cic_paint_homed", [I, I, I, I, F, P, P, P, P]),
            ("fastpm_cic_paint4", [I, I, I, I, F, P, P, P, P]),
            # two_planes, f0, f1, f2, k, out
            ("fastpm_cic_readout", [I, I, I, I, I, P, P, P, I, P, P])):
        fn = getattr(lib, name)
        fn.restype = I
        fn.argtypes = head + tail
    # (in pointers, out pointers, P, n, B, stream): host arrays of 1 + P
    # device pointers
    lib.fastpm_bitonic_merge.restype = I
    lib.fastpm_bitonic_merge.argtypes = [P, P, I, L, I, P]
    # (n, bits, passes): workspace bytes of fastpm_cic_order
    lib.fastpm_cic_order_workspace.restype = L
    lib.fastpm_cic_order_workspace.argtypes = [L, I, I]
    # (x, cid, n, ncol, inv, L, ll2, reach, outside, table, out, stream)
    lib.fastpm_fof_link.restype = I
    lib.fastpm_fof_link.argtypes = [P, P, L, I, F, D, D, D, P, P, P, P]
    # (in, out, n0, n1, n2, pos0, pos1, pos2, kk0, kk1, kk2, grad, axis,
    #  nyq0, nyq1, nyq2, deconv, dc0, dc1, dc2, norm, stream)
    lib.fastpm_kspace_grad.restype = I
    lib.fastpm_kspace_grad.argtypes = [P, P, I, I, I, I, I, I, P, P, P, P,
                                       I, P, P, P, I, P, P, P, F, P]
    _lib = lib
    return lib


def launch(name: str, *args, device) -> None:
    """Call the C entry point `name` on the current stream of device and
    raise if the launch failed."""
    import torch
    fn = getattr(get_lib(), name)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
