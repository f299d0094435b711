"""The PM's 3D FFTs, unnormalised: on the card one cuFFT plan per
direction, made, cached and executed here; on the CPU torch.fft
(pocketfft).

    r2c(x)        = sum_r x(r) exp(-i k.r)   (torch.fft.rfftn, "backward")
    c2r(k, shape) = sum_k k(k) exp(+i k.r)   (torch.fft.irfftn, "forward")

so c2r(r2c(x), x.shape) is Norm * x. Neither scales anything: PM.r2c
divides its output by Norm in place (pm_r2c's unitary convention, whose
inverse is c2r as it stands), and the force folds the scale into the
canvas it paints (gravity.py). r2c is out of place and returns the
transform contiguous in (x, y, z) order; c2r takes its input as given
up, since cuFFT's C2R overwrites it.

On the card a plan is one 3D R2C or C2R over the whole mesh, made with
cufftMakePlanMany64 (so a mesh past 2^31 cells takes the same path) once
per process for each (shape, direction, device): every pass builds its
own Solver and PMs, so the cache is not a PM's. A plan's work area is a
torch.empty from the caching allocator made for each execution
(cuFFT's auto-allocation off), so torch.cuda.max_memory_allocated counts
it; the plan runs on torch's current stream. cuFFT is the library torch
itself loaded, called through ctypes. Every CUDA transform takes a
plan: an input that is not contiguous is copied into (x, y, z) order
first, and another dtype or shape is an error.

stats counts the plans made, their executions, and the copies: CUDA
inputs that had to be made contiguous before their plan ran.
"""

from __future__ import annotations

import ctypes
import os

import torch

__all__ = ["r2c", "c2r", "stats", "work_bytes"]

stats = {"plans_made": 0, "execs": 0, "copies": 0}

# cufftType
_R2C, _C2R = 0x2A, 0x2C
# the sonames torch's builds load, newest first
_SONAMES = ("libcufft.so.12", "libcufft.so.11", "libcufft.so.10")

_lib = None
_plans = {}


def _loaded() -> ctypes.CDLL | None:
    """The cuFFT library already in the process, looked up by soname
    (never loaded a second time)."""
    for name in _SONAMES:
        try:
            return ctypes.CDLL(name, mode=os.RTLD_NOLOAD | os.RTLD_NOW)
        except OSError:
            pass
    return None


def _load() -> ctypes.CDLL:
    """The cuFFT library torch loaded: a one-point torch.fft call on the
    card first if torch has not loaded it yet."""
    lib = _loaded()
    if lib is None:
        torch.fft.rfft(torch.zeros(2, device="cuda"))
        lib = _loaded()
    if lib is None:
        raise RuntimeError("fastpm_torch: torch's cuFFT library (%s) is "
                           "not loaded" % ", ".join(_SONAMES))
    return lib


def _cufft() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _load()
        H, I, L, P = ctypes.c_int, ctypes.c_int, ctypes.c_longlong, \
            ctypes.c_void_p
        LP = ctypes.POINTER(ctypes.c_longlong)
        for name, args in (
                ("cufftCreate", [ctypes.POINTER(H)]),
                ("cufftSetAutoAllocation", [H, I]),
                # plan, rank, n, inembed, istride, idist, onembed,
                # ostride, odist, type, batch, work size
                ("cufftMakePlanMany64", [H, I, LP, LP, L, L, LP, L, L, I, L,
                                         ctypes.POINTER(ctypes.c_size_t)]),
                ("cufftSetStream", [H, P]),
                ("cufftSetWorkArea", [H, P]),
                ("cufftExecR2C", [H, P, P]),
                ("cufftExecC2R", [H, P, P])):
            fn = getattr(lib, name)
            fn.restype = I
            fn.argtypes = args
        _lib = lib
    return _lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"fastpm_torch: {what} failed: cufftResult {rc}")


class _Plan:
    """A cuFFT handle and the bytes of work area it asks for."""

    __slots__ = ("handle", "work")

    def __init__(self, shape, kind, device):
        lib = _cufft()
        h = ctypes.c_int()
        _check(lib.cufftCreate(ctypes.byref(h)), "cufftCreate")
        _check(lib.cufftSetAutoAllocation(h, 0), "cufftSetAutoAllocation")
        n = (ctypes.c_longlong * 3)(*shape)
        work = ctypes.c_size_t()
        with torch.cuda.device(device):
            _check(lib.cufftMakePlanMany64(h, 3, n, None, 1, 0, None, 1, 0,
                                           kind, 1, ctypes.byref(work)),
                   "cufftMakePlanMany64 %s" % (shape,))
        self.handle, self.work = h.value, work.value

    def __call__(self, fn: str, src: torch.Tensor, dst: torch.Tensor):
        """Run the plan from src into dst on the current stream, with a
        work area from the caching allocator."""
        lib = _cufft()
        device = src.device
        with torch.cuda.device(device):
            _check(lib.cufftSetStream(
                self.handle, torch.cuda.current_stream(device).cuda_stream),
                "cufftSetStream")
            # freed when the call returns: the allocator hands it out
            # again only to work queued after this on the stream
            work = torch.empty(self.work, dtype=torch.uint8, device=device)
            _check(lib.cufftSetWorkArea(self.handle, work.data_ptr()
                                        if self.work else None),
                   "cufftSetWorkArea")
            _check(getattr(lib, fn)(self.handle, src.data_ptr(),
                                    dst.data_ptr()), fn)
        stats["execs"] += 1


def _plan(shape, kind, device) -> _Plan:
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (tuple(shape), kind, device)
    plan = _plans.get(key)
    if plan is None:
        plan = _plans[key] = _Plan(shape, kind, device)
        stats["plans_made"] += 1
    return plan


def _kshape(shape):
    return (shape[0], shape[1], shape[2] // 2 + 1)


def _dense(t: torch.Tensor, dtype, shape) -> torch.Tensor:
    """A CUDA tensor as its plan takes it: 3D of dtype and shape (else
    an error), contiguous (a copy if not, counted)."""
    if t.dim() != 3 or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError("fastpm_torch: the FFT plans take %s of shape %s, "
                         "not %s of shape %s"
                         % (dtype, shape, t.dtype, tuple(t.shape)))
    if t.is_contiguous():
        return t
    stats["copies"] += 1
    return t.contiguous()


def work_bytes(shape, direction: str, device) -> int:
    """The work area the plan of direction ("r2c" or "c2r") over a real
    mesh of shape asks for at each execution (made if missing)."""
    return _plan(shape, {"r2c": _R2C, "c2r": _C2R}[direction],
                 device).work


def r2c(x: torch.Tensor) -> torch.Tensor:
    """The unnormalised real-to-complex transform of a 3D field, a new
    (Nx, Ny, Nz // 2 + 1) tensor in (x, y, z) order; x is kept."""
    if x.device.type != "cuda":
        return torch.fft.rfftn(x)
    x = _dense(x, torch.float32, tuple(x.shape))
    out = torch.empty(_kshape(x.shape), dtype=torch.complex64,
                      device=x.device)
    _plan(x.shape, _R2C, x.device)("cufftExecR2C", x, out)
    return out


def c2r(k: torch.Tensor, shape) -> torch.Tensor:
    """The unnormalised complex-to-real transform onto a real mesh of
    shape (no 1 / Norm). k is given up: on the card it is overwritten."""
    shape = tuple(int(n) for n in shape)
    if k.device.type != "cuda":
        return torch.fft.irfftn(k, s=shape, norm="forward")
    k = _dense(k, torch.complex64, _kshape(shape))
    out = torch.empty(shape, dtype=torch.float32, device=k.device)
    _plan(shape, _C2R, k.device)("cufftExecC2R", k, out)
    return out
