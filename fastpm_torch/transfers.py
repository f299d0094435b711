"""Fourier-space transfer functions (reference: libfastpm/transfer.c).

Port of fastpm_tpu/transfers.py. Every op is a pure function
delta_k -> delta_k on the hermitian-compressed complex tensor, built
from the PM's 1D per-dimension tables by broadcasting.
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import PM

__all__ = [
    "apply_smoothing", "apply_lowpass", "apply_decic", "apply_diff",
    "apply_laplace", "apply_pot", "apply_grad", "apply_any",
    "apply_c2r_weight", "apply_normalize", "set_mode", "get_mode",
]


def _sinc_np(x):
    x = np.asarray(x, dtype=np.float64)
    small = np.abs(x) < 1e-5
    xs = np.where(small, 1.0, x)
    return np.where(small, 1.0 - x * x / 6.0 + x ** 4 / 120.0, np.sin(xs) / xs)


def apply_smoothing(pm: PM, dk, sml: float):
    """Gaussian smoothing exp(-kk sml^2 / 2), separable (transfer.c:7-40)."""
    out = dk
    for d in range(3):
        kern = np.exp(-0.5 * pm.table("kk", d) * sml * sml)
        out = out * pm.broadcast(kern, d)
    return out


def apply_lowpass(pm: PM, dk, kth: float):
    """Sharp k-space lowpass at |k| = kth (transfer.c:42-65)."""
    return dk * (pm.kk() < kth * kth).to(pm.dtype)


def apply_decic(pm: PM, dk):
    """Divide by the CIC window squared: per-axis 1/sinc^2(w/2)
    (transfer.c:77-113)."""
    out = dk
    for d in range(3):
        w = pm.table("k", d) * pm.BoxSize[d] / pm.Nmesh[d]
        out = out * pm.broadcast(1.0 / _sinc_np(0.5 * w) ** 2, d)
    return out


def apply_diff(pm: PM, dk, dir: int, order: int, zero_nyquist: bool = True):
    """i k[dir] (order 0) or i k_finite[dir] (order 1, the 4-point
    super-Lanczos kernel). Self-conjugate (Nyquist) modes are zeroed so the
    result stays the transform of a real field (gravity.c:34-64)."""
    kd = pm.broadcast_table(["k", "k_finite"][order], dir)
    out = dk * torch.complex(torch.zeros_like(kd), kd)
    if zero_nyquist:
        out = out * pm.not_self_conjugate()
    return out


def apply_laplace(pm: PM, dk, order: int):
    """Inverse Laplacian 1/kk with finite-difference order 0/1/2
    (transfer.c:153-186); the zero mode is zeroed."""
    kk = pm.kk(["kk", "kk_finite", "kk_finite2"][order])
    nz = kk != 0
    inv = torch.where(nz, 1.0 / torch.where(nz, kk, torch.ones_like(kk)),
                      torch.zeros_like(kk))
    return dk * inv


def apply_pot(pm: PM, dk, order: int):
    """-1/kk: Poisson potential from overdensity (gravity.c:13-18)."""
    return -apply_laplace(pm, dk, order)


def apply_grad(pm: PM, dk, dir: int, order: int):
    """Gradient of a potential field: i k (order per kernel type)
    (gravity.c:20-64)."""
    return apply_diff(pm, dk, dir, order, zero_nyquist=True)


def apply_any(pm: PM, dk, fkfunc):
    """Multiply by a scalar function of |k| (transfer.c:188-210). |k| is
    the square root of the float32 |k|^2 table sum; fkfunc takes and
    returns tensors."""
    k = torch.sqrt(pm.kk())
    return dk * fkfunc(k).to(pm.dtype)


def apply_c2r_weight(pm: PM, dk):
    """Weight each mode by its hermitian multiplicity (transfer.c:250-277)."""
    return dk * pm.hermitian_weights()


def apply_normalize(pm: PM, dk):
    """Divide by the DC mode (transfer.c:222-248)."""
    return dk / dk[0, 0, 0].real


def _conj_index(pm: PM, mode):
    return tuple((pm.Nmesh[d] - mode[d]) % pm.Nmesh[d] for d in range(3))


def set_mode(pm: PM, dk, mode, value: float, method: str = "override"):
    """Set or add to a single mode (and its hermitian conjugate)
    (transfer.c:285-337). mode = (ix, iy, iz, ri) with ri 0=real 1=imag.
    Returns a new tensor."""
    ix, iy, iz, ri = [int(m) for m in mode]
    conj = _conj_index(pm, (ix, iy, iz))
    self_conj = conj == (ix, iy, iz)
    if self_conj and ri == 1:
        # purely real mode; cannot set imaginary part
        method = "override"
        value = 0.0
    dk = dk.clone()
    view = torch.view_as_real(dk)

    def apply_at(idx, val):
        i, j, l = idx
        if l > pm.Nmesh[2] // 2:
            # lives on the conjugate side of the compressed axis;
            # handled via its conjugate partner
            return
        if method == "override":
            view[i, j, l, ri] = val
        else:
            view[i, j, l, ri] += val

    apply_at((ix, iy, iz), value)
    if not self_conj:
        apply_at(conj, value * (1 if ri == 0 else -1))
    return dk


def get_mode(pm: PM, dk, mode) -> float:
    ix, iy, iz, ri = [int(m) for m in mode]
    if iz > pm.Nmesh[2] // 2:
        ix, iy, iz = _conj_index(pm, (ix, iy, iz))
        v = complex(dk[ix, iy, iz])
        return float(v.real if ri == 0 else -v.imag)
    v = complex(dk[ix, iy, iz])
    return float(v.real if ri == 0 else v.imag)
