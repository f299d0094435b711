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
    "apply_smoothing", "apply_lowpass", "decic_table", "apply_decic",
    "apply_diff",
    "apply_laplace", "apply_pot", "apply_grad", "apply_any",
    "apply_fk_interp",
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


def decic_table(pm: PM, d: int) -> torch.Tensor:
    """The float32 factor 1/sinc^2(w/2) along axis d, shaped for
    broadcasting over k-space and kept on the PM."""
    def make():
        w = pm.table("k", d) * pm.BoxSize[d] / pm.Nmesh[d]
        return pm.broadcast(1.0 / _sinc_np(0.5 * w) ** 2, d)
    return pm._const(("decic", d), make)


def apply_decic(pm: PM, dk):
    """Divide by the CIC window squared: per-axis 1/sinc^2(w/2)
    (transfer.c:77-113)."""
    out = dk
    for d in range(3):
        out = out * decic_table(pm, d)
    return out


def apply_diff(pm: PM, dk, dir: int, order: int, zero_nyquist: bool = True,
               out=None):
    """i k[dir] (order 0) or i k_finite[dir] (order 1, the 4-point
    super-Lanczos kernel). Self-conjugate (Nyquist) modes are zeroed so the
    result stays the transform of a real field (gravity.c:34-64). The
    result is one new tensor, masked in place, or out (dk itself, for a
    caller that gives dk up)."""
    kd = pm.broadcast_table(["k", "k_finite"][order], dir)
    out = torch.mul(dk, torch.complex(torch.zeros_like(kd), kd), out=out)
    if zero_nyquist:
        out.mul_(pm.not_self_conjugate())
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
    """-1/kk: Poisson potential from overdensity (gravity.c:13-18), the
    sign taken in place on the product."""
    return apply_laplace(pm, dk, order).neg_()


def apply_grad(pm: PM, dk, dir: int, order: int, out=None):
    """Gradient of a potential field: i k (order per kernel type)
    (gravity.c:20-64); out as apply_diff's."""
    return apply_diff(pm, dk, dir, order, zero_nyquist=True, out=out)


def apply_any(pm: PM, dk, fkfunc, host_tables: bool = False):
    """Multiply by a scalar function of |k| (transfer.c:188-210). |k| is
    the square root of the float32 |k|^2 table sum; fkfunc takes and
    returns tensors. host_tables=True evaluates fkfunc (numpy in, numpy
    out, such as an np.interp of a table) in float64 on the host grid of
    the float32 tables' sum, and casts the factor to float32: for the
    once-a-run IC transfers (png.py)."""
    if host_tables:
        kk = sum(np.reshape(pm.table("kk", d),
                            [-1 if i == d else 1 for i in range(3)])
                 for d in range(3))
        kern = np.asarray(fkfunc(np.sqrt(kk)), dtype=np.float64)
        return dk * torch.from_numpy(kern.astype(np.float32)).to(dk.device)
    k = torch.sqrt(pm.kk())
    return dk * fkfunc(k).to(pm.dtype)


def _fk_interp_index(pm: PM, logk: torch.Tensor, key=None):
    """(j, t) of every mode for apply_fk_interp: f = fpe[j] + t (fpe[j +
    1] - fpe[j]) over the table fpe = (vals, vals[-1], 0, 0) is
    jnp.interp(log|k|; logk, vals) with its clamps (j = 0, t = 0 below
    the table; j = n - 1 above it), and 0 at the DC mode (j = n + 1).
    They depend only on the mesh and logk, so they are kept on the PM
    for the last key seen (logk's host bytes, fetched when no key is
    given)."""
    if key is None:
        key = logk.cpu().numpy().tobytes()
    hit = pm._dev_cache.get("fk_interp")
    if hit is not None and hit[0] == key:
        return hit[1], hit[2]
    n = logk.shape[0]
    kk = pm.kk()
    k = torch.sqrt(kk)
    lq = torch.log(torch.where(k > 0, k, torch.ones_like(k)))
    i = torch.clamp(torch.searchsorted(logk, lq.reshape(-1), right=True),
                    1, n - 1).reshape(lq.shape)
    dx = logk[i] - logk[i - 1]
    delta = lq - logk[i - 1]
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    t = torch.where(dx0, torch.zeros_like(dx),
                    delta / torch.where(dx0, torch.ones_like(dx), dx))
    j = i - 1
    below, above = lq < logk[0], lq > logk[-1]
    t = torch.where(below | above, torch.zeros_like(t), t)
    j = torch.where(below, torch.zeros_like(j), j)
    j = torch.where(above, torch.full_like(j, n - 1), j)
    j = torch.where(kk > 0, j, torch.full_like(j, n + 1))
    j = j.to(torch.int32).reshape(-1)
    pm._dev_cache["fk_interp"] = (key, j, t)
    return j, t


def apply_fk_interp(pm: PM, dk, logk: torch.Tensor, vals: torch.Tensor,
                    key=None):
    """Multiply by fac(|k|) = 1 + interp(log|k|; logk, vals), the
    neutrino linear-response transfer 1 + f_nu delta_nu / delta_cdm
    (lra_neutrinos, gravity.c:431-455, 494-522; transfers.py:126-141 of
    the JAX package). (logk, vals) are float32 tables on dk's device.
    Out-of-range |k| clamps to the table's edges, as jnp.interp does; the
    DC mode keeps fac = 1. The bin of each mode and its weight are cached
    on the PM while logk stays the same (the bins of measure_power), so a
    step costs two gathers from the small table and one multiply over
    the mesh; the blend rounds as jnp.interp's. key names logk (its host
    bytes, which the caller has at hand): without it logk is fetched
    from the device to name it."""
    j, t = _fk_interp_index(pm, logk, key)
    zero = vals.new_zeros(2)
    fpe = torch.cat([vals, vals[-1:], zero])
    dfe = fpe[1:] - fpe[:-1]
    f = (torch.index_select(fpe, 0, j).reshape(t.shape)
         + t * torch.index_select(dfe, 0, j).reshape(t.shape))
    return dk * (1.0 + f)


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
