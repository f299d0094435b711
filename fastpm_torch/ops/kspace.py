"""The force's k-space pass: one hand-written CUDA kernel per gradient
(csrc/kspace_grad.cu), and its plain PyTorch version.

force_grad_k(pm, delta_k, d, kernel_type) is what the force hands to
the unnormalised c2r (ops/fft.py) for axis d: the potential's gradient
of the softened delta_k,

    (i g_d) * mask * (-1 / kk) * deconv * delta_k,

the chain kernels.apply_kernel_transfer(..., "acc", d), in one pass that
reads delta_k once and writes the gradient once. The kernel's norm
parameter is launched as 1.0, which is exact. The kernel type
selects the tables (kernels.KERNELS): the potential order's |k|^2
tables, the gradient order's k or k_finite table, and the CIC
deconvolution tables applied deconvolveorder times; mask zeroes the
self-conjugate modes (PM.nyquist_masks_1d). All are the PM's 1D device
tables along its k_index, so a PM whose k_index is a shard's slice
(parallel.pfft.KShard) takes the same kernel.

The kernel rounds each product in the chain's order, so on the card it
equals the plain version bit for bit. The wrapper dispatches on the
device of delta_k: a CPU tensor takes the plain version, a CUDA tensor
launches the kernel (built at first use) or raises. It counts its
kernel launches in force_grad_k.launches.
"""

from __future__ import annotations

import torch

from ..kernels import kernel_orders
from ..mesh import PM
from ..transfers import decic_table
from .cudalib import launch as _launch

__all__ = ["force_grad_k", "force_grad_k_plain"]

# the |k|^2 table of each potorder and the gradient table of each
# gradorder (transfers.apply_laplace, apply_diff)
_KK = ("kk", "kk_finite", "kk_finite2")
_GRAD = ("k", "k_finite")


def _nyquist_table(pm: PM, d: int) -> torch.Tensor:
    """The bool 1D Nyquist mask along d on the PM's device, shaped for
    broadcasting over k-space."""
    def make():
        shape = [1, 1, 1]
        shape[d] = -1
        return torch.as_tensor(pm.nyquist_masks_1d[d].reshape(shape),
                               device=pm.device)
    return pm._const(("nyquist_1d", d), make)


def _tables(pm: PM, d: int, kernel_type: str):
    """(kk tables, gradient table along d, Nyquist masks, deconvolveorder,
    deconvolution tables or None): the kernel's inputs."""
    potorder, gradorder, _, deconv = kernel_orders(kernel_type)
    if d not in (0, 1, 2):
        raise ValueError(f"gradient axis must be 0, 1 or 2, got {d!r}")
    kk = [pm.broadcast_table(_KK[potorder], e) for e in range(3)]
    nyq = [_nyquist_table(pm, e) for e in range(3)]
    dc = [decic_table(pm, e) for e in range(3)] if deconv else None
    return kk, pm.broadcast_table(_GRAD[gradorder], d), nyq, deconv, dc


def _memory_positions(t: torch.Tensor):
    """Where each axis of a dense 3D tensor lies in memory: 0 for the
    outermost (the largest stride), 2 for the innermost (stride 1).
    Raises for a tensor with gaps or overlaps, which the kernel's walk
    over memory cannot take."""
    order = sorted(range(3), key=lambda e: (-t.stride(e), e))
    step = 1
    for e in reversed(order):
        if t.shape[e] != 1 and t.stride(e) != step:
            raise ValueError(f"force_grad_k: delta_k of strides "
                             f"{t.stride()} is not dense")
        step *= t.shape[e]
    pos = [0, 0, 0]
    for rank, e in enumerate(order):
        pos[e] = rank
    return pos


def force_grad_k_plain(pm: PM, delta_k: torch.Tensor, d: int,
                       kernel_type: str) -> torch.Tensor:
    """Plain force_grad_k: the kernel's arithmetic from the same tables,
    one full-size step at a time (a new tensor; delta_k is kept)."""
    kk, grad, nyq, deconv, dc = _tables(pm, d, kernel_type)
    out = delta_k
    for _ in range(deconv):
        for f in dc:
            out = out * f
    k2 = (kk[0] + kk[1]) + kk[2]
    nz = k2 != 0
    inv = torch.where(nz, 1.0 / torch.where(nz, k2, 1.0), 0.0)
    out = (out * inv).neg_()
    out.mul_(torch.complex(torch.zeros_like(grad), grad))
    return out.mul_((~(nyq[0] & nyq[1] & nyq[2])).to(pm.dtype))


def force_grad_k(pm: PM, delta_k: torch.Tensor, d: int,
                 kernel_type: str) -> torch.Tensor:
    """The gradient along d of the potential of delta_k (a (pm.kshape)
    complex64 tensor in any dense memory order, kept), for the
    unnormalised c2r: one kernel launch on CUDA, the plain version on
    the CPU."""
    if delta_k.device.type == "cpu":
        return force_grad_k_plain(pm, delta_k, d, kernel_type)
    if (delta_k.dtype != torch.complex64
            or tuple(delta_k.shape) != tuple(pm.kshape)):
        raise ValueError(f"delta_k must be a {tuple(pm.kshape)} complex64 "
                         f"tensor, got {tuple(delta_k.shape)} "
                         f"{delta_k.dtype}")
    pos = _memory_positions(delta_k)
    kk, grad, nyq, deconv, dc = _tables(pm, d, kernel_type)
    # delta_k's strides (the kernel walks any dense memory order)
    out = torch.empty_like(delta_k)
    _launch("fastpm_kspace_grad", delta_k.data_ptr(), out.data_ptr(),
            *pm.kshape, *pos, *(t.data_ptr() for t in kk), grad.data_ptr(),
            d, *(t.data_ptr() for t in nyq), deconv,
            *((t.data_ptr() for t in dc) if dc else (None,) * 3), 1.0,
            device=delta_k.device)
    force_grad_k.launches += 1
    return out


force_grad_k.launches = 0
