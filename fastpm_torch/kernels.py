"""Gravity kernel zoo and softening (reference: libfastpm/gravity.c).

Port of fastpm_tpu/kernels.py. Each kernel type is a (potorder,
gradorder, difforder, deconvolveorder) tuple selecting the
finite-difference order of the inverse Laplacian, the gradient table,
and the number of extra CIC deconvolutions (gravity.c:110-171). The
default is 1_4 (lua-runtime-fastpm.lua:293).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .mesh import PM
from . import transfers

__all__ = ["kernel_orders", "apply_kernel_transfer", "apply_softening",
           "KERNELS", "SOFTENING_TYPES"]

# name -> (potorder, gradorder, difforder, deconvolveorder)
KERNELS = {
    "eastwood":  (0, 0, 1, 2),
    "naive":     (0, 0, 1, 0),
    "gadget":    (0, 1, 1, 2),
    "1_4_diff0": (0, 1, 0, 0),
    "1_4":       (0, 1, 1, 0),
    "3_4":       (1, 1, 1, 0),
    "5_4":       (2, 1, 1, 0),
    "3_2":       (1, 0, 1, 0),
}

SOFTENING_TYPES = ("none", "twothird", "gaussian", "gadget_long_range",
                   "gaussian36", "aggressive")


def kernel_orders(kernel_type: str):
    try:
        return KERNELS[kernel_type]
    except KeyError:
        raise ValueError(f"unknown kernel type {kernel_type!r}") from None


def apply_kernel_transfer(pm: PM, delta_k, kernel_type: str, field: str,
                          memb: int = 0):
    """delta_k -> k-space field for readout (gravity_apply_kernel_transfer,
    gravity.c:173-242). field in {'acc', 'potential', 'density', 'tidal'};
    memb selects the component (axis for acc, 0..5 for tidal: xx yy zz xy
    yz zx)."""
    potorder, gradorder, difforder, deconvolveorder = kernel_orders(kernel_type)
    out = delta_k
    for _ in range(deconvolveorder):
        out = transfers.apply_decic(pm, out)
    if field == "density":
        return out
    if field == "potential":
        return transfers.apply_pot(pm, out, potorder)
    if field == "acc":
        out = transfers.apply_pot(pm, out, potorder)
        return transfers.apply_grad(pm, out, memb, gradorder)
    if field == "tidal":
        pairs = [(0, 0), (1, 1), (2, 2), (0, 1), (1, 2), (2, 0)]
        d1, d2 = pairs[memb]
        out = transfers.apply_pot(pm, out, potorder)
        out = transfers.apply_grad(pm, out, d1, gradorder)
        return transfers.apply_grad(pm, out, d2, gradorder)
    raise ValueError(f"unknown gravity field {field!r}")


def apply_softening(pm: PM, delta_k, softening_type: str):
    """Optional de-aliasing / long-range softening applied to delta_k
    before the force kernels (apply_softening_transfer, gravity.c:243-270).
    'aggressive' is the lua alias of gaussian36."""
    if softening_type == "none":
        return delta_k
    if softening_type == "twothird":
        k_nq = math.pi / pm.BoxSize[0] * pm.Nmesh[0]
        return transfers.apply_lowpass(pm, delta_k, 2.0 / 3 * k_nq)
    if softening_type in ("gaussian", "gadget_long_range"):
        N = 1.0 if softening_type == "gaussian" else math.sqrt(2) * 1.25
        r0 = N * pm.BoxSize[0] / pm.Nmesh[0]
        out = delta_k
        for d in range(3):
            kern = np.exp(-0.5 * (pm.table("k", d) * r0) ** 2)
            out = out * pm.broadcast(kern, d)
        return out
    if softening_type in ("gaussian36", "aggressive"):
        k_nq = math.pi / pm.BoxSize[0] * pm.Nmesh[0]
        return transfers.apply_any(
            pm, delta_k, lambda k: torch.exp(-36 * (k / k_nq) ** 36))
    raise ValueError(f"unknown softening type {softening_type!r}")
