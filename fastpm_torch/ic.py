"""Initial conditions: Gaussian white-noise field and its shaping
(reference: libfastpm/initialcondition.c, src/fastpm.c:prepare_deltak).

Port of fastpm_tpu/ic.py (the gadget scheme). The IC pipeline produces
the linear overdensity delta_k:

  white noise (gadget scheme, unit-variance modes)
  -> optional remove-variance ("fixed" ICs: amplitude 1, keep phase)
  -> optional set-mode overrides / inversion
  -> induce correlation: multiply by sqrt(P(k)/V)
  -> rescale by D1(a0)/D1(a_input)
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import PM
from . import native, transfers
from .cosmology import Cosmology
from .powerspectrum import FuncK

__all__ = ["gaussian_white_noise", "remove_variance", "induce_correlation",
           "rescale_linear", "linear_field"]


def gaussian_white_noise(pm: PM, seed: int) -> torch.Tensor:
    """Hermitian white noise with unit-variance modes: the N-GenIC
    quadrant-seed-table scheme (initialcondition.c:144-273), seed-stable
    across any decomposition and matching the reference's ranlxd
    sequence; filled host-side in native code, complex64 on pm.device."""
    wn = native.gadget_white_noise(pm.Nmesh, seed).astype(np.complex64)
    return torch.from_numpy(wn).to(pm.device)


def remove_variance(dk: torch.Tensor) -> torch.Tensor:
    """Fix every mode's amplitude to 1, keeping its phase ("fixed" ICs,
    initialcondition.c:66-98)."""
    mag = torch.abs(dk)
    zero = mag == 0
    one = torch.ones_like(mag)
    return dk * torch.where(zero, torch.zeros_like(mag),
                            one / torch.where(zero, one, mag))


def induce_correlation(pm: PM, dk, pk: FuncK):
    """Multiply white noise by sqrt(P(k)/V) (initialcondition.c:42-64)."""
    return transfers.apply_any(pm, dk,
                               lambda k: torch.sqrt(pk(k) / pm.Volume))


def rescale_linear(pm: PM, dk, c: Cosmology, aout: float,
                   linear_density_redshift: float = 0.0):
    """Evolve the linear field from its input redshift to aout by
    D1(aout)/D1(a_in) (src/fastpm.c:rescale_deltak)."""
    a_in = 1.0 / (linear_density_redshift + 1)
    fac = c.growth_info(aout).D1 / c.growth_info(a_in).D1
    return dk * float(np.float32(fac))


def linear_field(pm: PM, c: Cosmology, pk: FuncK, seed: int, aout: float,
                 remove_cosmic_variance: bool = False,
                 inverted: bool = False,
                 linear_density_redshift: float = 0.0):
    """The prepare_deltak pipeline (src/fastpm.c:414-591) from a random
    seed. Returns (delta_k at aout, white-noise variance)."""
    dk = gaussian_white_noise(pm, seed)
    if remove_cosmic_variance:
        dk = remove_variance(dk)
    if inverted:
        dk = -dk
    variance = pm.compute_variance(dk)
    dk = induce_correlation(pm, dk, pk)
    return rescale_linear(pm, dk, c, aout, linear_density_redshift), variance
