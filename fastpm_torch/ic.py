"""Initial conditions: Gaussian white-noise field and its shaping
(reference: libfastpm/initialcondition.c, src/fastpm.c:prepare_deltak).

Port of fastpm_tpu/ic.py. The IC pipeline produces the linear
overdensity delta_k:

  white noise (gadget, fast or slow scheme, unit-variance modes)
  -> optional remove-variance ("fixed" ICs: amplitude 1, keep phase)
  -> optional set-mode overrides / inversion
  -> induce correlation: multiply by sqrt(P(k)/V)
  -> rescale by D1(a0)/D1(a_input)
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .mesh import PM
from . import native, transfers
from .cosmology import Cosmology
from .powerspectrum import FuncK

__all__ = ["gaussian_white_noise", "remove_variance", "induce_correlation",
           "rescale_linear", "linear_field"]


def gaussian_white_noise(pm: PM, seed: int,
                         scheme: str = "gadget") -> torch.Tensor:
    """Hermitian white noise with unit-variance modes, complex64 on
    pm.device.

    - "gadget": the N-GenIC quadrant-seed-table scheme
      (initialcondition.c:144-273), seed-stable across any decomposition
      and matching the reference's ranlxd sequence; filled host-side in
      native code.
    - "fast": real white noise of one rank, r2c
      (initialcondition.c:275-310).
    - "slow": one global ranlxd stream over every cell, r2c
      (pmic_fill_gaussian_slow, initialcondition.c:312-352).
    The real fields of fast and slow are drawn on the host in float64
    as the JAX package's; the r2c runs on pm.device."""
    if scheme == "gadget":
        wn = native.gadget_white_noise(pm.Nmesh, seed).astype(np.complex64)
        return torch.from_numpy(wn).to(pm.device)
    if scheme == "fast":
        # one device is the reference's rank 0, whose seed jump is a
        # no-op (initialcondition.c:283-289)
        vals = native.ranlxd_uniform(seed, int(pm.Norm))
        # pairs of (phase, ampl) -> two gaussians per pair
        phase = vals[0::2] * 2 * math.pi
        ampl = vals[1::2]
        ampl = np.where(ampl == 0.0, 1.0, ampl)
        ampl = np.sqrt(-2 * np.log(ampl)) * math.sqrt(pm.Norm)
        g = np.empty(int(pm.Norm), dtype=np.float32)
        g[0::2] = (ampl * np.sin(phase)).astype(np.float32)
        g[1::2] = (ampl * np.cos(phase)).astype(np.float32)
    elif scheme == "slow":
        # per cell one (phase, ampl) draw, keeping ampl * sin(phase)
        vals = native.ranlxd_uniform(seed, 2 * int(pm.Norm))
        phase = vals[0::2] * 2 * math.pi
        ampl = vals[1::2]
        # the reference redraws on an exact 0.0 (probability ~N*2^-52);
        # a redraw would shift the stream, so it is fatal here
        if (ampl == 0.0).any():
            raise RuntimeError("ranlxd produced an exact 0.0; the "
                               "reference's redraw loop is not emulated")
        g = (np.sqrt(-2 * np.log(ampl)) * math.sqrt(pm.Norm)
             * np.sin(phase)).astype(np.float32)
    else:
        raise ValueError(f"unknown white noise scheme {scheme!r}")
    return pm.r2c(torch.from_numpy(g.reshape(pm.rshape)).to(pm.device))


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
