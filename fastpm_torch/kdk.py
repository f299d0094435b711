"""Kick/drift factors for the FastPM/PM/COLA/ZA/2LPT time integrators.

Host-side float64 math mirroring the reference libfastpm/factors.c. Each
factor object precomputes a 32-sample lookup table over [ai, af] so that
interpolation events (snapshots, lightcones) can evaluate partial kicks and
drifts at any intermediate scale factor (factors.c:276-302, 346-371).

The FASTPM force mode uses the growth-boosted factors that force linear
growth to follow D1(a) exactly regardless of step size (factors.c:292-299,
357-361); PM/COLA use the standard da/(a^3 E), da/(a^2 E) integrals
(factors.c:394-506).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
from scipy import integrate as _sint

from .cosmology import Cosmology

__all__ = ["KickFactor", "DriftFactor", "FORCE_MODES"]

NSAMPLES = 32

FORCE_MODE_FASTPM = "fastpm"
FORCE_MODE_PM = "pm"
FORCE_MODE_COLA = "cola"
FORCE_MODE_ZA = "za"
FORCE_MODE_2LPT = "2lpt"
FORCE_MODES = (FORCE_MODE_FASTPM, FORCE_MODE_PM, FORCE_MODE_COLA,
               FORCE_MODE_ZA, FORCE_MODE_2LPT)


def _G_p(c: Cosmology, a: float) -> float:
    return c.growth_info(a).D1


def _g_p(c: Cosmology, a: float) -> float:
    return c.dD1da(a)


def _G_f(c: Cosmology, a: float) -> float:
    return a ** 3 * c.E(a) * _g_p(c, a)


def _g_f(c: Cosmology, a: float) -> float:
    E = c.E(a)
    dEda = c.dEda(a)
    dDda = _g_p(c, a)
    d2Dda2 = c.d2D1da2(a)
    return (3 * a * a * E * dDda
            + a ** 3 * dEda * dDda
            + a ** 3 * E * d2Dda2)


def _integrate(f, ai, af):
    if ai == af:
        return 0.0
    val, _ = _sint.quad(f, ai, af, epsabs=0, epsrel=1e-8, limit=1000)
    return val


def _gpQ(a, nLPT):
    return a ** nLPT


def _Sq(ai, af, aref, nLPT, c: Cosmology, use_nonstdda: bool) -> float:
    """Drift integral (factors.c:453-474)."""
    if use_nonstdda:
        val = _integrate(lambda a: _gpQ(a, nLPT) / (a ** 3 * c.E(a)), ai, af)
        return val / _gpQ(aref, nLPT)
    return _integrate(lambda a: 1.0 / (a ** 3 * c.E(a)), ai, af)


def _Sphi(ai, af, aref, nLPT, c: Cosmology, use_nonstdda: bool) -> float:
    """Kick integral (factors.c:482-506)."""
    if use_nonstdda:
        dgpQ = nLPT * aref ** (nLPT - 1)
        return ((_gpQ(af, nLPT) - _gpQ(ai, nLPT)) * aref
                / (aref ** 3 * c.E(aref) * dgpQ))
    return _integrate(lambda a: 1.0 / (a ** 2 * c.E(a)), ai, af)


def _samples(ai, af):
    i = np.arange(NSAMPLES)
    return (ai * (NSAMPLES - 1.0 - i) + af * i) / (NSAMPLES - 1.0)


def _lookup(table_a, ai, af, values, a):
    """Linear interpolation in the 32-sample table (factors.c:41-70)."""
    if a == af:
        return tuple(v[-1] for v in values)
    if a == ai:
        return tuple(v[0] for v in values)
    ind = (a - ai) / (af - ai) * (NSAMPLES - 1)
    l = int(np.floor(ind))
    if l + 1 >= NSAMPLES:
        raise ValueError("lookup beyond factor's available range")
    u = l + 1 - ind
    v = ind - l
    return tuple(val[l] * u + val[l + 1] * v for val in values)


@dataclass
class KickFactor:
    """Kick factor table over [ai, af] with reference time ac
    (factors.c:233-320). v(af) = v(ai) + acc * dda(ai->af)."""

    cosmology: Cosmology
    force_mode: str
    ai: float
    ac: float
    af: float
    nLPT: float = -2.5
    q1: float = field(init=False)
    q2: float = field(init=False)
    dda: np.ndarray = field(init=False)
    Dv1: np.ndarray = field(init=False)
    Dv2: np.ndarray = field(init=False)

    def __post_init__(self):
        c = self.cosmology
        ai, ac, af = self.ai, self.ac, self.af
        gi_i = c.growth_info(ai)
        gi_c = c.growth_info(ac)
        E_i = c.E(ai)
        E_c = c.E(ac)

        Omega_m0 = c.Omega_source(1.0)
        Omega_mc = c.Omega_source(ac)

        # COLA force prefactors (factors.c:264-274)
        self.q1 = gi_c.D1
        if c.growth_mode == "lcdm":
            self.q2 = gi_c.D1 ** 2 * (1.0 + 7.0 / 3.0 * Omega_mc ** (1.0 / 143.0))
        else:
            self.q2 = gi_c.D1 ** 2 * (1 - gi_c.D1 ** 2 / gi_c.D2)

        Dv1i = gi_i.D1 * ai * ai * E_i * gi_i.f1
        Dv2i = gi_i.D2 * ai * ai * E_i * gi_i.f2

        dda = np.empty(NSAMPLES)
        Dv1 = np.empty(NSAMPLES)
        Dv2 = np.empty(NSAMPLES)
        for i, ae in enumerate(_samples(ai, af)):
            gi_e = c.growth_info(ae)
            E_e = c.E(ae)
            if self.force_mode == FORCE_MODE_FASTPM:
                dda[i] = (-1.5 * Omega_mc * ac * E_c
                          * (_G_f(c, ae) - _G_f(c, ai)) / _g_f(c, ac))
            else:
                dda[i] = -1.5 * Omega_m0 * _Sphi(
                    ai, ae, ac, self.nLPT, c,
                    self.force_mode == FORCE_MODE_COLA)
            Dv1[i] = gi_e.D1 * ae * ae * E_e * gi_e.f1 - Dv1i
            Dv2[i] = gi_e.D2 * ae * ae * E_e * gi_e.f2 - Dv2i
        self.dda, self.Dv1, self.Dv2 = dda, Dv1, Dv2

    def lookup(self, a: float):
        """(dda, Dv1, Dv2) at scale factor a in [ai, af]."""
        return _lookup(None, self.ai, self.af, (self.dda, self.Dv1, self.Dv2), a)

    def coefficients(self, a_from: float, a_to: float):
        """Net (dda, Dv1, Dv2) for a kick from velocity-time a_from to a_to."""
        f = self.lookup(a_to)
        i = self.lookup(a_from)
        return tuple(x - y for x, y in zip(f, i))


@dataclass
class DriftFactor:
    """Drift factor table over [ai, af] with reference time ac
    (factors.c:322-371). x(af) = x(ai) + v * dyyy(ai->af)."""

    cosmology: Cosmology
    force_mode: str
    ai: float
    ac: float
    af: float
    nLPT: float = -2.5
    dyyy: np.ndarray = field(init=False)
    da1: np.ndarray = field(init=False)
    da2: np.ndarray = field(init=False)
    Dv1: float = field(init=False)
    Dv2: float = field(init=False)

    def __post_init__(self):
        c = self.cosmology
        ai, ac, af = self.ai, self.ac, self.af
        gi_i = c.growth_info(ai)
        gi_c = c.growth_info(ac)
        E_c = c.E(ac)

        dyyy = np.empty(NSAMPLES)
        da1 = np.empty(NSAMPLES)
        da2 = np.empty(NSAMPLES)
        for i, ae in enumerate(_samples(ai, af)):
            gi_e = c.growth_info(ae)
            if self.force_mode == FORCE_MODE_FASTPM:
                dyyy[i] = (1 / (ac ** 3 * E_c)
                           * (_G_p(c, ae) - _G_p(c, ai)) / _g_p(c, ac))
            else:
                dyyy[i] = _Sq(ai, ae, ac, self.nLPT, c,
                              self.force_mode == FORCE_MODE_COLA)
            da1[i] = gi_e.D1 - gi_i.D1
            da2[i] = gi_e.D2 - gi_i.D2
        self.dyyy, self.da1, self.da2 = dyyy, da1, da2
        self.Dv1 = gi_c.D1 * ac * ac * E_c * gi_c.f1
        self.Dv2 = gi_c.D2 * ac * ac * E_c * gi_c.f2

    def lookup(self, a: float):
        """(dyyy, da1, da2) at scale factor a in [ai, af]."""
        return _lookup(None, self.ai, self.af, (self.dyyy, self.da1, self.da2), a)

    def coefficients(self, a_from: float, a_to: float):
        """Net (dyyy, da1, da2) for a drift from position-time a_from to a_to."""
        f = self.lookup(a_to)
        i = self.lookup(a_from)
        return tuple(x - y for x, y in zip(f, i))
