"""FastPM's background cosmology, growth and kick / drift factors in plain
NumPy and SciPy, written from the published equations (Feng et al. 2016,
FastPM; libfastpm/cosmology.c and factors.c for the conventions).

- E(a) = H(a)/H0 from photons, massless neutrinos, CDM, a cosmological
  constant and massive neutrinos: matter-like (sum m / 93.14 / h^2 / a^3)
  or by the Fermi-Dirac integral of each mass.
- Growth: "LCDM" is the Heath integral D1 ~ E(a) int da / (a E)^3 with
  f1 = Om(a)^(5/9), D2 = D1^2 (Om(a)/Om)^(-1/143), f2 = 2 Om(a)^(6/11);
  "ODE" integrates the first- and second-order growth equations in ln a
  from matter domination at a = 0.00625.
- FastPM's kick and drift factors make linear growth exact whatever the
  step: a drift moves by v (D1(af) - D1(ai)) / (ac^3 E(ac) D1'(ac)), a
  kick by acc * (-3/2) Om_s(ac) ac E(ac) (G(af) - G(ai)) / G'(ac) with
  G = a^3 E D1'.
"""

from __future__ import annotations

import math

import numpy as np
from scipy import integrate

__all__ = ["Cosmology"]

# FastPM's units: Mpc/h, 1e10 Msun/h, velocities in H0 units
STEF_BOLT = 2.85087e-48
RHO_CRIT = 27.7455
LIGHT = 9.715614e-15
K_BOLTZ = 8.617333262145e-5
A_ODE_START = 0.00625

# the Fermi-Dirac integrals in x = p / T_nu, on a grid dense enough that
# Simpson's rule is exact to ~1e-12 for the smooth integrands
_X = np.linspace(0.0, 60.0, 12001)


def _fermi_dirac(y: float):
    """(F, dF/dy, d2F/dy2) of F(y) = int x^2 sqrt(x^2 + y^2) / (1 + e^x)."""
    x = _X
    occ = x * x / (1.0 + np.exp(x))
    s = np.sqrt(x * x + y * y)
    f = integrate.simpson(occ * s, x=x)
    df = integrate.simpson(occ * y / s, x=x)
    d2f = integrate.simpson(occ * x * x / (s * s * s), x=x)
    return f, df, d2f


class Cosmology:
    """The background and growth of one parameter set (a dict with the
    Lua file's keys)."""

    def __init__(self, p: dict):
        self.h = float(p["h"])
        self.Om = float(p["Omega_m"])
        T = float(p.get("T_cmb", 0.0))
        n_eff = float(p.get("N_eff", 3.046))
        n_nu = float(p.get("N_nu", 0.0))
        self.m_ncdm = [float(m) for m in (p.get("m_ncdm") or [])]
        self.matterlike = bool(p.get("ncdm_matterlike", True))
        self.freestreaming = bool(p.get("ncdm_freestreaming", True))
        self.growth_mode = str(p.get("growth_mode", "ODE")).lower()
        self.Og = 4 * STEF_BOLT * T ** 4 / LIGHT ** 3 / RHO_CRIT / self.h ** 2
        gnu = ((4.0 / 11.0) ** (1.0 / 3.0) * (n_eff / n_nu) ** 0.25
               if n_nu else 0.0)
        self.Or = self.Og + 7.0 / 8.0 * (n_nu - len(self.m_ncdm)) * gnu ** 4 \
            * self.Og
        self._fd_amp = 15.0 / math.pi ** 4 * gnu ** 4 * self.Og
        self._yc = [m / (K_BOLTZ * gnu * T) for m in self.m_ncdm] if T else []
        if not self.m_ncdm:
            self.Oncdm = 0.0
        elif self.matterlike:
            self.Oncdm = sum(self.m_ncdm) / 93.14 / self.h ** 2
        else:
            self.Oncdm = self._ncdm(1.0)[0]
        self.Ocdm = self.Om - self.Oncdm
        self.OL = 1.0 - self.Om - self.Or
        self._ode = None
        self._lcdm_norm = None

    # ---- background ----

    def _ncdm(self, a):
        """(Om_ncdm E^2, its first and second a-derivatives) at a."""
        if not self.m_ncdm:
            return 0.0, 0.0, 0.0
        if self.matterlike:
            o = self.Oncdm / a ** 3
            return o, -3 * o / a, 12 * o / a ** 2
        f = df = d2f = 0.0
        for yc in self._yc:
            fi, dfi, d2fi = _fermi_dirac(yc * a)
            f += fi
            df += yc * dfi
            d2f += yc * yc * d2fi
        A = self._fd_amp
        o = A / a ** 4 * f
        do = -4 * o / a + A / a ** 4 * df
        d2o = 20 * o / a ** 2 - 8 * A / a ** 5 * df + A / a ** 4 * d2f
        return o, do, d2o

    def _esq(self, a):
        """(E^2, dE^2/da, d2E^2/da2)."""
        n, dn, d2n = self._ncdm(a)
        e = self.Or / a ** 4 + self.Ocdm / a ** 3 + self.OL + n
        de = -4 * self.Or / a ** 5 - 3 * self.Ocdm / a ** 4 + dn
        d2e = 20 * self.Or / a ** 6 + 12 * self.Ocdm / a ** 5 + d2n
        return e, de, d2e

    def E(self, a):
        return math.sqrt(self._esq(a)[0])

    def dEda(self, a):
        e, de, _ = self._esq(a)
        return 0.5 * de / math.sqrt(e)

    def d2Eda2(self, a):
        e, de, d2e = self._esq(a)
        E = math.sqrt(e)
        dE = 0.5 * de / E
        return (0.5 * d2e - dE * dE) / E

    def Omega_source(self, a):
        """The density that sources the growth and the force: CDM alone
        when the neutrinos stream freely, all matter otherwise."""
        o = self.Ocdm if (self.m_ncdm and self.freestreaming) else self.Om
        return o / a ** 3 / self._esq(a)[0]

    def _Om_a(self, a):
        return self.Om / a ** 3 / self._esq(a)[0]

    # ---- growth ----

    def _heath(self, a):
        """(a / (Om + OL a^3))^(3/2), the integrand of the LCDM growth."""
        return (a / (self.Om + self.OL * a ** 3)) ** 1.5

    def _lcdm(self, a):
        """(D1, dD1/da, d2D1/da2, f1, D2, f2) of the LCDM growth."""
        if self._lcdm_norm is None:
            i1 = integrate.quad(self._heath, 0, 1.0, epsabs=0,
                                epsrel=1e-12, limit=500)[0]
            self._lcdm_norm = self.E(1.0) * i1
        norm = self._lcdm_norm
        ia = integrate.quad(self._heath, 0, a, epsabs=0, epsrel=1e-12,
                            limit=500)[0]
        E, dE, d2E = self.E(a), self.dEda(a), self.d2Eda2(a)
        g = self._heath(a)
        dg = 1.5 * g ** (1.0 / 3.0) * (self.Om - 2 * self.OL * a ** 3) \
            / (self.Om + self.OL * a ** 3) ** 2
        d1 = E * ia / norm
        dd1 = dE * ia / norm + E * g / norm
        d2d1 = d2E * ia / norm + 2 * dE * g / norm + E * dg / norm
        om = self._Om_a(a)
        d2 = d1 * d1 * (om / self._Om_a(1.0)) ** (-1.0 / 143.0)
        return d1, dd1, d2d1, om ** (5.0 / 9.0), d2, 2 * om ** (6.0 / 11.0)

    def _solve_ode(self):
        def rhs(lna, y):
            a = math.exp(lna)
            drag = 2.0 + a * self.dEda(a) / self.E(a)
            src = 1.5 * self.Omega_source(a)
            return [y[1], -drag * y[1] + src * y[0],
                    y[3], -drag * y[3] + src * (y[2] - y[0] * y[0])]

        a0 = A_ODE_START
        y0 = [a0, a0, -3.0 / 7.0 * a0 * a0, -6.0 / 7.0 * a0 * a0]
        sol = integrate.solve_ivp(rhs, (math.log(a0), math.log(1.5)), y0,
                                  method="DOP853", rtol=1e-11, atol=1e-15,
                                  dense_output=True)
        if not sol.success:
            raise RuntimeError(sol.message)
        return sol.sol

    def _growth_ode(self, a):
        if self._ode is None:
            self._ode = self._solve_ode()
        y = self._ode(math.log(a))
        y1 = self._ode(0.0)
        d1, f1 = y[0] / y1[0], y[1] / y[0]
        d2, f2 = y[2] / y1[2], y[3] / y[2]
        dd1 = f1 * d1 / a
        dlnE = a * self.dEda(a) / self.E(a)
        d2d1 = (1.5 * self.Omega_source(a) - (3.0 + dlnE) * f1) * d1 / a ** 2
        return d1, dd1, d2d1, f1, d2, f2

    def growth(self, a):
        """(D1, dD1/da, d2D1/da2, f1, D2, f2) at a, D normalised at a = 1."""
        if self.growth_mode == "lcdm":
            return self._lcdm(a)
        return self._growth_ode(a)

    # ---- FastPM's factors ----

    def _G(self, a):
        """G = a^3 E dD1/da and its a-derivative."""
        _, dd1, d2d1, _, _, _ = self.growth(a)
        E, dE = self.E(a), self.dEda(a)
        g = a ** 3 * E * dd1
        dg = 3 * a * a * E * dd1 + a ** 3 * dE * dd1 + a ** 3 * E * d2d1
        return g, dg

    def kick(self, ai, ac, af):
        """The velocity change per unit acceleration from ai to af with
        the force taken at ac (FastPM's modified kick)."""
        return (-1.5 * self.Omega_source(ac) * ac * self.E(ac)
                * (self._G(af)[0] - self._G(ai)[0]) / self._G(ac)[1])

    def drift(self, ai, ac, af):
        """The position change per unit velocity from ai to af with the
        velocity taken at ac (FastPM's modified drift)."""
        return ((self.growth(af)[0] - self.growth(ai)[0])
                / (ac ** 3 * self.E(ac) * self.growth(ac)[1]))

    def lpt(self, a):
        """(D1, D2, D1 a^2 E f1, D2 a^2 E f2, D1 a^2 E): the 2LPT
        displacement and velocity factors at a."""
        d1, _, _, f1, d2, f2 = self.growth(a)
        ae = a * a * self.E(a)
        return d1, d2, d1 * ae * f1, d2 * ae * f2, d1 * ae
