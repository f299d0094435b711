"""Background cosmology and growth factors.

Host-side float64 math (numpy/scipy); none of this runs on TPU. The formulas
mirror the reference FastPM implementation (libfastpm/cosmology.c) so that the
growth factors, Hubble function, and kick/drift integrals reproduce the
reference's deterministic regression values:

- E(a) with radiation (photons + massless nu), curvature, CLP dark energy
  w(a) = w0 + (1-a) wa, and massive neutrinos (matter-like approximation or
  exact Fermi-Dirac integrals)  [cosmology.c:185-201]
- growth via either the LCDM closed-form integral with fitting formulas for
  f1/D2/f2 [cosmology.c:374-388] or the coupled D1/D2 ODE integrated from
  matter domination at a=0.00625 [cosmology.c:300-372, 389-397]
- dD/da and d2D/da2 for both modes [cosmology.c:403-462]
- comoving distance [cosmology.c:464-492]
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import lru_cache, cached_property
import math

import numpy as np
from scipy import integrate as _sint
from scipy.interpolate import CubicSpline

from .units import STEF_BOLT, RHO_CRIT, LIGHT, K_BOLTZ, HUBBLE_DISTANCE

__all__ = ["Cosmology", "GrowthInfo", "FIDUCIAL"]


GROWTH_MODE_LCDM = "lcdm"
GROWTH_MODE_ODE = "ode"

# The ODE growth mode assumes matter domination at this scale factor
# (z = 159; cosmology.c:340).
_A_INI_ODE = 0.00625


@lru_cache(maxsize=8)
def _fd_table():
    """Fermi-Dirac integral table, reproducing the reference's generated
    Ftable (libfastpm/Ftable.py): F(y), F'(y), F''(y) on a 10000-point
    log-spaced y grid, interpolated with natural cubic splines (the GSL
    cspline used in FDinterp.c:15-23).
    """
    # Constants fixed by the table generator (Ftable.py), NOT the cosmology.
    k = 8.617330350e-5
    T_g = 2.73
    gamma_nu = 0.71649
    T_nu = gamma_nu * T_g
    m_nu = 0.02
    log_y_min = np.log10(m_nu / (k * T_nu) * 1e-6)
    log_y_max = np.log10(m_nu / (k * T_nu) * 1e2)
    y = np.logspace(log_y_min, log_y_max, 10000)

    def F(x, yy):
        return x * x * np.sqrt(x * x + yy * yy) / (1.0 + np.exp(x))

    def dF(x, yy):
        return x * x * yy / np.sqrt(x * x + yy * yy) / (1.0 + np.exp(x))

    def d2F(x, yy):
        return x * x / yy / (x * x + yy * yy) * dF(x, yy)

    tabs = []
    for fn in (F, dF, d2F):
        vals = np.array([_sint.quad(fn, 0, np.inf, args=(yy,))[0] for yy in y])
        tabs.append(CubicSpline(y, vals, bc_type="natural"))
    return tabs


@dataclass(frozen=True)
class Cosmology:
    """Immutable cosmology parameters (reference: api/fastpm/cosmology.h).

    Omega_m is the total matter density (cdm + baryon + ncdm) at z=0;
    Omega_cdm and Omega_Lambda are derived in __post_init__ by closing the
    Friedmann equation exactly as cosmology.c:22-50 does.
    """

    h: float = 0.6774
    Omega_m: float = 0.307494
    Omega_k: float = 0.0
    T_cmb: float = 0.0
    w0: float = -1.0
    wa: float = 0.0
    N_eff: float = 3.046
    N_nu: float = 0.0
    m_ncdm: tuple = ()
    ncdm_matterlike: bool = True
    ncdm_freestreaming: bool = True
    ncdm_linearresponse: bool = False
    growth_mode: str = GROWTH_MODE_ODE

    @property
    def N_ncdm(self) -> int:
        return len(self.m_ncdm)

    # ---- derived z=0 densities (cosmology.c:22-50) ----

    @cached_property
    def Omega_g(self) -> float:
        return (4 * STEF_BOLT * self.T_cmb ** 4
                / LIGHT ** 3 / RHO_CRIT / self.h ** 2)

    @cached_property
    def Gamma_nu(self) -> float:
        if self.N_nu == 0:
            return 0.0
        return (4.0 / 11.0) ** (1.0 / 3.0) * (self.N_eff / self.N_nu) ** 0.25

    @cached_property
    def Omega_ur(self) -> float:
        N_ur = self.N_nu - self.N_ncdm
        return 7.0 / 8.0 * N_ur * self.Gamma_nu ** 4 * self.Omega_g

    @cached_property
    def Omega_r(self) -> float:
        return self.Omega_g + self.Omega_ur

    @cached_property
    def Omega_ncdm(self) -> float:
        if self.N_ncdm == 0:
            return 0.0
        if self.ncdm_matterlike:
            return sum(self.m_ncdm) / 93.14 / self.h / self.h
        return self.Omega_ncdm_ESq(1.0)

    @cached_property
    def Omega_cdm(self) -> float:
        return self.Omega_m - self.Omega_ncdm

    @cached_property
    def Omega_Lambda(self) -> float:
        return 1 - self.Omega_m - self.Omega_r - self.Omega_k

    # ---- ncdm exact energy density (cosmology.c:101-161) ----

    def _Fconst(self, i: int) -> float:
        T_nu = self.Gamma_nu * self.T_cmb
        return self.m_ncdm[i] / (K_BOLTZ * T_nu)

    def Omega_ncdm_ESq(self, a: float) -> float:
        """Omega_ncdm(a) * E(a)^2 via the Fermi-Dirac integral."""
        F, _, _ = _fd_table()
        A = 15.0 / math.pi ** 4 * self.Gamma_nu ** 4 * self.Omega_g
        res = 0.0
        for i in range(self.N_ncdm):
            res += A / a ** 4 * float(F(self._Fconst(i) * a))
        return res

    def DOmega_ncdm_ESqDa(self, a: float) -> float:
        _, DF, _ = _fd_table()
        A = 15.0 / math.pi ** 4 * self.Gamma_nu ** 4 * self.Omega_g
        On = self.Omega_ncdm_ESq(a)
        FcDF = 0.0
        for i in range(self.N_ncdm):
            Fc = self._Fconst(i)
            FcDF += Fc * float(DF(Fc * a))
        return -4.0 / a * On + A / a ** 4 * FcDF

    def D2Omega_ncdm_ESqDa2(self, a: float) -> float:
        _, _, DDF = _fd_table()
        A = 15.0 / math.pi ** 4 * self.Gamma_nu ** 4 * self.Omega_g
        On = self.Omega_ncdm_ESq(a)
        DOn = self.DOmega_ncdm_ESqDa(a)
        FcFcDDF = 0.0
        for i in range(self.N_ncdm):
            Fc = self._Fconst(i)
            FcFcDDF += Fc * Fc * float(DDF(Fc * a))
        return -12.0 / a ** 2 * On - 8.0 / a * DOn + A / a ** 4 * FcFcDDF

    # ---- dark energy (cosmology.c:163-183) ----

    def Omega_DE_ESq(self, a: float) -> float:
        exponent = (a - 1) * self.wa - (1 + self.w0 + self.wa) * math.log(a)
        return self.Omega_Lambda * math.exp(3 * exponent)

    def DOmega_DE_ESqDa(self, a: float) -> float:
        return 3 * (self.wa - (1 + self.w0 + self.wa) / a) * self.Omega_DE_ESq(a)

    def D2Omega_DE_ESqDa2(self, a: float) -> float:
        O = self.Omega_DE_ESq(a)
        DO = self.DOmega_DE_ESqDa(a)
        return DO * DO / self.Omega_Lambda + 3 * (1 + self.w0 + self.wa) / a ** 2 * O

    # ---- Hubble (cosmology.c:185-265) ----

    def E(self, a: float) -> float:
        """H(a)/H0."""
        if self.N_ncdm and not self.ncdm_matterlike:
            On = self.Omega_ncdm_ESq(a)
        else:
            On = self.Omega_ncdm / a ** 3
        return math.sqrt(self.Omega_r / a ** 4
                         + self.Omega_cdm / a ** 3
                         + self.Omega_k / a ** 2
                         + self.Omega_DE_ESq(a)
                         + On)

    def dEda(self, a: float) -> float:
        E = self.E(a)
        if self.N_ncdm and not self.ncdm_matterlike:
            DOn = self.DOmega_ncdm_ESqDa(a)
        else:
            DOn = -3 * self.Omega_ncdm / a ** 4
        return 0.5 / E * (-4 * self.Omega_r / a ** 5
                          - 3 * self.Omega_cdm / a ** 4
                          - 2 * self.Omega_k / a ** 3
                          + self.DOmega_DE_ESqDa(a)
                          + DOn)

    def d2Eda2(self, a: float) -> float:
        E = self.E(a)
        dEda = self.dEda(a)
        if self.N_ncdm and not self.ncdm_matterlike:
            D2On = self.D2Omega_ncdm_ESqDa2(a)
        else:
            D2On = 12 * self.Omega_ncdm / a ** 5
        return 0.5 / E * (20 * self.Omega_r / a ** 6
                          + 12 * self.Omega_cdm / a ** 5
                          + 6 * self.Omega_k / a ** 4
                          + self.D2Omega_DE_ESqDa2(a)
                          + D2On
                          - 2 * dEda ** 2)

    def Omega_cdm_a(self, a: float) -> float:
        E = self.E(a)
        return self.Omega_cdm / a ** 3 / (E * E)

    def Omega_m_a(self, a: float) -> float:
        E = self.E(a)
        return self.Omega_m / a ** 3 / (E * E)

    def Omega_source(self, a: float) -> float:
        """The Poisson-equation / growth-ODE source (cosmology.c:217-224)."""
        if self.ncdm_freestreaming:
            return self.Omega_cdm_a(a)
        return self.Omega_m_a(a)

    # ---- growth: LCDM closed form (cosmology.c:267-298) ----

    def _growth_int(self, a: float) -> float:
        """E(a) * int_0^a da' (a' / (Om + (1-Om-OL) a' + OL a'^3))^1.5.

        Cached per (cosmology, a): factor-table construction (kdk.py)
        evaluates this at the same 32 interval samples for the kick and
        the drift, and dD1da/d2D1da2 re-request a=1 constantly."""
        return _growth_int_cached(self, float(a))

    # ---- growth: ODE mode (cosmology.c:300-372) ----

    @cached_property
    def _growth_ode_solution(self):
        """Dense solution of the coupled D1/D2 system from a=0.00625.

        State y = (d1, dd1/dlna, d2, dd2/dlna), matter-domination initial
        conditions (cosmology.c:340-345).
        """

        def rhs(a, y):
            E = self.E(a)
            dEda = self.dEda(a)
            drag = 2.0 + a / E * dEda
            src = 1.5 * self.Omega_source(a)
            dydlna = np.array([
                y[1],
                -drag * y[1] + src * y[0],
                y[3],
                -drag * y[3] + src * (y[2] - y[0] * y[0]),
            ])
            return dydlna / a

        aini = _A_INI_ODE
        yini = [aini, aini, -3.0 / 7.0 * aini * aini, -6.0 / 7.0 * aini * aini]
        sol = _sint.solve_ivp(rhs, (aini, 1.5), yini, method="RK45",
                              rtol=1e-10, atol=1e-12, dense_output=True)
        if not sol.success:
            raise RuntimeError("growth ODE integration failed: " + sol.message)
        return sol.sol

    def _growth_ode_solve(self, a: float):
        if a < _A_INI_ODE:
            return np.zeros(4)
        if a > 1.5:
            raise ValueError(f"growth ODE evaluated beyond a=1.5: {a}")
        return self._growth_ode_solution(a)

    # ---- public growth interface ----

    def growth_info(self, a: float) -> "GrowthInfo":
        return _growth_info_cached(self, float(a))

    def D1(self, a: float) -> float:
        return self.growth_info(a).D1

    def dD1da(self, a: float) -> float:
        """dD1/da (cosmology.c:403-427). Cached per (cosmology, a)."""
        return _dD1da_cached(self, float(a))

    def _dD1da(self, a: float) -> float:
        gi = self.growth_info(a)
        if self.growth_mode == GROWTH_MODE_LCDM:
            E = self.E(a)
            EI = self._growth_int(1.0)
            return self.dEda(a) * gi.D1 / E + E * (a * E) ** -3 / EI
        elif self.growth_mode == GROWTH_MODE_ODE:
            return gi.f1 * gi.D1 / a
        raise ValueError(f"unknown growth mode {self.growth_mode!r}")

    def d2D1da2(self, a: float) -> float:
        """d2D1/da2 (cosmology.c:429-462). Cached per (cosmology, a)."""
        return _d2D1da2_cached(self, float(a))

    def _d2D1da2(self, a: float) -> float:
        gi = self.growth_info(a)
        if self.growth_mode == GROWTH_MODE_LCDM:
            E = self.E(a)
            dEda = self.dEda(a)
            EI = self._growth_int(1.0)
            t1 = self.d2Eda2(a) * gi.D1 / E
            t2 = (dEda + 3 / a * E) * (a * E) ** -3 / EI
            return t1 - t2
        elif self.growth_mode == GROWTH_MODE_ODE:
            E = self.E(a)
            dEda = self.dEda(a)
            ans = -(3.0 + a / E * dEda) * gi.f1
            ans += 1.5 * self.Omega_source(a)
            return ans * gi.D1 / (a * a)
        raise ValueError(f"unknown growth mode {self.growth_mode!r}")

    # ---- distances (cosmology.c:464-492) ----

    def comoving_distance(self, a: float) -> float:
        """Comoving distance from a to 1, in units of the Hubble distance
        (multiply by HUBBLE_DISTANCE for Mpc/h)."""
        val, _ = _sint.quad(lambda x: 1.0 / (x * x * self.E(x)), a, 1.0,
                            epsabs=0, epsrel=1e-8, limit=1000)
        return val

    def RSD_factor(self, a: float) -> float:
        """1 / (H0 a E(a)) with H0=100: converts peculiar velocity in km/s
        to comoving RSD displacement in Mpc/h (io.c:250-254)."""
        return 1.0 / (100.0 * a * self.E(a))

    def replace(self, **kwargs) -> "Cosmology":
        return dataclasses.replace(self, **kwargs)


@dataclass(frozen=True)
class GrowthInfo:
    """Growth factors at one scale factor (api/fastpm/cosmology.h)."""
    a: float
    D1: float
    f1: float
    D2: float
    f2: float


@lru_cache(maxsize=65536)
def _growth_int_cached(c: Cosmology, a: float) -> float:
    Om, OL = c.Omega_m, c.Omega_Lambda

    def f(x):
        return (x / (Om + (1 - Om - OL) * x + OL * x ** 3)) ** 1.5

    val, _ = _sint.quad(f, 0, a, epsabs=0, epsrel=1e-9, limit=1000)
    return c.E(a) * val


@lru_cache(maxsize=65536)
def _dD1da_cached(c: Cosmology, a: float) -> float:
    return c._dD1da(a)


@lru_cache(maxsize=65536)
def _d2D1da2_cached(c: Cosmology, a: float) -> float:
    return c._d2D1da2(a)


@lru_cache(maxsize=65536)
def _growth_info_cached(c: Cosmology, a: float) -> GrowthInfo:
    if c.growth_mode == GROWTH_MODE_LCDM:
        d1 = c._growth_int(a)
        d1_a1 = c._growth_int(1.0)
        Om = c.Omega_m_a(a)
        D1 = d1 / d1_a1
        f1 = Om ** (5.0 / 9.0)
        D2 = D1 * D1 * (Om / c.Omega_m_a(1.0)) ** (-1.0 / 143.0)
        f2 = 2 * Om ** (6.0 / 11.0)
        return GrowthInfo(a=a, D1=D1, f1=f1, D2=D2, f2=f2)
    elif c.growth_mode == GROWTH_MODE_ODE:
        y = c._growth_ode_solve(a)
        y1 = c._growth_ode_solve(1.0)
        return GrowthInfo(a=a, D1=y[0] / y1[0], f1=y[1] / y[0],
                          D2=y[2] / y1[2], f2=y[3] / y[2])
    raise ValueError(f"unknown growth mode {c.growth_mode!r}")


# The reference's default fiducial cosmology (solver.c:30-47) is odd (it sets
# Omega_cdm inconsistently); we use the tests/standard.lua cosmology as our
# fiducial instead.
FIDUCIAL = Cosmology()
