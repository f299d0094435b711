"""Grid-based massive neutrinos via Fourier-space linear response
(reference: libfastpm/neutrinos_lra.c, from MP-Gadget; the method of
Ali-Haimoud & Bird 2012, arXiv:1209.0461, and Bird et al 2018,
arXiv:1803.09854).

delta_nu(k, a) is evolved from the history of the total-matter delta(k)
through the free-streaming kernel J(x):

  delta_nu(k,a) = J(k fs(a_T,a)/(m/kT)) delta_nu_init(k) (1 + ad Hd fs)
    + (3/2 Om H^2/c) int dln a' fs(a',a)/(a' E) J(k fs/(m/kT))
      delta_tot(k, a')

and applied inside the force step as the multiplicative transfer
1 + f_nu delta_nu/delta_cdm on delta_k (gravity.c:431-455, 494-522).

Everything here is host-side float64 on the binned spectrum; it runs
once per force step and costs microseconds compared to the PM step.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
from scipy.interpolate import CubicSpline, interp1d

from .cosmology import Cosmology, _fd_table
from .powerspectrum import FuncK

__all__ = ["DeltaTotTable", "special_J", "fslength"]

BOLEVK = 8.617333262145e-5

# NOTE on units: the reference port (neutrinos_lra.c:563-578) computes
# fslength = c * int dln a / (a^2 E) with c in Mpc/s but E dimensionless,
# dropping a 1/H0 -- which makes the J suppression argument and the
# history integral numerically vanish (~1e-13). The dimensionally
# consistent combination uses the Hubble distance c/H0 = 2997.925 Mpc/h
# throughout: fsl = D_H int dln a/(a^2 E) [Mpc/h],
# prefac = 1.5 Omega_m / D_H [h/Mpc], deriv = a_T^2 E(a_T) / D_H.
# The derivative piece agrees with the reference exactly (its c cancels);
# the J argument and integral here carry real free-streaming physics.
from .units import HUBBLE_DISTANCE


def special_J(x):
    """Fit to J(x) = int dq sinc(qx) q^2/(e^q+1), J(0)=1
    (neutrinos_lra.c:583-600; good to 3% rel / 0.07% abs)."""
    x = np.asarray(x, dtype=np.float64)
    x2 = x * x
    x4 = x2 * x2
    x8 = x4 * x4
    with np.errstate(divide="ignore", invalid="ignore"):
        val = ((1. + 0.0168 * x2 + 0.0407 * x4)
               / (1. + 2.1734 * x2 + 1.6787 * np.exp(4.1811 * np.log(
                   np.where(x > 0, x, 1.0))) + 0.1467 * x8))
    return np.where(x <= 0, 1.0, val)


_GL_X, _GL_W = np.polynomial.legendre.leggauss(24)


def _quad_loga(f, la1, la2):
    """Fixed 24-node Gauss-Legendre over log a (smooth integrands)."""
    if la2 <= la1:
        return 0.0
    mid = 0.5 * (la1 + la2)
    half = 0.5 * (la2 - la1)
    x = mid + half * _GL_X
    return float(np.sum(f(x) * _GL_W) * half)


def fslength(c: Cosmology, logai: float, logaf: float) -> float:
    """Free-streaming length times M_nu/(k_B T_nu), in Mpc/h
    (neutrinos_lra.c:547-578; see the units note above)."""
    if logai >= logaf:
        return 0.0

    def integrand(loga):
        a = np.exp(loga)
        E = np.array([c.E(float(v)) for v in np.atleast_1d(a)])
        return 1.0 / (a * a * E)

    return HUBBLE_DISTANCE * _quad_loga(integrand, logai, logaf)


@dataclass
class DeltaTotTable:
    """History of delta_tot(k, a) + the neutrino response state
    (struct _delta_tot_table)."""

    cosmology: Cosmology
    time_transfer: float                 # a at which transfer ICs are given
    t_init: Optional[FuncK] = None       # T_nu/T_cdm vs log10(k)
    wavenum: np.ndarray = None
    delta_tot: list = field(default_factory=list)    # per time: (nk,)
    scalefact: list = field(default_factory=list)    # log a
    delta_nu_init: np.ndarray = None
    delta_nu_last: np.ndarray = None
    init_done: bool = False

    # ---- pieces ----

    def _omega_nu(self, a: float) -> float:
        """rho_nu(a)/rho_crit0 (exact FD)."""
        return self.cosmology.Omega_ncdm_ESq(a)

    def _omega_nu_single(self, a: float, i: int) -> float:
        c = self.cosmology
        F, _, _ = _fd_table()
        A = 15.0 / math.pi ** 4 * c.Gamma_nu ** 4 * c.Omega_g
        return A / a ** 4 * float(F(c._Fconst(i) * a))

    @property
    def omega_nonu(self) -> float:
        return self.cosmology.Omega_m - self._omega_nu(1.0)

    @property
    def delta_nu_prefac(self) -> float:
        return 1.5 * self.cosmology.Omega_m / HUBBLE_DISTANCE

    def _get_delta_tot(self, delta_nu, delta_cdm, a):
        OmegaNua3 = self._omega_nu(a) * a ** 3
        return (OmegaNua3 * delta_nu + self.omega_nonu * delta_cdm) \
            / (OmegaNua3 + self.omega_nonu)

    # ---- initialization (delta_tot_first_init) ----

    def first_init(self, wavenum, delta_cdm, a: float):
        self.wavenum = np.asarray(wavenum, dtype=np.float64)
        delta_cdm = np.asarray(delta_cdm, dtype=np.float64)
        T_ratio = np.ones_like(self.wavenum)
        if self.t_init is not None and self.t_init.size > 0:
            interp = interp1d(self.t_init.k, self.t_init.f,
                              kind="cubic" if self.t_init.size > 2
                              else "linear", fill_value="extrapolate")
            pos = self.wavenum > 0
            T_ratio[pos] = interp(np.log10(self.wavenum[pos]))
        self.delta_nu_init = delta_cdm * T_ratio
        self.delta_tot = [self._get_delta_tot(
            self.delta_nu_init, delta_cdm, self.time_transfer)]
        self.scalefact = [math.log(a)]

    # ---- the linear-response integral (get_delta_nu) ----

    def _get_delta_nu_single(self, a: float, mnu: float) -> np.ndarray:
        c = self.cosmology
        kBtnu = BOLEVK * c.Gamma_nu * c.T_cmb
        mnubykT = mnu / kBtnu
        la_T = math.log(self.time_transfer)
        la = math.log(a)

        fsl_A0a = fslength(c, la_T, la)
        deriv_prefac = (self.time_transfer * self.time_transfer
                        * c.E(self.time_transfer) / HUBBLE_DISTANCE)
        specJ0 = special_J(self.wavenum * fsl_A0a
                           / (mnubykT if mnubykT > 0 else 1.0))
        delta_nu = specJ0 * self.delta_nu_init * (1.0 + deriv_prefac
                                                  * fsl_A0a)

        Na = len(self.scalefact)
        if Na > 1 and mnubykT > 0:
            # dense free-streaming length table over [la_T, la]
            Nfs = max(Na * 16, 48)
            fsscales = np.linspace(la_T, la, Nfs)
            fslengths = np.array([fslength(c, s, la) for s in fsscales])
            fs_spline = CubicSpline(fsscales, fslengths)

            scal = np.asarray(self.scalefact)
            hist = np.asarray(self.delta_tot)         # (Na, nk)
            if Na > 2:
                dt_spline = CubicSpline(scal, hist, axis=0)
            else:
                dt_spline = interp1d(scal, hist, axis=0,
                                     fill_value="extrapolate")

            # Gauss-Legendre over log a, vectorized over k
            ngl = max(48, 8 * Na)
            xg, wg = np.polynomial.legendre.leggauss(ngl)
            mid = 0.5 * (la_T + la)
            half = 0.5 * (la - la_T)
            nodes = mid + half * xg
            fsl = fs_spline(nodes)                    # (ngl,)
            anode = np.exp(nodes)
            Enode = np.array([c.E(float(v)) for v in anode])
            dt = dt_spline(nodes)                     # (ngl, nk)
            J = special_J(self.wavenum[None, :] * fsl[:, None] / mnubykT)
            integ = (fsl / (anode * Enode))[:, None] * J * dt
            d_nu_int = half * np.einsum("g,gk->k", wg, integ)
            delta_nu = delta_nu + self.delta_nu_prefac * d_nu_int
        return delta_nu

    def get_delta_nu_combined(self, a: float) -> np.ndarray:
        """Sum over massive species weighted by their density
        (neutrinos_lra.c:509-527)."""
        c = self.cosmology
        total = np.zeros_like(self.wavenum)
        Om_tot = self._omega_nu(a)
        for i in range(c.N_ncdm):
            om_i = self._omega_nu_single(a, i)
            total += (self._get_delta_nu_single(a, c.m_ncdm[i])
                      * om_i / Om_tot)
        return total

    # ---- the per-step update (delta_nu_from_power) ----

    def update_from_power(self, k, delta_cdm, a: float):
        """Given delta_cdm(k) = sqrt(P_cdm(k)) at time a, update the
        history and return (nu_prefac, delta_nu_ratio(k)) for the force
        transfer (neutrinos_lra.c:185-283)."""
        k = np.asarray(k, dtype=np.float64)
        delta_cdm = np.asarray(delta_cdm, dtype=np.float64)

        if not self.init_done:
            if not self.delta_tot:
                self.first_init(k, delta_cdm, a)
            self.delta_nu_last = self.get_delta_nu_combined(
                math.exp(self.scalefact[-1]))
            self.init_done = True

        power_in = delta_cdm  # same binning assumed (same mesh)

        if math.log(a) - self.scalefact[-1] > 1e-8:
            # provisional entry for interpolation at the current time
            self.scalefact.append(math.log(a))
            self.delta_tot.append(self._get_delta_tot(
                self.delta_nu_last, power_in, a))
            self.delta_nu_last = self.get_delta_nu_combined(a)
            if len(self.scalefact) < 2 or \
                    a > math.exp(self.scalefact[-2]) + 0.009:
                # keep, with the updated delta_nu
                self.delta_tot[-1] = self._get_delta_tot(
                    self.delta_nu_last, power_in, a)
            else:
                self.scalefact.pop()
                self.delta_tot.pop()

        OmegaNu = self._omega_nu(a)
        nu_prefac = OmegaNu / (self.omega_nonu / a ** 3)
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = np.where(power_in > 0,
                             np.maximum(self.delta_nu_last, 0.0)
                             / np.where(power_in > 0, power_in, 1.0),
                             0.0)
        return nu_prefac, ratio

    # ---- snapshot state (ncdm_lr_save_neutrinos, io.c:592-599) ----

    def save(self, bigfile):
        if not self.init_done:
            return
        bn = bigfile.create_block("Neutrino")
        ia = len(self.scalefact)
        bn.attrs.set("Nscale", np.uint64(ia), "u8")
        bn.attrs.set("scalefact", np.asarray(self.scalefact), "f8")
        bn.attrs.set("Nkval", np.uint64(len(self.wavenum)), "u8")
        deltas = np.asarray(self.delta_tot).T.copy()  # (nk, ia)
        bigfile.create_block("Neutrino/Deltas", deltas)
        bigfile.create_block("Neutrino/DeltaNuInit",
                             self.delta_nu_init[:, None])
        bigfile.create_block("Neutrino/kvalue", self.wavenum[:, None])

    def load(self, bigfile):
        bn = bigfile.open_block("Neutrino")
        self.scalefact = list(np.atleast_1d(bn.attrs.get("scalefact")))
        deltas = bigfile.open_block("Neutrino/Deltas").read_all()
        self.delta_tot = list(np.asarray(deltas).T)
        self.delta_nu_init = bigfile.open_block(
            "Neutrino/DeltaNuInit").read_all().reshape(-1)
        self.wavenum = bigfile.open_block(
            "Neutrino/kvalue").read_all().reshape(-1)
        self.delta_nu_last = self.get_delta_nu_combined(
            math.exp(self.scalefact[-1]))
        self.init_done = True
