"""Power spectrum measurement and k-function tables
(reference: libfastpm/powerspectrum.c).

Port of fastpm_tpu/powerspectrum.py. Measurement is spherical shell
binning with integer-|ik| bins of width k0 = 2 pi / L and hermitian
double-count weights (powerspectrum.c:62-124). The binned sums of a
small field run on the host in float32 in mode order, as the JAX
package's; those of a large one on its device in float64 (index_add_
into copies of the bins); normalization and text output are host-side.
"""

from __future__ import annotations

import io
import math

import numpy as np
import torch

from .mesh import PM

__all__ = ["PowerSpectrum", "FuncK", "measure_power", "measure_power_2d",
           "measure_transfer", "sigma_tophat"]


class FuncK:
    """A tabulated function of k with the reference's log-log interpolation
    (powerspectrum.c:386-428): log-linear interp of (log k, log f), falling
    back to linear when f <= 0; f(0) = 1; constant extrapolation is an
    error in the reference (we clamp to the table ends)."""

    def __init__(self, k, f):
        self.k = np.asarray(k, dtype=np.float64)
        self.f = np.asarray(f, dtype=np.float64)
        if self.k.ndim != 1 or self.k.shape != self.f.shape:
            raise ValueError("k and f must be matching 1D arrays")
        self.size = len(self.k)

    @classmethod
    def from_string(cls, text: str) -> "FuncK":
        """Parse 'k f' pairs, one per line (funck_init_from_string)."""
        ks, fs = [], []
        for line in text.splitlines():
            parts = line.split()
            if len(parts) < 2:
                continue
            try:
                k = float(parts[0])
                f = float(parts[1])
            except ValueError:
                continue
            ks.append(k)
            fs.append(f)
        return cls(np.array(ks), np.array(fs))

    @classmethod
    def from_file(cls, path: str) -> "FuncK":
        with open(path) as fp:
            return cls.from_string(fp.read())

    def __call__(self, k):
        """Vectorized evaluation; matches fastpm_funck_eval semantics.
        Accepts numpy/scalars (host float64) or a tensor (evaluated in
        float64 on its device)."""
        if torch.is_tensor(k):
            return self._eval_torch(k)
        k = np.asarray(k, dtype=np.float64)
        scalar = k.ndim == 0
        k = np.atleast_1d(k)

        # bracket with the same binary search bounds: l in [0, size-2]
        r = np.searchsorted(self.k, k, side="right")
        l = np.clip(r - 1, 0, self.size - 2)
        r = l + 1
        k1, k2 = self.k[l], self.k[r]
        f1, f2 = self.f[l], self.f[r]

        loglog = (f1 > 0) & (f2 > 0) & (k1 != 0) & (k2 != 0) & (k > 0)
        with np.errstate(divide="ignore", invalid="ignore"):
            lk, lk1, lk2 = np.log(np.where(k > 0, k, 1)), np.log(np.where(k1 > 0, k1, 1)), np.log(np.where(k2 > 0, k2, 1))
            lf1, lf2 = np.log(np.where(f1 > 0, f1, 1)), np.log(np.where(f2 > 0, f2, 1))
            vlog = np.exp(((lk - lk1) * lf2 + (lk2 - lk) * lf1) / (lk2 - lk1))
            vlin = ((k - k1) * f2 + (k2 - k) * f1) / (k2 - k1)
        out = np.where(loglog, vlog, vlin)
        out = np.where(k == 0, 1.0, out)
        return float(out[0]) if scalar else out

    def _eval_torch(self, k):
        """The numpy formula of __call__ in float64 torch ops."""
        dev = k.device
        kt = torch.as_tensor(self.k, dtype=torch.float64, device=dev)
        ft = torch.as_tensor(self.f, dtype=torch.float64, device=dev)
        k = k.to(torch.float64)
        r = torch.searchsorted(kt, k.contiguous(), right=True)
        l = torch.clamp(r - 1, 0, self.size - 2)
        k1, k2 = kt[l], kt[l + 1]
        f1, f2 = ft[l], ft[l + 1]
        loglog = (f1 > 0) & (f2 > 0) & (k1 != 0) & (k2 != 0) & (k > 0)
        one = torch.ones_like(k)

        def safelog(a):
            return torch.log(torch.where(a > 0, a, one))

        lk, lk1, lk2 = safelog(k), safelog(k1), safelog(k2)
        lf1, lf2 = safelog(f1), safelog(f2)
        vlog = torch.exp(((lk - lk1) * lf2 + (lk2 - lk) * lf1)
                         / (lk2 - lk1))
        vlin = ((k - k1) * f2 + (k2 - k) * f1) / (k2 - k1)
        out = torch.where(loglog, vlog, vlin)
        return torch.where(k == 0, one, out)


class PowerSpectrum:
    """Binned P(k) with mode counts and metadata."""

    def __init__(self, k, p, Nmodes, edges, Volume, k0):
        self.k = np.asarray(k, dtype=np.float64)
        self.p = np.asarray(p, dtype=np.float64)
        self.Nmodes = np.asarray(Nmodes, dtype=np.float64)
        self.edges = np.asarray(edges, dtype=np.float64)
        self.Volume = float(Volume)
        self.k0 = float(k0)
        self.size = len(self.k)

    def as_funck(self) -> FuncK:
        return FuncK(self.k, self.p)

    def write(self, filename: str, N: float, boxsize) -> None:
        """Text format 'k p N' + metadata footer (powerspectrum.c:149-168),
        parseable by nbodykit-based checks."""
        if np.isscalar(boxsize):
            boxsize = (boxsize,) * 3
        with open(filename, "w") as fp:
            fp.write(self.to_text(N, boxsize))

    def to_text(self, N: float, boxsize) -> str:
        buf = io.StringIO()
        buf.write("# k p N \n")
        for i in range(self.size):
            buf.write("%g %g %g\n" % (self.k[i], self.p[i], self.Nmodes[i]))
        buf.write("# metadata 7\n")
        buf.write("# volume %g float64\n" % self.Volume)
        buf.write("# shotnoise %g float64\n" % (self.Volume / N))
        buf.write("# N1 %g int\n" % N)
        buf.write("# N2 %g int\n" % N)
        buf.write("# Lz %g float64\n" % boxsize[2])
        buf.write("# Lx %g float64\n" % boxsize[0])
        buf.write("# Ly %g float64\n" % boxsize[1])
        return buf.getvalue()

    def large_scale(self, Nmax: int) -> float:
        """Mode-weighted mean P over k <= Nmax k0, ignoring empty bins
        (powerspectrum.c:170-184)."""
        kmax = Nmax * self.k0
        plin = 0.0
        nm = 0.0
        i = 0
        while i == 0 or (i < self.size and self.k[i] <= kmax):
            plin += self.p[i] * self.Nmodes[i]
            nm += self.Nmodes[i]
            i += 1
        return plin / nm


# a field of at most this many modes is binned on the host (a fetch of
# at most 8 MB): float32 sums in mode order, the order of the JAX
# package's bincount on the CPU, whose printed goldens depend on it.
# A larger field is binned on its device in float64 into _COPIES copies
# of the bins (mode i into copy i % _COPIES), so that the atomics of
# neighbouring modes hit different addresses, and the copies are summed
# after.
_HOST_BIN_MODES = 1 << 20
_COPIES = 1024


def _n_copies(t) -> int:
    """1 where a field like t is binned on the host, else _COPIES."""
    on_host = t.device.type == "cpu" or t.numel() <= _HOST_BIN_MODES
    return 1 if on_host else _COPIES


def _bin_index(b, nbins: int, copies: int):
    """The index _bin_sum scatters by: the bin of each mode in the
    mode's copy (the bin itself for one copy)."""
    if copies == 1:
        return b
    copy = torch.arange(b.numel(), device=b.device) % copies
    return (b + (nbins + 1) * copy).to(torch.int32)


def _bin_sum(index, values, nbins: int, copies: int):
    """Sums of values (flat, per mode) into nbins + 1 bins by index
    (_bin_index): one copy on the host in float32 in mode order, more
    on values' device in float64, the copies summed after."""
    if copies == 1:
        return torch.zeros(nbins + 1, dtype=torch.float32).index_add_(
            0, index.cpu(), values.cpu())
    sums = torch.zeros(copies * (nbins + 1), dtype=torch.float64,
                       device=values.device).index_add_(
                           0, index, values.double())
    return sums.view(copies, nbins + 1).sum(0)


def _shell_bins(pm: PM, copies: int = None):
    """Delta-independent shell binning of one PM (or one rank's k shard,
    parallel.pfft.KShard), cached on it: the flat bin index per mode
    (overflow bin = nbins) as _bin_index gives it for `copies` copies
    (by default _n_copies of the mesh), the hermitian weights with DC
    and out-of-range modes zeroed, the per-bin mode counts and k sums
    ((2, nbins) float64, summed by _bin_sum), and the copies."""
    def make():
        nbins = pm.Nmesh[0] // 2
        k0 = 2 * math.pi / pm.BoxSize[0]
        kk = pm.integer_kk()
        # exact isqrt: float sqrt then correct downward/upward so
        # bin^2 <= kk < (bin+1)^2
        b = torch.floor(torch.sqrt(kk.to(torch.float64))).to(torch.int64)
        b = torch.where((b + 1) * (b + 1) <= kk, b + 1, b)
        b = torch.where(b * b > kk, b - 1, b)
        b = b.expand(pm.kshape).reshape(-1)
        w = pm.hermitian_weights().expand(pm.kshape).reshape(-1)
        # the DC mode (kk = 0) is excluded
        in_range = (b < nbins) & (kk.expand(pm.kshape).reshape(-1) > 0)
        b = torch.where(in_range, b, torch.full_like(b, nbins))
        w = torch.where(in_range, w, torch.zeros_like(w))
        kmode = (torch.sqrt(kk.to(torch.float32)) * k0).expand(
            pm.kshape).reshape(-1)
        n = _n_copies(w) if copies is None else copies
        index = _bin_index(b.to(torch.int32), nbins, n)
        # the weights are 0, 1, 2: the counts are exact in float32
        counts = torch.stack([_bin_sum(index, w, nbins, n)[:nbins],
                              _bin_sum(index, w * kmode, nbins, n)[:nbins]])
        # int32 indices and float32 weights (0, 1, 2: exact) halve the
        # cached bytes
        return index, w, counts.double(), n
    return pm._const("shell_bins" if copies is None
                     else "shell_bins_%d" % copies, make)


def measure_power(pm: PM, delta1_k, delta2_k=None, ring=None,
                  copies: int = None) -> PowerSpectrum:
    """P(k) of one or two overdensity fields (powerspectrum.c:34-124).

    Shell binning: bin index is the integer part of |ik| (isqrt of the
    integer |ik|^2), bins of width k0 = 2 pi / L, hermitian weight 2 except
    on the kz = 0 / Nyquist planes, DC excluded. The per-mode products
    are float32. A small field is summed on the host in float32 in mode
    order, as the JAX package's bincount on the CPU
    (powerspectrum.py:188-232 there), so that its printed goldens
    reproduce on the card too; a large one (more than 2^20 modes) in
    float64 on the device through copies of the bins (_bin_sum). copies
    overrides the choice: 1 sums on the host, more on the field's
    device.

    With a ring (parallel.comm.Ring), pm is the rank's k shard and the
    fields are its shards: the bin sums are all-reduced, so every rank
    gets the same spectrum.
    """
    if delta2_k is None:
        delta2_k = delta1_k
    nbins = pm.Nmesh[0] // 2
    k0 = 2 * math.pi / pm.BoxSize[0]
    b, w, counts, copies = _shell_bins(pm, copies)
    value = (delta1_k.real * delta2_k.real
             + delta1_k.imag * delta2_k.imag).reshape(-1)
    psum = _bin_sum(b, w * value, nbins, copies)[:nbins]
    sums = torch.cat([psum[None].double(), counts.to(psum.device)])
    if ring is not None:
        sums = ring.psum(sums.to(value.device))
    psum, Nmodes, ksum = sums.cpu().numpy()

    good = Nmodes > 0
    kmean = np.where(good, ksum / np.where(good, Nmodes, 1), 0.0)
    p = np.where(good, psum / np.where(good, Nmodes, 1) * pm.Volume, 0.0)
    edges = np.arange(nbins + 1) * k0
    return PowerSpectrum(kmean, p, Nmodes, edges, pm.Volume, k0)


def measure_power_2d(pm: PM, delta1_k, delta2_k=None, Nmu: int = 10,
                     copies: int = None):
    """(k, mu) wedge power spectrum with the z axis as the line of sight
    (the nbodykit FFTPower mode='2d' convention of
    python/comparehalos.py). mu = kz / |k| in [0, 1] by hermitian
    symmetry; Nmu bins over [0, 1]; DC excluded. Returns a dict of
    (nbins, Nmu) float64 arrays k, mu, power, Nmodes. The per-mode
    values are float32 as the JAX package's; the sums go through
    _bin_sum as measure_power's (copies likewise)."""
    if delta2_k is None:
        delta2_k = delta1_k
    nbins = pm.Nmesh[0] // 2
    k0 = 2 * math.pi / pm.BoxSize[0]
    kk = pm.integer_kk().expand(pm.kshape)
    # exact isqrt of the integer |ik|^2, as _shell_bins
    b = torch.floor(torch.sqrt(kk.to(torch.float64))).to(torch.int64)
    b = torch.where((b + 1) * (b + 1) <= kk, b + 1, b)
    b = torch.where(b * b > kk, b - 1, b)
    # integer kz of each mode (the hermitian axis is z)
    iz = torch.arange(pm.Nmesh[2] // 2 + 1, device=kk.device)
    kz2 = (iz * iz).to(torch.float32).view(1, 1, -1)
    kkf = kk.to(torch.float32)
    mu = torch.sqrt(kz2 / torch.clamp(kkf, min=1.0))
    mu = torch.where(kk == 0, torch.zeros_like(mu), mu)
    mubin = torch.clamp((mu * Nmu).to(torch.int64), max=Nmu - 1)

    w = pm.hermitian_weights().expand(pm.kshape).clone()
    w[0, 0, 0] = 0.0
    value = (delta1_k.real * delta2_k.real
             + delta1_k.imag * delta2_k.imag).reshape(-1)
    k_of_mode = (torch.sqrt(kkf) * k0).reshape(-1)

    nb = nbins * Nmu
    in_range = b.reshape(-1) < nbins
    flat = torch.where(in_range, (b * Nmu + mubin).reshape(-1),
                       torch.full_like(in_range, nb, dtype=torch.int64))
    wf = torch.where(in_range, w.reshape(-1), torch.zeros_like(value))
    copies = _n_copies(value) if copies is None else copies
    index = _bin_index(flat.to(torch.int32), nb, copies)
    sums = [_bin_sum(index, v, nb, copies)[:nb].double().cpu().numpy()
            .reshape(nbins, Nmu)
            for v in (wf, wf * value, wf * k_of_mode, wf * mu.reshape(-1))]
    Nm, ps, ks, mus = sums
    good = Nm > 0
    safe = np.where(good, Nm, 1.0)
    return dict(k=np.where(good, ks / safe, 0.0),
                mu=np.where(good, mus / safe, 0.0),
                power=np.where(good, ps / safe * pm.Volume, 0.0),
                Nmodes=Nm)


def measure_transfer(pm: PM, src_k, dest_k) -> PowerSpectrum:
    """Binned transfer function sqrt(P_dest / P_src)
    (fastpm_transferfunction_init, powerspectrum.c:125-140)."""
    ps = measure_power(pm, src_k)
    ps2 = measure_power(pm, dest_k)
    good = ps.p > 0
    t = np.where(good, np.sqrt(ps2.p / np.where(good, ps.p, 1.0)), 0.0)
    return PowerSpectrum(ps.k, t, ps.Nmodes, ps.edges, ps.Volume, ps.k0)


def _gauss_kronrod(n=20):
    """Nodes/weights of the (2n+1)-point Gauss-Kronrod rule with the
    embedded n-point Gauss weights, from the Stieltjes polynomial
    (roots of E_{n+1}, solved in the Legendre basis)."""
    from numpy.polynomial import legendre as L
    xg, wg = np.polynomial.legendre.leggauss(n)
    xq, wq = np.polynomial.legendre.leggauss(2 * n + 4)
    Pn = L.legvander(xq, n + 1)
    rows, rhs = [], []
    for j in range(n + 1):
        integrand = Pn[:, n] * xq ** j
        row = (wq[:, None] * Pn * integrand[:, None]).sum(axis=0)
        rows.append(row[:n + 1])
        rhs.append(-row[n + 1])
    e = np.linalg.solve(np.array(rows), np.array(rhs))
    xs = L.legroots(np.concatenate([e, [1.0]]))
    xk = np.sort(np.concatenate([xg, np.real(xs)]))
    V = L.legvander(xk, 2 * n).T
    m = np.zeros(2 * n + 1)
    m[0] = 2.0
    wk = np.linalg.solve(V, m)
    wg_full = np.zeros_like(wk)
    wg_full[1::2] = wg          # gauss nodes interleave at odd slots
    return xk, wk, wg_full


_GK41 = None


def _qag(f, a, b, epsabs=0.0, epsrel=1e-4, limit=81920):
    """GSL gsl_integration_qag with GSL_INTEG_GAUSS41: adaptive
    bisection of the largest-error interval using the GK41 rule and
    GSL's qk error rescaling -- digit-compatible with the reference's
    quadrature (fastpm_powerspectrum_sigma, powerspectrum.c:250-279)."""
    import heapq
    global _GK41
    if _GK41 is None:
        _GK41 = _gauss_kronrod(20)
    XK, WK, WGF = _GK41
    eps = np.finfo(float).eps
    tiny = np.finfo(float).tiny

    def qk41(a, b):
        c = 0.5 * (a + b)
        h = 0.5 * (b - a)
        fv = f(c + h * XK)
        rk = np.sum(WK * fv)
        rg = np.sum(WGF * fv)
        resabs = np.sum(WK * np.abs(fv)) * abs(h)
        resasc = np.sum(WK * np.abs(fv - rk * 0.5)) * abs(h)
        err = abs((rk - rg) * h)
        if resasc != 0 and err != 0:
            err = resasc * min(1.0, (200 * err / resasc) ** 1.5)
        if resabs > tiny / (50 * eps):
            err = max(eps * 50 * resabs, err)
        return rk * h, err

    r0, e0 = qk41(a, b)
    if e0 <= max(epsabs, epsrel * abs(r0)):
        return r0
    heap = [(-e0, a, b, r0)]
    errsum, ressum = e0, r0
    for _ in range(limit):
        ne, aa, bb, rr = heapq.heappop(heap)
        mid = 0.5 * (aa + bb)
        r1, er1 = qk41(aa, mid)
        r2, er2 = qk41(mid, bb)
        errsum += er1 + er2 + ne
        ressum += r1 + r2 - rr
        heapq.heappush(heap, (-er1, aa, mid, r1))
        heapq.heappush(heap, (-er2, mid, bb, r2))
        if errsum <= max(epsabs, epsrel * abs(ressum)):
            break
    return sum(h[3] for h in heap)


def sigma_tophat(func: FuncK, R: float) -> float:
    """sigma(R): rms of the density field smoothed with a top-hat of
    radius R (powerspectrum.c:227-279); sigma8 = sigma_tophat(ps, 8).

    Uses the GSL-QAG(GAUSS41, relerr 1e-4) emulation so the printed
    value matches the reference's golden logs to the last digit
    (run-test-nbodykit.check pins 'sigma8 0.815897')."""
    def integrand(k):
        k = np.asarray(k, dtype=np.float64)
        kr = R * k
        safe = np.maximum(kr, 1e-300)
        w = 3 * (np.sin(kr) / safe ** 3 - np.cos(kr) / safe ** 2)
        w = np.where(kr < 1e-8, 0.0, w)
        return np.where(kr < 1e-8, 0.0,
                        4 * math.pi * k * k * w * w * func(k)
                        / (2 * math.pi) ** 3)

    return math.sqrt(float(_qag(integrand, 0.0, 500.0 / R)))
