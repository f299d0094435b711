"""The force path's buffer economy gives the same bits as the plain
out-of-place composition it replaces (32^3, CPU).

The lean paths scale in place (the canvas by the mean mass, r2c's
1/Norm, c2r's Norm on a donated field), make each gradient of the force's
k-space stage (gravity.acc_fields) in one pass and let it go as its
field is made, sort and permute columns one at a time into a donated
store or into donated x and v, and kick and drift in place in the
columns the Solver made and nobody outside has seen. Each is
held here, bit for bit, against the plain expressions written out below,
and every kept input is checked unchanged.
"""

import numpy as np
import pytest
import torch

from fastpm_torch import benchlib, gravity, kernels, transfers
from fastpm_torch import solver as solver_module
from fastpm_torch.cosmology import Cosmology
from fastpm_torch.kdk import DriftFactor, KickFactor
from fastpm_torch.mesh import PM
from fastpm_torch.ops import cic
from fastpm_torch.painter import Painter
from fastpm_torch.powerspectrum import FuncK
from fastpm_torch.solver import Solver, SolverConfig
from fastpm_torch.store import Store, lattice_store
from fastpm_torch import ic

import os

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "powerspec.txt")
N = 32


def same(a, b):
    """Bit equality of two tensors (NaN-free inputs)."""
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b)


# ---- the plain expressions the lean paths replace ----

def plain_r2c(pm, x):
    return (torch.fft.rfftn(x) / pm.Norm).to(pm.cdtype)


def plain_c2r(pm, k):
    return torch.fft.irfftn(k * pm.Norm, s=pm.Nmesh).to(pm.dtype)


def plain_grad(pm, dk, d, order):
    kd = pm.broadcast_table(["k", "k_finite"][order], d)
    out = dk * torch.complex(torch.zeros_like(kd), kd)
    return out * pm.not_self_conjugate()


def plain_pot(pm, dk, order):
    kk = pm.kk(["kk", "kk_finite", "kk_finite2"][order])
    nz = kk != 0
    inv = torch.where(nz, 1.0 / torch.where(nz, kk, torch.ones_like(kk)),
                      torch.zeros_like(kk))
    return -(dk * inv)


def plain_grad3(pm, fk, order):
    return tuple(plain_c2r(pm, plain_grad(pm, fk, d, order))
                 for d in range(3))


def plain_kernel_transfer(pm, dk, kernel_type, field, memb=0):
    potorder, gradorder, _, deconv = kernels.kernel_orders(kernel_type)
    out = dk
    for _ in range(deconv):
        out = transfers.apply_decic(pm, out)
    if field == "potential":
        return plain_pot(pm, out, potorder)
    out = plain_pot(pm, out, potorder)
    if field == "acc":
        return plain_grad(pm, out, memb, gradorder)
    d1, d2 = [(0, 0), (1, 1), (2, 2), (0, 1), (1, 2), (2, 0)][memb]
    return plain_grad(pm, plain_grad(pm, out, d1, gradorder), d2, gradorder)


@pytest.fixture(scope="module")
def pm():
    return PM(N, 64.0, device="cpu")


@pytest.fixture(scope="module")
def field(pm):
    g = torch.Generator().manual_seed(5)
    return torch.randn(pm.rshape, generator=g)


def test_r2c_c2r(pm, field):
    k = pm.r2c(field)
    same(k, plain_r2c(pm, field))
    kept = k.clone()
    same(pm.c2r(k), plain_c2r(pm, kept))
    same(k, kept)                       # not donated: intact
    same(pm.c2r(k, donate=True), plain_c2r(pm, kept))


@pytest.mark.parametrize("order", [0, 1])
def test_c2r_grad3(pm, field, order):
    """The force's k-space stage (kernel naive or 1_4: potorder 0,
    gradorder 0 or 1) through the plain c2r against the plain gradients
    of the plain potential; delta_k kept."""
    fk = plain_r2c(pm, field)
    kept = fk.clone()
    want = plain_grad3(pm, plain_pot(pm, kept, 0), order)
    got = gravity.acc_fields(pm, fk, {0: "naive", 1: "1_4"}[order],
                             lambda g: plain_c2r(pm, g))
    for g, w in zip(got, want):
        same(g, w)
    same(fk, kept)


@pytest.mark.parametrize("kernel_type", ["1_4", "gadget", "5_4"])
def test_transfers(pm, field, kernel_type):
    dk = plain_r2c(pm, field)
    kept = dk.clone()
    potorder, gradorder, _, _ = kernels.kernel_orders(kernel_type)
    same(transfers.apply_pot(pm, dk, potorder), plain_pot(pm, kept,
                                                          potorder))
    same(transfers.apply_grad(pm, dk, 1, gradorder),
         plain_grad(pm, kept, 1, gradorder))
    for field_, memb in (("potential", 0), ("acc", 2), ("tidal", 3),
                         ("tidal", 5)):
        same(kernels.apply_kernel_transfer(pm, dk, kernel_type, field_,
                                           memb),
             plain_kernel_transfer(pm, kept, kernel_type, field_, memb))
    same(dk, kept)


def _particles(n=N // 2, box=64.0, seed=1):
    x, v = benchlib.example_particles(n, box, seed=seed, jitter=0.9,
                                      device="cpu")
    g = torch.Generator().manual_seed(seed)
    return x, torch.randn(x.shape, generator=g)


def plain_fields(pm, dk, kernel_type, c2r):
    """The force's three fields as the plain chain: c2r of each
    acceleration transfer."""
    return tuple(c2r(plain_kernel_transfer(pm, dk, kernel_type, "acc", d))
                 for d in range(3))


def plain_step(pm, x, v, coeffs, carry, kernel_type="1_4", sort=True):
    """The benchlib step as plain out-of-place expressions of the
    Solver's force bodies (the carry's K1 with 1 / N a particle, or the
    Painter's canvas over the total mass; the unnormalised FFTs; the
    plain chain); sort=False: the carry's K1 and K2 on the rows in their
    order (the stale step)."""
    inv = pm.InvCellSize
    painter = Painter(pm, "cic")
    if carry:
        if sort:
            order = cic.sort_by_cell(x, pm.Nmesh, inv)
            x, v = x[order], v[order]
        canvas = cic.cic_paint(x, pm.Nmesh, inv,
                               float(np.float32(1.0 / x.shape[0])))
    else:
        canvas = painter.paint(x, 1.0) / x.shape[0]
    fields = plain_fields(pm, torch.fft.rfftn(canvas), kernel_type,
                          lambda k: torch.fft.irfftn(k, s=pm.Nmesh,
                                                     norm="forward"))
    acc = (cic.cic_readout(fields, x, inv) if carry
           else painter.readout3(*fields, x))
    c = torch.tensor(coeffs, dtype=torch.float32)
    L = torch.tensor(pm.BoxSize, dtype=torch.float32)
    v = v + acc * c[0]
    x = x + v * c[1]
    return x - torch.floor(x / L) * L, v, acc


@pytest.mark.parametrize("carry", [True, False])
@pytest.mark.parametrize("donate", [False, True])
def test_benchlib_step(pm, carry, donate):
    x0, v0 = _particles()
    coeffs = (0.05, 0.02)
    step = benchlib.make_step_fn(pm, carry_sorted=carry, donate=donate,
                                 device="cpu")
    wx, wv = x0, v0
    x, v = x0.clone(), v0.clone()
    for _ in range(3):
        wx, wv, wacc = plain_step(pm, wx, wv, coeffs, carry)
        xin, vin = x, v
        x, v, acc = step(x, v, coeffs)
        # a donated x and v carry the results; otherwise they are intact
        assert (x is xin and v is vin) == donate
    same(x, wx)
    same(v, wv)
    same(acc, wacc)
    xk, vk = x0.clone(), v0.clone()
    step(xk, vk, coeffs)
    if not donate:
        same(xk, x0)
        same(vk, v0)


def test_stale_steps(pm):
    """make_stale_step_fns: fresh, stale, stale against the plain steps,
    the caller's x and v intact."""
    x0, v0 = _particles()
    coeffs = (0.05, 0.02)
    fresh, stale = benchlib.make_stale_step_fns(pm, device="cpu")
    x, v = x0.clone(), v0.clone()
    wx, wv = x0, v0
    for i, step in enumerate((fresh, stale, stale)):
        wx, wv, wacc = plain_step(pm, wx, wv, coeffs, True, sort=i == 0)
        x, v, acc = step(x, v, coeffs)
    same(x, wx)
    same(v, wv)
    same(acc, wacc)
    xk, vk = x0.clone(), v0.clone()
    stale(xk, vk, coeffs)
    same(xk, x0)
    same(vk, v0)


@pytest.mark.parametrize("sort_block", [None, 256])
def test_carry_sort_donated(sort_block):
    x, v = _particles(n=12)
    want = benchlib.sort.carry_sort(x, v, (24,) * 3, (24 / 64.0,) * 3,
                                    sort_block)
    xd, vd = x.clone(), v.clone()
    got = benchlib.sort.carry_sort(xd, vd, (24,) * 3, (24 / 64.0,) * 3,
                                   sort_block, donate=True)
    assert got[0] is xd and got[1] is vd
    same(got[0], want[0])
    same(got[1], want[1])


def _store(pm, seed=2):
    p = lattice_store(PM(N // 2, pm.BoxSize, device="cpu"),
                      columns=("v", "acc", "id", "rand"))
    g = torch.Generator().manual_seed(seed)
    cols = {c: torch.randn(p.x.shape, generator=g)
            for c in ("v", "acc", "dx1", "dx2", "pgdc")}
    dx = 3 * torch.randn(p.x.shape, generator=g)
    return p.replace(x=(p.x + dx).remainder(64.0), **cols)


def test_take_donated(pm):
    p = _store(pm)
    index = torch.from_numpy(np.random.RandomState(0).permutation(
        p.np_local))
    want = p.take(index)
    kept = {c: t.clone() for c, t in p.columns()}
    q = p.replace()
    got = q.take(index, donate=True)
    assert got is q
    for c, t in want.columns():
        same(getattr(got, c), t)
    for c, t in p.columns():            # the store q was made from
        same(t, kept[c])


def test_force_keeps_delta_k(pm):
    """The carry force's delta_k (kept by the Solver for its P(k) event)
    and acc against the plain force."""
    p = _store(pm)
    painter = Painter(pm, "cic")
    want_p = p.replace(acc=None).take(cic.sort_by_cell(p.x, pm.Nmesh,
                                                       pm.InvCellSize))
    canvas = cic.cic_paint(want_p.x, pm.Nmesh, pm.InvCellSize,
                           float(np.float32(p.M0)))
    dk = plain_r2c(pm, canvas / (p.M0 * p.np_local / pm.Norm))
    fields = plain_grad3(pm, plain_kernel_transfer(pm, dk, "1_4",
                                                   "potential"), 1)
    acc = cic.cic_readout(fields, want_p.x, pm.InvCellSize)
    for donate in (False, True):
        got, got_dk = gravity.compute_force_carry(
            pm, painter, p.replace(), donate=donate)
        same(got_dk, dk)
        same(got.acc, acc)
        same(got.id, want_p.id)


def test_multi_force_potential_tidal(pm):
    """compute_force with the potential and the tidal tensor: the canvas
    scaled in place and the donated c2r against the plain ones."""
    p = _store(pm).replace(potential=torch.zeros(N ** 3 // 8),
                           tidal=torch.zeros(N ** 3 // 8, 6))
    painter = Painter(pm, "cic")
    (got,), dk = gravity.compute_force(pm, painter, [p], "1_4", "none",
                                       True, True)
    order = cic.cell_order(p.x, pm.Nmesh, pm.InvCellSize)
    canvas = painter.paint(p.x, float(np.float32(p.M0)), None, order)
    want_dk = plain_r2c(pm, canvas / (p.M0 * p.np_local / pm.Norm))
    same(dk, want_dk)
    fields = plain_grad3(pm, plain_kernel_transfer(pm, dk, "1_4",
                                                   "potential"), 1)
    same(got.acc, painter.readout3(*fields, p.x, order))
    pot = plain_c2r(pm, plain_kernel_transfer(pm, dk, "1_4", "potential"))
    same(got.potential, painter.readout_fields([pot], p.x, order)[:, 0])
    tid = [plain_c2r(pm, plain_kernel_transfer(pm, dk, "1_4", "tidal", m))
           for m in range(6)]
    same(got.tidal, torch.cat([painter.readout_fields(tid[:3], p.x, order),
                               painter.readout_fields(tid[3:], p.x, order)],
                              1))


@pytest.mark.parametrize("mode", ["fastpm", "pm", "cola", "za", "2lpt"])
def test_kick_drift_in_place(pm, mode):
    c = Cosmology(h=0.6774, Omega_m=0.307494)
    s = Solver(SolverConfig(nc=N // 2, boxsize=64.0, force_mode=mode,
                            time_step=[0.1, 1.0]), c, device="cpu")
    kick = KickFactor(c, mode, 0.4, 0.45, 0.5)
    drift = DriftFactor(c, mode, 0.4, 0.45, 0.5)
    p = _store(pm).replace(a_v=0.4, a_x=0.4)
    for act, f, col in (("kick", s.kick_one, "v"),
                        ("drift", s.drift_one, "x")):
        fac = kick if act == "kick" else drift
        before = getattr(p, col).clone()
        want = f(p, fac, 0.5)
        same(getattr(p, col), before)   # not donated: intact
        mine = p.replace(**{col: before})
        got = f(mine, fac, 0.5, donate=True)
        assert getattr(got, col) is before  # written in place
        same(getattr(got, col), getattr(want, col))
    assert s.in_place == {"kick": 1, "drift": 1}


def _solver(nc=N // 2, nstep=3):
    steps = list(np.linspace(0.1, 1.0, nstep))
    c = Cosmology(h=0.6774, Omega_m=0.307494, growth_mode="lcdm")
    s = Solver(SolverConfig(nc=nc, boxsize=2.0 * nc, time_step=steps,
                            force_mode="fastpm", pm_nc_factor=2,
                            need_rand=False), c, device="cpu")
    dk, _ = ic.linear_field(s.lptpm, c, FuncK.from_file(FIXTURE), seed=42,
                            aout=1.0)
    s.setup_lpt(dk, steps[0])
    return s


@pytest.fixture
def plain_primitives(monkeypatch):
    """Patch the lean primitives with the plain expressions: the plain
    out-of-place composition of the Solver's steps."""
    monkeypatch.setattr(PM, "r2c", plain_r2c)
    monkeypatch.setattr(PM, "c2r", lambda pm, k, donate=False:
                        plain_c2r(pm, k))
    monkeypatch.setattr(gravity, "acc_fields", plain_fields)
    monkeypatch.setattr(kernels, "apply_kernel_transfer",
                        plain_kernel_transfer)
    monkeypatch.setattr(Store, "take", lambda p, index, donate=False:
                        p.replace(**{c: t[index] for c, t in p.columns()}))
    monkeypatch.setattr(Solver, "_owns", lambda s, name, column: False)


def _final(s):
    p = s.species["cdm"]
    order = torch.argsort(p.id)
    return {c: getattr(p, c)[order] for c in ("x", "v", "acc", "id")}


@pytest.fixture(scope="module")
def lean_run():
    s = _solver()
    s.evolve()
    return s


def test_solver_steps_bit_equal(lean_run, plain_primitives):
    """Three Solver steps: the lean run against the plain composition."""
    assert lean_run.in_place["kick"] > 0 and lean_run.in_place["drift"] > 0
    ref = _solver()
    ref.evolve()
    assert not ref.in_place
    got, want = _final(lean_run), _final(ref)
    for c in want:
        same(got[c], want[c])


def test_kept_store_unchanged(lean_run):
    """A store kept by its caller across the kicks and drifts is not
    written, and the run gives the same bits."""
    s = _solver()
    kept = s.species["cdm"]
    cols = {c: t.clone() for c, t in kept.columns()}
    seen = []

    def keep(event):
        # an event handler that keeps the store it sees after each force
        p = event.solver.species["cdm"]
        seen.append((p, {c: t.clone() for c, t in p.columns()}))

    s.event_handlers.on(solver_module.ev.EVENT_FORCE,
                        solver_module.ev.STAGE_AFTER, keep)
    s.evolve()
    for c, t in cols.items():
        same(getattr(kept, c), t)
    for p, before in seen:
        for c, t in before.items():
            same(getattr(p, c), t)
    # each read of the table after a force ended the solver's claims
    assert not s.in_place
    got, want = _final(s), _final(lean_run)
    for c in want:
        same(got[c], want[c])


def test_peek_keeps_claims(lean_run):
    """A handler that reads through Solver.peek (as the diagnostics do)
    leaves the kicks and drifts in place."""
    s = _solver()
    seen = []
    s.event_handlers.on(solver_module.ev.EVENT_FORCE,
                        solver_module.ev.STAGE_AFTER,
                        lambda event: seen.append(
                            float(event.solver.peek("cdm").acc.abs().max())))
    s.evolve()
    assert len(seen) == 3 and s.in_place == lean_run.in_place
    got, want = _final(s), _final(lean_run)
    for c in want:
        same(got[c], want[c])
