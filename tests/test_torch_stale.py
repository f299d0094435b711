"""The port's benchlib step, stale-order stepping and stale force against
the JAX package on the CPU.

- make_step_fn (order-free with a full sort, with the k-sorted sort of
  K7, with K5's paint, and order-preserving) and make_stale_step_fns
  (fresh every 3rd step) over 5 steps of a jittered lattice, against the
  JAX make_step_fn, whose CPU form is its unfused path
  (tests/test_pallas_paint.py:test_stale_step_trajectory_matches_fresh
  holds JAX's own stale steps to it): rows matched by lexsort, atol 5e-5.
- compute_force_stale on a carried store drifted by up to 5 cells,
  against the JAX order-preserving compute_force by id: the drift that
  would overflow the JAX mover cap leaves the port's result exact.
- Solver(stale_every=3) against the JAX Solver(stale_every=0) by id at
  the 16^3, 5-step size of tests/test_order_free.py, atol 1e-4.
"""

import os

import numpy as np
import pytest
import torch

from fastpm_torch import benchlib, gravity
from fastpm_torch.convert import field_from_numpy, store_from_numpy
from fastpm_torch.cosmology import Cosmology
from fastpm_torch.mesh import PM
from fastpm_torch.painter import Painter
from fastpm_torch.solver import Solver, SolverConfig

POWERSPEC = os.path.join(os.path.dirname(__file__), "fixtures",
                         "powerspec.txt")
COSMO = dict(h=0.6774, Omega_m=0.307494, T_cmb=0.0, growth_mode="lcdm")
COEFFS = (0.5, 0.3)
NSTEP = 5


def _lexsorted(x, v):
    x, v = np.asarray(x), np.asarray(v)
    k = np.lexsort((x[:, 2], x[:, 1], x[:, 0]))
    return x[k], v[k]


@pytest.fixture(scope="module")
def jax_trajectory():
    """(x0, v0) of example_particles(16, 64.0, seed=2, jitter=0.4) and the
    JAX make_step_fn's state after 5 steps on PM(32, 64.0)."""
    import jax.numpy as jnp
    from fastpm_tpu.benchlib import make_step_fn, example_particles
    from fastpm_tpu.mesh import PM as JPM
    x0, v0 = example_particles(16, 64.0, seed=2, jitter=0.4)
    step = make_step_fn(JPM(32, 64.0), donate=False)
    coeffs = jnp.asarray(COEFFS, dtype=jnp.float32)
    x, v = x0, v0
    for _ in range(NSTEP):
        x, v, _a = step(x, v, coeffs)
    return np.asarray(x0), np.asarray(v0), _lexsorted(x, v)


@pytest.mark.parametrize("variant", ["base", "sort_block", "paint4",
                                     "order_preserving", "stale3"])
def test_step_trajectory_matches_jax(jax_trajectory, variant):
    x0, v0, (jx, jv) = jax_trajectory
    pm = PM(32, 64.0)
    x, v = benchlib.example_particles(16, 64.0, seed=2, jitter=0.4,
                                      device="cpu")
    # both packages draw the same particles
    np.testing.assert_array_equal(x.numpy(), x0)
    np.testing.assert_array_equal(v.numpy(), v0)
    if variant == "stale3":
        fresh, stale = benchlib.make_stale_step_fns(pm, device="cpu")
        steps = [fresh if i % 3 == 0 else stale for i in range(NSTEP)]
    else:
        kw = {"base": {}, "sort_block": dict(sort_block=256),
              "paint4": dict(paint8=False),
              "order_preserving": dict(carry_sorted=False)}[variant]
        steps = [benchlib.make_step_fn(pm, device="cpu", **kw)] * NSTEP
    coeffs = torch.tensor(COEFFS)
    for step in steps:
        x, v, acc = step(x, v, coeffs)
    assert acc.shape == x.shape == v.shape == (16 ** 3, 3)
    gx, gv = _lexsorted(x.numpy(), v.numpy())
    np.testing.assert_allclose(gx, jx, atol=5e-5)
    np.testing.assert_allclose(gv, jv, atol=5e-5)


def test_stale_force_exact_after_a_long_drift():
    from fastpm_tpu import gravity as jgravity
    from fastpm_tpu.mesh import PM as JPM
    from fastpm_tpu.painter import Painter as JPainter
    from fastpm_tpu.store import lattice_store as jlattice_store
    nc, box = 16, 64.0
    rng = np.random.default_rng(7)
    q = jlattice_store(JPM(nc, box), columns=("v", "acc", "id"), M0=2.5,
                       name="cdm")
    x = (np.asarray(q.x) + rng.normal(0, 1.5, (nc ** 3, 3))) % box
    pm, painter = PM(2 * nc, box), Painter(PM(2 * nc, box), "cic")
    store = store_from_numpy(x, np.zeros_like(x), np.asarray(q.id),
                             device="cpu", M0=2.5, name="cdm")
    carried, _ = gravity.compute_force_carry(pm, painter, store)
    # every particle drifts up to 5 cells of the force mesh per axis
    cell = box / (2 * nc)
    drifted = carried.replace(x=carried.x + torch.from_numpy(
        rng.uniform(-5, 5, (nc ** 3, 3)).astype(np.float32)) * cell)
    drifted = drifted.wrap(pm.BoxSize)
    got, dk = gravity.compute_force_stale(pm, painter, drifted)
    # rows stay in their given order
    assert torch.equal(got.id, drifted.id)
    assert torch.equal(got.x, drifted.x)

    ids = drifted.id.numpy()
    jstore = q.replace(x=np.asarray(drifted.x.numpy()[np.argsort(ids)]))
    jpm = JPM(2 * nc, box)
    (want,), jdk = jgravity.compute_force(jpm, JPainter(jpm, "cic"),
                                          [jstore])
    acc = got.acc.numpy()[np.argsort(ids)]
    want = np.asarray(want.acc)
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(acc, want, atol=5e-5)
    np.testing.assert_allclose(dk.numpy(), np.asarray(jdk), rtol=1e-5,
                               atol=1e-5 * float(np.abs(jdk).max()))


def test_solver_stale_every_matches_jax():
    from fastpm_tpu import ic as jic
    from fastpm_tpu.cosmology import Cosmology as JCosmology
    from fastpm_tpu.powerspectrum import FuncK as JFuncK
    from fastpm_tpu.solver import Solver as JSolver, SolverConfig as JConfig
    kw = dict(nc=16, boxsize=128.0,
              time_step=list(np.linspace(0.1, 1.0, NSTEP)),
              force_mode="fastpm", pm_nc_factor=2, lpt_nc_factor=1)
    jc = JCosmology(**COSMO)
    js = JSolver(JConfig(stale_every=0, **kw), jc)
    dk, _ = jic.linear_field(js.lptpm, jc, JFuncK.from_file(POWERSPEC),
                             seed=100, aout=1.0)
    js.setup_lpt(dk, 0.1)
    js.evolve()

    s = Solver(SolverConfig(stale_every=3, **kw), Cosmology(**COSMO),
               device="cpu")
    s.setup_lpt(field_from_numpy(np.asarray(dk), "cpu"), 0.1)
    s.evolve()
    # forces 1 and 4 fresh, 2, 3 and 5 stale
    assert s.force_paths == {"carry": 2, "stale": 3}

    jp, p = js.species["cdm"], s.species["cdm"]
    jo, o = np.argsort(np.asarray(jp.id)), torch.argsort(p.id)
    np.testing.assert_array_equal(p.id[o].numpy(), np.asarray(jp.id)[jo])
    dx = p.x[o].numpy() - np.asarray(jp.x)[jo]
    dx -= np.round(dx / 128.0) * 128.0
    np.testing.assert_allclose(dx, 0, atol=1e-4)
    np.testing.assert_allclose(p.v[o].numpy(), np.asarray(jp.v)[jo],
                               atol=1e-4)
    # new particles drop the carried order: the next force, which would
    # be stale, is fresh
    s.add_species("cdm", s.species["cdm"])
    s.evolve([1.0, 1.1])
    assert s.force_paths == {"carry": 3, "stale": 4}
