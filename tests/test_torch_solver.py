"""The port's Solver against the JAX Solver on the CPU: 32^3 particles
on a 64^3 force mesh (B2), 3 steps, fastpm and pm modes, both started
from one JAX state carried across by fastpm_torch.convert: the IC
delta_k (each solver runs its own 2LPT), or the particle store after the
JAX 2LPT. After a sort by id, positions agree to 1e-4 of a cell and
velocities to 1e-4 of their rms (f32 summation order in paint, FFT and
readout is all that differs)."""

import os

import numpy as np
import pytest

from fastpm_tpu.powerspectrum import FuncK as JFuncK
from fastpm_tpu.cosmology import Cosmology as JCosmology
from fastpm_tpu import ic as jic
from fastpm_tpu.solver import Solver as JSolver, SolverConfig as JConfig

from fastpm_torch.solver import Solver, SolverConfig
from fastpm_torch.cosmology import Cosmology
from fastpm_torch.convert import field_from_numpy, store_from_numpy

POWERSPEC = os.path.join(os.path.dirname(__file__), "fixtures",
                         "powerspec.txt")
NC, BOX = 32, 128.0
COSMO = dict(h=0.6774, Omega_m=0.307494, T_cmb=0.0, growth_mode="lcdm")


def _by_id(ids, *cols):
    o = np.argsort(ids)
    return [c[o] for c in cols]


@pytest.mark.parametrize("start", ["delta_k", "store"])
@pytest.mark.parametrize("mode", ["fastpm", "pm"])
def test_solver_matches_jax(mode, start):
    kw = dict(nc=NC, boxsize=BOX, time_step=[0.1, 0.4, 0.7, 1.0],
              force_mode=mode, pm_nc_factor=2)
    jc = JCosmology(**COSMO)
    js = JSolver(JConfig(**kw), jc)
    dk, _ = jic.linear_field(js.lptpm, jc, JFuncK.from_file(POWERSPEC),
                             seed=100, aout=1.0)
    js.setup_lpt(dk, 0.1)

    s = Solver(SolverConfig(check_values=True, **kw), Cosmology(**COSMO),
               device="cpu")
    if start == "delta_k":
        s.setup_lpt(field_from_numpy(np.asarray(dk), "cpu"), 0.1)
    else:
        q = js.species["cdm"]
        s.add_species("cdm", store_from_numpy(
            np.asarray(q.x), np.asarray(q.v), np.asarray(q.id), q.a_x,
            q.a_v, device="cpu", M0=q.M0, q_shift=q.q_shift,
            q_scale=q.q_scale, q_nc=q.q_nc, name=q.name))
        s.species["cdm"] = s.species["cdm"].replace(
            acc=s.species["cdm"].x * 0)
    js.evolve()
    s.evolve()

    jp, p = js.species["cdm"], s.species["cdm"]
    assert p.a_x == jp.a_x == 1.0 and p.a_v == jp.a_v == 1.0
    jx, jv = _by_id(np.asarray(jp.id), np.asarray(jp.x), np.asarray(jp.v))
    x, v = _by_id(p.id.numpy(), p.x.numpy(), p.v.numpy())
    dx = x - jx
    dx -= np.round(dx / BOX) * BOX
    assert np.abs(dx).max() < 1e-4 * BOX / NC
    assert np.abs(v - jv).max() < 1e-4 * jv.std()


def test_unserved_modes_raise():
    # rehome is served (tests/test_torch_ranks_physics.py), with no
    # environment default; every force mode and PGD are served
    assert SolverConfig(nc=8, boxsize=16.0, rehome=True).rehome
    assert not SolverConfig(nc=8, boxsize=16.0).rehome
    with pytest.raises(ValueError, match="force_mode"):
        SolverConfig(nc=8, boxsize=16.0, force_mode="tpm")
    for kw in (dict(force_mode="cola"), dict(force_mode="2lpt"),
               dict(force_mode="za"), dict(pgdc=True)):
        SolverConfig(nc=8, boxsize=16.0, **kw)


def test_compute_force_potential_tidal_matches_jax():
    """gravity.compute_force with the potential and the tidal tensor
    against the JAX compute_force: 32^3 particles displaced from the
    lattice on a 32^3 mesh. acc, potential and the six tidal components
    agree to 1e-4 of each column's rms (float32 paint sums and FFTs in
    another order); the potential and tidal readouts go through K4's
    plain version in the cell order."""
    import jax.numpy as jnp
    from fastpm_tpu.gravity import compute_force as jforce
    from fastpm_tpu.mesh import PM as JPM
    from fastpm_tpu.painter import Painter as JPainter
    from fastpm_tpu.store import Store as JStore
    from fastpm_torch.gravity import compute_force, carry_eligible
    from fastpm_torch.mesh import PM
    from fastpm_torch.painter import Painter
    rng = np.random.default_rng(3)
    q = (np.stack(np.meshgrid(*[np.arange(NC)] * 3, indexing="ij"), -1)
         .reshape(-1, 3) + 0.5) * (BOX / NC)
    x = ((q + rng.normal(0, 2.0, q.shape)) % BOX).astype(np.float32)
    n = len(x)
    jst = JStore(x=jnp.asarray(x), v=jnp.zeros((n, 3), jnp.float32),
                 acc=jnp.zeros((n, 3), jnp.float32),
                 potential=jnp.zeros(n, jnp.float32),
                 tidal=jnp.zeros((n, 6), jnp.float32), M0=1.0)
    jpm = JPM(NC, BOX)
    (jp,), _ = jforce(jpm, JPainter(jpm, "cic", backend="never"), [jst],
                      compute_potential=True, compute_tidal=True)
    pm = PM(NC, BOX, device="cpu")
    painter = Painter(pm, "cic")
    st = store_from_numpy(x, np.zeros_like(x), M0=1.0,
                          potential=np.zeros(n), tidal=np.zeros((n, 6)))
    assert not carry_eligible(painter, [st], True, False)
    (p,), _ = compute_force(pm, painter, [st], compute_potential=True,
                            compute_tidal=True)
    for name in ("acc", "potential", "tidal"):
        want = np.asarray(getattr(jp, name)).reshape(n, -1)
        got = getattr(p, name).numpy().reshape(n, -1)
        assert got.shape == want.shape
        for c in range(want.shape[1]):
            np.testing.assert_allclose(got[:, c], want[:, c], rtol=0,
                                       atol=1e-4 * want[:, c].std(),
                                       err_msg="%s[%d]" % (name, c))
