"""The PGD correction (fastpm_torch/pgd.py) against the JAX package's.

- alpha(a) = alpha0 10^(A a^2 - B a) equal to the JAX value.
- compute_with_alpha at 32^3: a linear delta_k and 4096 numpy-seeded
  positions; the three components (one K2 call of three fields on the
  CPU's plain version) against the JAX per-component readouts within
  1e-5 of their largest value (float32 FFTs of two libraries).
- The cola + PGD + wCDM ladder of tests/test_pgd.py at 16^3 on a 32^3
  mesh, 4 steps, both packages started from one delta_k: positions by
  id within 1e-4 of a cell, pgdc within 1e-3 of its largest value (the
  last force's float32 differences, scaled by alpha), and the run
  without PGD moved elsewhere, as the JAX test checks.
"""

import os

import numpy as np
import pytest
import torch

from fastpm_torch.convert import field_from_numpy
from fastpm_torch.cosmology import Cosmology
from fastpm_torch.mesh import PM
from fastpm_torch.pgd import PGDCorrection
from fastpm_torch.solver import Solver, SolverConfig

POWERSPEC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "fixtures", "powerspec.txt")
PARAMS = dict(alpha0=0.8, A=4.0, B=8.0, kl=2.0, ks=10.0)


def test_alpha_matches_jax():
    from fastpm_tpu.pgd import PGDCorrection as JPGD
    for a in (0.2, 0.5, 0.77, 1.0):
        assert PGDCorrection(**PARAMS).alpha(a) == JPGD(**PARAMS).alpha(a)


@pytest.mark.parametrize("kl,ks", [(2.0, 10.0), (0.3, 5.0)])
def test_compute_with_alpha_matches_jax(kl, ks):
    import jax.numpy as jnp
    from fastpm_tpu.cosmology import Cosmology as JCosmology
    from fastpm_tpu.mesh import PM as JPM
    from fastpm_tpu.pgd import PGDCorrection as JPGD
    from fastpm_tpu.powerspectrum import FuncK as JFuncK
    from fastpm_tpu import ic as jic
    nm, box = 32, 64.0
    jpm = JPM(nm, box)
    dk, _ = jic.linear_field(jpm, JCosmology(h=0.6774, Omega_m=0.307494),
                             JFuncK.from_file(POWERSPEC), seed=11, aout=1.0)
    pos = np.random.RandomState(4).uniform(0, box, (4096, 3)).astype(
        np.float32)
    kw = dict(PARAMS, kl=kl, ks=ks)
    alpha = JPGD(**kw).alpha(0.6)
    want = np.asarray(JPGD(**kw).compute_with_alpha(
        jpm, jnp.asarray(pos), dk, jnp.float32(alpha)))
    got = PGDCorrection(**kw).compute_with_alpha(
        PM(nm, box), torch.from_numpy(pos),
        field_from_numpy(np.asarray(dk), "cpu"), alpha)
    assert got.shape == (4096, 3) and got.dtype == torch.float32
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def _ladder(pgdc):
    return dict(nc=16, boxsize=64.0,
                time_step=list(np.linspace(0.2, 1.0, 4)),
                force_mode="cola", pm_nc_factor=2, pgdc=pgdc,
                pgdc_alpha0=0.8, pgdc_A=4.0, pgdc_B=8.0, pgdc_kl=2.0,
                pgdc_ks=10.0)


WCDM = dict(h=0.6711, Omega_m=0.3175, w0=-1.1, wa=0.1, growth_mode="ode",
            T_cmb=0.0)


def _by_id(p):
    ids = np.asarray(p.id).astype(np.int64)
    o = np.argsort(ids)
    return ids[o], np.asarray(p.x)[o], np.asarray(p.pgdc)[o]


def test_cola_pgd_wcdm_ladder_matches_jax():
    from fastpm_tpu.cosmology import Cosmology as JCosmology
    from fastpm_tpu.powerspectrum import FuncK as JFuncK
    from fastpm_tpu import ic as jic
    from fastpm_tpu.solver import Solver as JSolver, SolverConfig as JConfig
    jc = JCosmology(**WCDM)
    js = JSolver(JConfig(need_rand=False, **_ladder(True)), jc)
    dk, _ = jic.linear_field(js.lptpm, jc, JFuncK.from_file(POWERSPEC),
                             seed=21, aout=1.0)
    js.setup_lpt(dk, 0.2)
    js.evolve()

    def run(pgdc):
        s = Solver(SolverConfig(**_ladder(pgdc)), Cosmology(**WCDM),
                   device="cpu")
        s.setup_lpt(field_from_numpy(np.asarray(dk), "cpu"), 0.2)
        s.evolve()
        return s.species["cdm"]

    p = run(True)
    assert p.a_x == 1.0 and p.dx1 is not None and p.dx2 is not None
    jid, jx, jpg = _by_id(js.species["cdm"])
    tid, tx, tpg = _by_id(p)
    np.testing.assert_array_equal(tid, jid)
    cell = 64.0 / 16
    dx = tx - jx
    dx -= np.round(dx / 64.0) * 64.0
    assert np.abs(dx).max() < 1e-4 * cell
    assert np.abs(jpg).max() > 0
    np.testing.assert_allclose(tpg, jpg, rtol=0,
                               atol=1e-3 * np.abs(jpg).max())
    # the drift consumed pgdc: a run without PGD ends elsewhere
    q = run(False)
    d0 = np.abs(tx - q.x.numpy()[np.argsort(q.id.numpy())])
    assert np.minimum(d0, 64.0 - d0).max() > 1e-5
