"""The IC + 2LPT goldens through the port (the reference's
run-test-lightcone.check values, as tests/test_ic_lpt.py pins them for
the JAX package), and lpt_solve against the JAX function."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fastpm_torch.mesh import PM
from fastpm_torch.powerspectrum import FuncK, sigma_tophat
from fastpm_torch.cosmology import Cosmology
from fastpm_torch.store import lattice_store
from fastpm_torch.lpt import lpt_solve
from fastpm_torch import ic

POWERSPEC = os.path.join(os.path.dirname(__file__), "fixtures",
                         "powerspec.txt")


@pytest.fixture(scope="module")
def lightcone_setup():
    """tests/lightcone.lua: nc=64, box=512, seed=100,
    remove_cosmic_variance, growth LCDM."""
    pm = PM(64, 512.0)
    c = Cosmology(h=0.6774, Omega_m=0.307494, T_cmb=0.0, growth_mode="lcdm")
    pk = FuncK.from_file(POWERSPEC)
    dk, var = ic.linear_field(pm, c, pk, seed=100, aout=1.0,
                              remove_cosmic_variance=True)
    return pm, dk, var


def test_sigma8_golden():
    # run-test-nbodykit.check pins 'sigma8 0.815897'
    assert "%f" % sigma_tophat(FuncK.from_file(POWERSPEC), 8.0) \
        == "0.815897"


def test_white_noise_variance_golden(lightcone_setup):
    pm, dk, var = lightcone_setup
    assert dk.dtype == torch.complex64
    # run-test-lightcone.check:3
    assert "%.8f" % var == "0.99999619"


def test_2lpt_displacement_std_golden(lightcone_setup):
    pm, dk, var = lightcone_setup
    q = lattice_store(pm, columns=("id",)).x
    dx1, dx2 = lpt_solve(pm, dk, q, "1_4")
    s1 = dx1.double().numpy()
    std1 = np.sqrt((s1 ** 2).mean(0) - s1.mean(0) ** 2)
    # run-test-lightcone.check:4
    assert ["%.6g" % s for s in std1] == ["5.36177"] * 3
    s2 = dx2.double().numpy()
    std2 = np.sqrt((s2 ** 2).mean(0) - s2.mean(0) ** 2)
    # run-test-lightcone.check:5 (phase-sensitive)
    assert ["%.6g" % s for s in std2] == ["0.455678", "0.44748", "0.453293"]


def test_lpt_solve_matches_jax():
    """32^3: the same delta_k and lattice through both lpt_solve; the
    displacements agree to f32 rounding of ~10 FFTs."""
    from fastpm_tpu.mesh import PM as JPM
    from fastpm_tpu.lpt import lpt_solve as jlpt_solve
    from fastpm_tpu.powerspectrum import FuncK as JFuncK
    from fastpm_tpu import ic as jic
    from fastpm_tpu.cosmology import Cosmology as JCosmology
    from fastpm_tpu.store import lattice_store as jlattice_store

    jpm = JPM(32, 128.0)
    c = JCosmology(h=0.6774, Omega_m=0.307494, T_cmb=0.0,
                   growth_mode="lcdm")
    jdk, _ = jic.linear_field(jpm, c, JFuncK.from_file(POWERSPEC), seed=42,
                              aout=1.0)
    q = np.asarray(jlattice_store(jpm, columns=("id",)).x)
    want = jlpt_solve(jpm, jdk, jnp.asarray(q), "1_4")

    from fastpm_torch.convert import field_from_numpy
    pm = PM(32, 128.0)
    got = lpt_solve(pm, field_from_numpy(np.asarray(jdk), "cpu"),
                    torch.from_numpy(q), "1_4")
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())
