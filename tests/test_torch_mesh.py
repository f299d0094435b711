"""The port's mesh, Fourier transfers, kernel zoo and softening against
the JAX package on random 16^3-32^3 fields, to rtol 1e-5 (with an atol
of 1e-5 of the field's largest value: the two FFT libraries round
differently near zero)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fastpm_tpu.mesh import PM as JPM
from fastpm_tpu import transfers as jtransfers, kernels as jkernels
from fastpm_tpu.powerspectrum import measure_power as jmeasure_power

from fastpm_torch.mesh import PM
from fastpm_torch import transfers, kernels
from fastpm_torch.powerspectrum import measure_power


def _close(got, want, rtol=1e-5):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _field(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.fixture(scope="module", params=[(16, 32.0), (32, 64.0)],
                ids=["16", "32"])
def meshes(request):
    nc, box = request.param
    pm, jpm = PM(nc, box), JPM(nc, box)
    x = _field(pm.rshape, nc)
    return pm, jpm, x, pm.r2c(torch.from_numpy(x)), jpm.r2c(jnp.asarray(x))


def test_r2c_c2r(meshes):
    pm, jpm, x, dk, jdk = meshes
    _close(dk, jdk)
    _close(pm.c2r(dk), jpm.c2r(jdk))
    # round trip and the 1/Norm convention (the DC mode is the mean)
    _close(pm.c2r(dk), x, rtol=1e-4)
    assert complex(dk[0, 0, 0]).real == pytest.approx(float(x.mean()),
                                                      abs=1e-6)


@pytest.mark.parametrize("gradorder", [0, 1])
def test_c2r_grad3(meshes, gradorder):
    pm, jpm, x, dk, jdk = meshes
    pot = transfers.apply_pot(pm, dk, 0)
    jpot = jtransfers.apply_pot(jpm, jdk, 0)
    for got, want in zip(pm.c2r_grad3(pot, gradorder),
                         jpm.c2r_grad3(jpot, gradorder)):
        _close(got, want)


@pytest.mark.parametrize("name,args", [
    ("apply_decic", ()), ("apply_laplace", (0,)), ("apply_laplace", (1,)),
    ("apply_laplace", (2,)), ("apply_pot", (1,)), ("apply_diff", (0, 0)),
    ("apply_diff", (1, 1)), ("apply_diff", (2, 0)), ("apply_grad", (2, 1)),
    ("apply_smoothing", (3.0,)), ("apply_lowpass", (1.0,)),
    ("apply_c2r_weight", ()), ("apply_normalize", ())])
def test_transfers(meshes, name, args):
    pm, jpm, x, dk, jdk = meshes
    _close(getattr(transfers, name)(pm, dk, *args),
           getattr(jtransfers, name)(jpm, jdk, *args))


@pytest.mark.parametrize("kernel", sorted(jkernels.KERNELS))
def test_kernel_transfer(meshes, kernel):
    pm, jpm, x, dk, jdk = meshes
    for field, memb in (("potential", 0), ("acc", 1), ("density", 0)):
        _close(kernels.apply_kernel_transfer(pm, dk, kernel, field, memb),
               jkernels.apply_kernel_transfer(jpm, jdk, kernel, field,
                                              memb))


@pytest.mark.parametrize("softening", ["none", "twothird", "gaussian",
                                       "gadget_long_range", "gaussian36"])
def test_softening(meshes, softening):
    pm, jpm, x, dk, jdk = meshes
    _close(kernels.apply_softening(pm, dk, softening),
           jkernels.apply_softening(jpm, jdk, softening))


def test_set_get_mode(meshes):
    pm, jpm, x, dk, jdk = meshes
    for mode, value, method in (((1, 2, 3, 0), 2.5, "override"),
                                ((1, 2, 3, 1), -1.0, "add"),
                                ((0, 0, 0, 0), 1.0, "override"),
                                ((pm.Nmesh[0] - 1, 0, pm.Nmesh[2] // 2, 1),
                                 0.5, "override")):
        got = transfers.set_mode(pm, dk, mode, value, method)
        want = jtransfers.set_mode(jpm, jdk, mode, value, method)
        _close(got, want)
        assert transfers.get_mode(pm, got, mode) == pytest.approx(
            jtransfers.get_mode(jpm, want, mode), rel=1e-6)


def test_variance_and_power(meshes):
    pm, jpm, x, dk, jdk = meshes
    assert pm.compute_variance(dk) == pytest.approx(
        jpm.compute_variance(jdk), rel=1e-6)
    got, want = measure_power(pm, dk), jmeasure_power(jpm, jdk)
    np.testing.assert_array_equal(got.Nmodes, want.Nmodes)
    # the JAX binning sums in float32, the port's in float64
    np.testing.assert_allclose(got.k, want.k, rtol=1e-5)
    np.testing.assert_allclose(got.p, want.p, rtol=1e-5)
