"""The port's Painter against the JAX package's scatter/gather Painter
for all four kernel types: paint (scalar and per-particle mass), readout,
and the gradient readout along one axis. Both sum in float32 in another
order, hence rtol 1e-5 with atol 2e-6 as in tests/test_pallas_paint.py
(scaled by the largest value for the gradient readouts, whose corner
terms cancel)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fastpm_tpu.mesh import PM as JPM
from fastpm_tpu.painter import Painter as JPainter

from fastpm_torch.mesh import PM
from fastpm_torch.painter import Painter

NC, BOX, N = 16, 32.0, 3000
TYPES = [("cic", 2), ("linear", 2), ("quad", 3), ("lanczos", 4)]


def _inputs():
    rng = np.random.default_rng(5)
    pos = rng.uniform(0, BOX, (N, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, N).astype(np.float32)
    field = rng.standard_normal((NC,) * 3).astype(np.float32)
    return pos, mass, field


def _painters(type, support, diffdir=-1):
    return (Painter(PM(NC, BOX), type, support, diffdir),
            JPainter(JPM(NC, BOX), type, support, diffdir, backend="never"))


@pytest.mark.parametrize("type,support", TYPES)
def test_paint_matches_jax(type, support):
    pos, mass, _ = _inputs()
    painter, jpainter = _painters(type, support)
    for m, jm in ((1.0, 1.0), (torch.from_numpy(mass), jnp.asarray(mass))):
        got = painter.paint(torch.from_numpy(pos), m).numpy()
        want = np.asarray(jpainter.paint(jnp.asarray(pos), jm))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("type,support", TYPES)
def test_readout_matches_jax(type, support):
    pos, _, field = _inputs()
    painter, jpainter = _painters(type, support)
    got = painter.readout(torch.from_numpy(field),
                          torch.from_numpy(pos)).numpy()
    want = np.asarray(jpainter.readout(jnp.asarray(field), jnp.asarray(pos)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-6)
    got3 = painter.readout3(*[torch.from_numpy(field)] * 3,
                            torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got3, np.stack([want] * 3, axis=-1),
                               rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("type,support", TYPES)
def test_gradient_readout_matches_jax(type, support):
    pos, _, field = _inputs()
    for diffdir in range(3):
        painter, jpainter = _painters(type, support, diffdir)
        got = painter.readout(torch.from_numpy(field),
                              torch.from_numpy(pos)).numpy()
        want = np.asarray(jpainter.readout(jnp.asarray(field),
                                           jnp.asarray(pos)))
        # the lanczos derivative cos(x)/x - sin(x)/x^2 cancels near its
        # zeros, which amplifies the last-ulp differences between the two
        # libraries' float32 sin and cos
        scale = 5e-5 if type == "lanczos" else 2e-6
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=scale * np.abs(want).max())
