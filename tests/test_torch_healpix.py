"""The port's HEALPix pixelization (fastpm_torch/healpix.py) against the
JAX package's: the host float64 RING and NEST pixels equal; the float32
device pixels equal to the host's or flagged (the safety property of
the hybrid painter: every float32-vs-float64 mismatch is recomputed on
the host); the shell maps equal in ids and counts to the JAX device
painter's, the float32 radial-momentum sums within rtol 2e-5 (another
summation order)."""

import numpy as np
import pytest
import torch

from fastpm_torch import healpix as th


def _cloud(n, seed, scale=150.0):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((n, 3)) * scale).astype(np.float32)


@pytest.mark.parametrize("nside", [1, 8, 32, 256])
def test_host_pixels_match_jax(nside):
    from fastpm_tpu import healpix as jh
    pos = _cloud(20000, nside).astype(np.float64)
    np.testing.assert_array_equal(th.vec2pix_nest(nside, pos),
                                  jh.vec2pix_nest(nside, pos))
    np.testing.assert_array_equal(th.vec2pix_ring(nside, pos),
                                  jh.vec2pix_ring(nside, pos))
    rng = np.random.RandomState(nside + 1)
    theta = np.arccos(rng.uniform(-1, 1, 5000))
    phi = rng.uniform(0, 2 * np.pi, 5000)
    np.testing.assert_array_equal(th.ang2pix_nest(nside, theta, phi),
                                  jh.ang2pix_nest(nside, theta, phi))
    np.testing.assert_array_equal(th.ang2pix_ring(nside, theta, phi),
                                  jh.ang2pix_ring(nside, theta, phi))
    assert th.nside2npix(nside) == jh.nside2npix(nside)


@pytest.mark.parametrize("nside", [8, 32, 256])
def test_device_pixels_match_host_or_flagged(nside):
    import jax.numpy as jnp
    from fastpm_tpu.healpix import vec2pix_nest_jax
    pos = _cloud(200000, 3)
    want = th.vec2pix_nest(nside, pos.astype(np.float64))
    got, risky = th.vec2pix_nest_device(nside, torch.from_numpy(pos))
    got, risky = got.numpy().astype(np.int64), risky.numpy()
    assert not np.any((got != want) & ~risky), np.flatnonzero(
        (got != want) & ~risky)[:5]
    assert risky.mean() < 0.02
    # the same float32 chain as the JAX device path
    jgot, jrisky = vec2pix_nest_jax(nside, jnp.asarray(pos))
    np.testing.assert_array_equal(got, np.asarray(jgot))
    np.testing.assert_array_equal(risky, np.asarray(jrisky))


def test_paint_hpmap_nest_device_matches_jax():
    import jax.numpy as jnp
    from fastpm_tpu.healpix import (paint_hpmap_nest,
                                    paint_hpmap_nest_device)
    rng = np.random.RandomState(11)
    n = 60000
    pos = (rng.standard_normal((n, 3)) * 120).astype(np.float32)
    aemit = rng.uniform(0.05, 1.0, n).astype(np.float32)
    aemit[:3] = 1.0               # aemit = 1 opens an extra slice
    v = rng.standard_normal((n, 3)).astype(np.float32)
    M0, nside, nslices = 2.5, 32, 16
    ids_j, mass_j, rmom_j, amid_j = paint_hpmap_nest_device(
        jnp.asarray(pos), jnp.asarray(aemit), jnp.asarray(v), n, M0,
        nside, nslices)
    ids, mass, rmom, amid = th.paint_hpmap_nest_device(
        torch.from_numpy(pos), torch.from_numpy(aemit), torch.from_numpy(v),
        M0, nside, nslices)
    assert th.paint_hpmap_nest_device.flagged > 0
    np.testing.assert_array_equal(ids, ids_j)
    np.testing.assert_array_equal(mass, mass_j)
    np.testing.assert_allclose(rmom, rmom_j, rtol=2e-5, atol=1e-4)
    np.testing.assert_array_equal(amid, amid_j)
    # and the port's own host painter
    ids_h, mass_h, rmom_h, amid_h = th.paint_hpmap_nest(
        pos, aemit, v, M0, nside, nslices)
    np.testing.assert_array_equal(ids, ids_h)
    np.testing.assert_array_equal(mass, mass_h)
    np.testing.assert_allclose(rmom, rmom_h, rtol=2e-5, atol=1e-4)
    assert ids.max() // th.nside2npix(nside) == nslices


def test_paint_hpmap_ring_matches_jax():
    from fastpm_tpu.healpix import paint_hpmap
    pos = _cloud(5000, 5)
    aemit = np.random.RandomState(6).uniform(0.1, 1.0, 5000)
    for a, b in zip(th.paint_hpmap(pos, aemit, 8, 10),
                    paint_hpmap(pos, aemit, 8, 10)):
        np.testing.assert_array_equal(a, b)
