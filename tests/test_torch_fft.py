"""The PM's FFTs (ops/fft.py) and the scales the force folds into the
passes it makes anyway (gravity.py).

On the CPU: the unnormalised r2c and c2r against numpy.fft; PM.r2c and
PM.c2r still unitary, and PM.c2r keeping what it is not given; the
force's delta_k with the scales folded (K1 deposits 1 / N a particle,
the multi-species canvas is divided by the total mass, each transform
unnormalised) against the old convention's (the canvas over the mean
mass per cell, then PM.r2c), to float32 rounding.

On the card (skipped without one; no JAX needed: `python -m pytest
--noconftest tests/test_torch_fft.py -m cuda`): the plans against
torch.fft at 64^3 and (32, 48, 64), r2c keeping its input; one plan per
shape and direction for two PMs; c2r taking its input with no copy,
its work area counted by torch.cuda.max_memory_allocated; PM.c2r and
the force keeping the caller's delta_k; a strided field and a strided
k through the plans, a strided k given to fft.c2r copied and counted,
and a field of another dtype or shape refused.
"""

import numpy as np
import pytest
import torch

from fastpm_torch import gravity
from fastpm_torch.mesh import PM
from fastpm_torch.ops import cic, fft
from fastpm_torch.painter import Painter
from fastpm_torch.store import Store

SHAPES = [(16, 16, 16), (8, 12, 16)]


def _field(shape, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(device)


def _close(got, want, rel=1e-5):
    """Equal to float32 rounding: within rel of want's largest value."""
    got = np.asarray(got.cpu() if torch.is_tensor(got) else got)
    want = np.asarray(want.cpu() if torch.is_tensor(want) else want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("shape", SHAPES, ids=["cube", "box"])
def test_raw_transforms_against_numpy(shape):
    x = _field(shape)
    k = fft.r2c(x)
    want = np.fft.rfftn(x.numpy().astype(np.float64))
    assert k.dtype == torch.complex64 and k.is_contiguous()
    _close(k, want)
    # c2r is the unnormalised inverse: Norm times numpy's
    y = fft.c2r(torch.from_numpy(want.astype(np.complex64)), shape)
    assert y.dtype == torch.float32 and tuple(y.shape) == shape
    _close(y, np.fft.irfftn(want, s=shape, axes=(0, 1, 2))
           * np.prod(shape))


@pytest.mark.parametrize("shape", SHAPES, ids=["cube", "box"])
def test_pm_transforms_unitary(shape):
    pm = PM(shape, 32.0)
    x = _field(shape, seed=1)
    k = pm.r2c(x)
    _close(k, np.fft.rfftn(x.numpy().astype(np.float64)) / pm.Norm)
    kept = k.clone()
    y = pm.c2r(k)
    assert torch.equal(k, kept)         # not donated: intact
    _close(y, x)
    assert torch.equal(pm.c2r(k, donate=True), y)


def test_dense_copies_strided_and_refuses_others():
    """The step before a plan: a contiguous field as it is, a strided
    one copied into (x, y, z) order and counted, another dtype or shape
    refused."""
    x = _field((8, 12, 16))
    before = fft.stats["copies"]
    assert fft._dense(x, torch.float32, (8, 12, 16)) is x
    y = fft._dense(x.transpose(0, 1).contiguous().transpose(0, 1),
                   torch.float32, (8, 12, 16))
    assert y.is_contiguous() and torch.equal(y, x)
    assert fft.stats["copies"] == before + 1
    for t, dtype, shape in ((x.double(), torch.float32, (8, 12, 16)),
                            (x, torch.float32, (8, 12, 9)),
                            (x[0], torch.float32, (12, 16))):
        with pytest.raises(ValueError, match="FFT plans take"):
            fft._dense(t, dtype, shape)
    assert fft.stats["copies"] == before + 1


def _store(pm, n, seed, mass=None):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(0, pm.BoxSize[0], (n, 3)).astype(
        np.float32))
    return Store(x=x, v=torch.zeros_like(x), mass=mass, M0=0.37)


def _old_delta_k(pm, painter, stores):
    """The old convention: mass per cell over the mean mass per cell,
    then PM.r2c's 1 / Norm."""
    canvas, total = None, 0.0
    for p in stores:
        if p.mass is not None:
            total += float(p.mass.double().sum())
            canvas = painter.paint(p.x, p.mass, canvas)
        else:
            total += p.M0 * p.np_local
            canvas = painter.paint(p.x, float(np.float32(p.M0)), canvas)
    return pm.r2c(canvas / (total / pm.Norm))


@pytest.mark.parametrize("n", [16, 32])
def test_folded_scales(n):
    """The carry force's delta_k (K1 at 1 / N a particle) and
    paint_delta_k's (two species, one with a mass column) against the
    old convention's."""
    pm = PM(n, 2.0 * n)
    painter = Painter(pm, "cic")
    p = _store(pm, n ** 3 // 4, seed=n)
    _, dk = gravity.compute_force_carry(pm, painter, p.replace())
    _close(dk, _old_delta_k(pm, painter, [p]))
    assert dk.dtype == torch.complex64
    rng = np.random.default_rng(n + 1)
    q = _store(pm, n ** 3 // 8, seed=n + 2, mass=torch.from_numpy(
        rng.uniform(0.5, 1.5, n ** 3 // 8).astype(np.float32)))
    _close(gravity.paint_delta_k(pm, painter, [p, q]),
           _old_delta_k(pm, painter, [p, q]))


# ---- on the card ----

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 64, 64), (32, 48, 64)],
                         ids=["cube", "box"])
def test_plans_against_torch_fft(shape):
    dev = _cuda()
    x = _field(shape, seed=2, device=dev)
    kept = x.clone()
    before = dict(fft.stats)
    k = fft.r2c(x)
    assert torch.equal(x, kept)
    want = torch.fft.rfftn(x)
    assert k.is_contiguous() and k.dtype == torch.complex64
    _close(k, want)
    _close(fft.c2r(k, shape), torch.fft.irfftn(want, s=shape,
                                               norm="forward"))
    torch.cuda.synchronize()
    assert fft.stats["execs"] == before["execs"] + 2
    assert fft.stats["copies"] == before["copies"]


@pytest.mark.cuda
def test_one_plan_per_shape():
    """Two PMs of one shape share the process's plans."""
    dev = _cuda()
    shape = (16, 20, 24)
    before = fft.stats["plans_made"]
    for box in (30.0, 60.0):
        pm = PM(shape, box, device=dev)
        pm.c2r(pm.r2c(_field(shape, device=dev)), donate=True)
    assert fft.stats["plans_made"] == before + 2


@pytest.mark.cuda
def test_c2r_takes_its_input_and_counts_its_work():
    """fft.c2r allocates its output and its work area and nothing more
    (no copy of its input), and the work area shows in
    torch.cuda.max_memory_allocated; PM.c2r keeps what it is not
    given."""
    dev = _cuda()
    pm = PM(64, 64.0, device=dev)
    k = pm.r2c(_field(pm.Nmesh, seed=3, device=dev))
    kept = k.clone()
    want = pm.c2r(k)
    assert torch.equal(k, kept)
    work = fft.work_bytes(pm.Nmesh, "c2r", dev)
    out_bytes = int(np.prod(pm.Nmesh)) * 4
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    got = fft.c2r(k, pm.Nmesh)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated(dev) - base
    assert work > 0
    # the allocator rounds each block up to 512 bytes
    assert out_bytes + work <= rise <= out_bytes + work + 1024
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_force_keeps_delta_k_on_cuda():
    """_force_fields hands each gradient to c2r and keeps delta_k."""
    dev = _cuda()
    pm = PM(64, 128.0, device=dev)
    dk = pm.r2c(_field(pm.Nmesh, seed=4, device=dev))
    kept = dk.clone()
    got_dk, fields = gravity._force_fields(pm, dk, "1_4", "none")
    torch.cuda.synchronize()
    assert got_dk is dk and torch.equal(dk, kept)
    assert all(torch.isfinite(f).all() for f in fields)


@pytest.mark.cuda
def test_strided_input_through_the_plan():
    """A strided field given to fft.r2c and a strided k (torch.fft's
    r2c layout) given to fft.c2r are copied into (x, y, z) order and
    counted; PM.c2r's own copy of a k it keeps is laid out so, and is
    not counted. Each goes through a plan, to float32 rounding."""
    dev = _cuda()
    shape = (32, 32, 48)
    x = _field(shape, seed=5, device=dev).transpose(0, 1)
    before = dict(fft.stats)
    _close(fft.r2c(x), torch.fft.rfftn(x))
    assert fft.stats["copies"] == before["copies"] + 1
    pm = PM(shape, 64.0, device=dev)
    k = torch.fft.rfftn(x.contiguous()) / pm.Norm
    assert not k.is_contiguous()
    _close(pm.c2r(k), x)
    assert fft.stats["copies"] == before["copies"] + 1
    _close(fft.c2r(k.clone(), shape), x)
    assert fft.stats["copies"] == before["copies"] + 2
    assert fft.stats["execs"] == before["execs"] + 3


@pytest.mark.cuda
def test_plans_refuse_other_fields():
    """A field the plans cannot take is an error, not a slower path."""
    dev = _cuda()
    with pytest.raises(ValueError, match="FFT plans take"):
        fft.r2c(torch.zeros((8, 8, 8), dtype=torch.float64, device=dev))
    with pytest.raises(ValueError, match="FFT plans take"):
        fft.c2r(torch.zeros((8, 8, 4), dtype=torch.complex64, device=dev),
                (8, 8, 8))


@pytest.mark.cuda
def test_carry_force_on_cuda():
    """The carry force on the card: its delta_k against the old
    convention's, its K1 painting 1 / N a particle."""
    dev = _cuda()
    pm = PM(32, 64.0, device=dev)
    painter = Painter(pm, "cic")
    p = _store(PM(32, 64.0), 32 ** 3 // 4, seed=6)
    p = p.replace(x=p.x.to(dev), v=p.v.to(dev))
    sorted_p = p.take(cic.sort_by_cell(p.x, pm.Nmesh, pm.InvCellSize))
    _, dk = gravity.compute_force_carry(pm, painter, p)
    _close(dk, _old_delta_k(pm, painter, [sorted_p]))
